#!/usr/bin/env python3
"""Full-size learning proof of the port's training path on one NVIDIA GPU.

Runs the recipe of the TPU package's benchmarks/learning_proof_tpu.py
unchanged, through the port: 80 seeded synthetic subjects (40 AD, 40 CN)
at 91x109x91, the flagship ResNet-18 (shortcut B, bf16 autocast over fp32
parameters), 20 epochs, 2 folds, batch 8, lr 1e-3, the resident corpus
with device augmentation and precise-BN, the `adaptive_normal`
normalizer; then the same assertions: the train loss falls in every fold,
the final validation AUC is at least 0.9 in every fold, the fold-ensemble
test AUC at least 0.85 and ACC at least 0.7. Then its int8 half: the
trained best_fold{k} are served by EnsemblePredictor, quantized with four
training volumes (`quantize_int8`), and `evaluate_records` must give a
held-out test AUC within 0.01 of the bf16 ensemble's (`int8_parity`).

    python3 scripts/learning_proof_cuda.py [--out DIR]

Prints the card's name and power limit, the wall seconds and the test
metrics, and a JSON summary as its last line (also written to
DIR/summary.json with cv_results.csv when --out is given). Needs a card.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=None, help="directory for summary.json and cv_results.csv")
    args = p.parse_args(argv)

    import torch

    from multimodal_ad_tpu_torch.core.config import Config
    from multimodal_ad_tpu_torch.data.adni import ADNIManifest
    from multimodal_ad_tpu_torch.data.pipeline import load_volume
    from multimodal_ad_tpu_torch.data.splits import stratified_test_split
    from multimodal_ad_tpu_torch.data.synthetic import make_adni_dir
    from multimodal_ad_tpu_torch.serve import EnsemblePredictor, evaluate_records
    from multimodal_ad_tpu_torch.train.cv import train_cv

    if not torch.cuda.is_available():
        print("learning_proof_cuda: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    work = tempfile.mkdtemp(prefix="learning_proof_cuda_")
    try:
        csv_path, mri_dir = make_adni_dir(
            work, n_per_class=40, classes=("AD", "CN"), shape=(91, 109, 91),
            seed=11, extent_jitter=0.3, center_jitter=0.04, noise=0.25)
        cfg = Config(
            label_file=csv_path, mri_dir=mri_dir, task="ADCN",
            num_epochs=20, batch_size=8, lr=1e-3, n_splits=2, model_depth=18,
            checkpoint_dir=os.path.join(work, "ckpt"),
            hbm_cache=True, augment=True, precise_bn=True,
            normalizer="adaptive_normal")
        t0 = time.time()
        results, ckpt_dir = train_cv(cfg, verbose=True, device="cuda")
        wall = time.time() - t0

        with open(os.path.join(ckpt_dir, "cv_results.csv")) as f:
            rows = list(csv.reader(f))

        # the int8 half: quantize the trained fold ensemble, held-out AUC kept
        records = ADNIManifest(cfg.label_file, cfg.mri_dir, cfg.task, verbose=False).data_dict
        tr_val, test_data = stratified_test_split(records, cfg.split_ratio, cfg.seed)
        pred = EnsemblePredictor.from_checkpoint_dir(ckpt_dir, device="cuda")
        fp = evaluate_records(pred, test_data)
        t1 = time.time()
        pred.quantize_int8(np.stack([load_volume(r["MRI"]) for r in tr_val[:4]]))
        calib_s = time.time() - t1
        q8 = evaluate_records(pred, test_data)
        print(f"int8 parity: bf16 {fp} int8 {q8} (calibration {calib_s:.2f} s)", flush=True)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            shutil.copy(os.path.join(ckpt_dir, "cv_results.csv"),
                        os.path.join(args.out, "cv_results.csv"))
    finally:
        shutil.rmtree(work, ignore_errors=True)

    summary = {"card": card, "wall_seconds": wall, "test_avg": results["avg"],
               "test_std": results["std"], "volume_shape": [91, 109, 91],
               "model_depth": 18, "config": "scripts/learning_proof_cuda.py",
               "data_path": "hbm_cache + device-side augmentation + precise_bn",
               "int8_parity": {"bf16": fp, "int8": q8, "calibration_s": calib_s,
                               "assertion": "|int8 AUC - bf16 AUC| <= 0.01 on the trained "
                                            "fold ensemble"}}
    if args.out:
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
    print(f"test ACC {results['avg']['ACC']:.4f} AUC {results['avg']['AUC']:.4f} "
          f"MCC {results['avg']['MCC']:.4f}; {wall:.1f} s on {card}", flush=True)
    print(json.dumps(summary), flush=True)

    # the learning criteria of tests/test_learning.py::check_learning
    hdr = rows[0]
    il, ia = hdr.index("tr_loss"), hdr.index("vl_auc")
    by_fold: dict = {}
    for r in rows[1:]:
        by_fold.setdefault(r[0], []).append(r)
    for fold, frows in by_fold.items():
        first_loss = float(frows[0][il])
        last3 = float(np.mean([float(r[il]) for r in frows[-3:]]))
        assert last3 < first_loss, (
            f"fold {fold}: train loss did not decrease ({first_loss:.3f} -> {last3:.3f})")
        final_val_auc = float(frows[-1][ia])
        assert final_val_auc >= 0.9, f"fold {fold}: final val AUC {final_val_auc:.3f} < 0.9"
    assert results["avg"]["AUC"] >= 0.85, results["avg"]
    assert results["avg"]["ACC"] >= 0.7, results["avg"]
    assert abs(q8["AUC"] - fp["AUC"]) <= 0.01, (
        f"int8 test AUC {q8['AUC']:.4f} drifted from bf16 {fp['AUC']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
