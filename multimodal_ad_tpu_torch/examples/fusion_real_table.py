"""Fusion demo on the reference's REAL clinical table.

The fusion path end to end on the reference's own clinical data:

- clinical branch: the REAL `ADNI_Tabel.csv` of the reference checkout
  (``$MAD_REFERENCE_DIR``), all its CN/AD subjects, features from column
  14, embedded per CV fold by the in-context tabular learner
  (tabular/icl.py) as `cli.train_fusion --use-table --table
  ADNI_Tabel.csv` wires it;
- imaging branch: synthetic volumes for those same subjects with a
  deliberately WEAK image signal (heavy extent jitter), so the image-only
  model cannot saturate and the table branch has headroom to prove itself;
- the proof: the fused model's held-out test AUC must beat the image-only
  twin trained with the same budget.

Falls back to a synthetic clinical table (data/synthetic.py::make_table)
when the reference checkout is absent, so the example runs everywhere. The
summary is written beside the run's work directory.

Run:  python -m multimodal_ad_tpu_torch.examples.fusion_real_table [--device cpu]
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np

from . import device_arg

#: the reference checkout's clinical table, where ``$MAD_REFERENCE_DIR`` names one
REF_TABLE = os.path.join(os.environ.get("MAD_REFERENCE_DIR", ""), "ADNI_Tabel.csv")
#: cap per class for the SYNTHETIC fallback only; the reference table is
#: used whole
N_PER_CLASS = 40
SHAPE = (16, 20, 16)
SEED = 0


def load_clinical(work: str):
    """(X, y, subjects, source): every reference CN/AD row (CN = 0, AD = 1),
    or the synthetic fallback table."""
    from ..data.tabular import isin, load_adni_table, read_table

    if os.environ.get("MAD_REFERENCE_DIR") and os.path.exists(REF_TABLE):
        X, y, _ = load_adni_table(REF_TABLE, label_col="GROUP", classes=["CN", "AD"],
                                  start_col=14)
        _, columns = read_table(REF_TABLE, str_columns=("GROUP", "PTID"))
        subjects = [str(s) for s in columns["PTID"][isin(columns["GROUP"], ["CN", "AD"])]]
        return X, y, subjects, "reference ADNI_Tabel.csv"

    from ..cli.train_fusion import read_fusion_table
    from ..data.synthetic import make_table

    path = make_table(n=2 * N_PER_CLASS, n_features=24, seed=SEED,
                      path=os.path.join(work, "table.csv"))
    X, y, subjects = read_fusion_table(path)
    return X, y, subjects, "synthetic fallback table"


def write_volumes(root, subjects, y):
    """Per-subject weak-signal volumes + the manifest CSV: extent_jitter 0.8
    against the class gap of 0.8 makes the imaging boundary noisy, so the
    image-only model plateaus below the fused one."""
    from ..data.synthetic import make_volume
    from ..data.tabular import write_table
    from ..utils import nifti

    rng = np.random.default_rng(SEED + 1)
    mri_dir = os.path.join(root, "MRI")
    os.makedirs(mri_dir, exist_ok=True)
    for s, label in zip(subjects, y):
        vol = make_volume(rng, SHAPE, label=int(label), extent_jitter=0.8,
                          center_jitter=0.06, noise=0.4)
        nifti.save(os.path.join(mri_dir, f"{s}.nii"), vol)
    csv_path = write_table(os.path.join(root, "labels.csv"), {
        "Subject_ID": np.array(subjects, dtype=object),
        "Group": np.array(["AD" if v else "CN" for v in y], dtype=object)})
    return csv_path, mri_dir


def main(device="cuda", num_epochs: int = 10):
    from ..core.config import Config
    from ..data.adni import ADNIManifest
    from ..data.splits import stratified_test_split
    from ..train.fusion import test_fusion_models, train_fusion_cv

    work = tempfile.mkdtemp(prefix="fusion_real_table_")
    X, y, subjects, source = load_clinical(work)
    print(f"clinical branch: {source} ({len(y)} subjects, {X.shape[1]} features)")

    csv_path, mri_dir = write_volumes(work, subjects, y)
    records = ADNIManifest(csv_path, mri_dir, "ADCN", verbose=False).data_dict
    table_data = (X, y, subjects)

    model_kw = dict(dim=16, depth=1, heads=2, dim_head=8, mlp_dim=32)
    results = {}
    batch = 16 if len(y) > 100 else 4
    for tag, use_table in (("image-only", False), ("fused", True)):
        cfg = Config(
            label_file=csv_path, mri_dir=mri_dir, task="ADCN",
            num_epochs=num_epochs, batch_size=batch, lr=1e-3, n_splits=2,
            checkpoint_dir=os.path.join(work, f"ckpt_{tag}"),
            compute_dtype="float32", loader_threads=2)
        train_fusion_cv(cfg, use_table=use_table,
                        table_data=table_data if use_table else None,
                        model_kw=model_kw, records=records, device=device, verbose=False)
        tr_val, test_data = stratified_test_split(records, cfg.split_ratio, cfg.seed)
        r = test_fusion_models(
            cfg, test_data, use_table=use_table,
            table_data=table_data if use_table else None, model_kw=model_kw,
            device=device, train_subjects=[rec["Subject"] for rec in tr_val],
            verbose=False)
        results[tag] = r["avg"]
        folds = [round(float(m["AUC"]), 4) for m in r["per_fold"]]
        results[tag]["fold_AUCs"] = folds
        results[tag]["fold_AUC_std"] = round(float(np.std(folds)), 4)
        print(f"{tag}: test AUC {r['avg']['AUC']:.3f} ACC {r['avg']['ACC']:.3f} "
              f"(per-fold AUC {folds}, std {results[tag]['fold_AUC_std']})")

    gain = results["fused"]["AUC"] - results["image-only"]["AUC"]
    print(f"table branch AUC gain: {gain:+.3f}")
    assert results["fused"]["AUC"] > results["image-only"]["AUC"], (
        "clinical branch added no held-out AUC", results)

    out = {"source": source, "n_subjects": int(len(y)),
           "image_only": results["image-only"], "fused": results["fused"],
           "auc_gain": round(float(gain), 4)}
    with open(os.path.join(work, "summary.json"), "w") as f:
        json.dump(out, f, indent=2)
    print("summary written to", os.path.join(work, "summary.json"))
    return out


if __name__ == "__main__":
    main(device_arg(__doc__))
