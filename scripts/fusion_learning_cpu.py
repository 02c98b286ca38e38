"""The JAX package's fusion learning recipe (tests/test_fusion.py::
TestFusionLearning) on the CPU, for the JAX package and for the port under
several initial-weight and dropout seeds.

    JAX_PLATFORMS=cpu python scripts/fusion_learning_cpu.py [--seeds 6] [--skip-jax]

48 subjects with MRI and PET at 16^3 (seed 9, jittered and noisy), a
6-feature table shifted by 1.5 x the label, MultimodalClassifier at dim
16, depth 1, 20 epochs, batch 4, 2 folds, fp32. The recipe's bars: every
fold's best validation score (0.3 AUC + 0.7 ACC) >= 0.8 and the held-out
fold-mean AUC >= 0.85. Prints one line a run: the fold scores and the
AUC. The JAX run uses the test's embedder (sklearn's LogisticRegression
probabilities); the port runs each seed offset with that embedder and with
ICLClassifier() on the bundled asset (the default). A seed offset k adds
1000 k to the port's init and dropout seeds (the split stays seed 42's).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SMALL = dict(dim=16, depth=1, heads=2, dim_head=8, mlp_dim=32)


def make_data(root):
    from multimodal_ad_tpu_torch.data.adni import ADNIManifest
    from multimodal_ad_tpu_torch.data.synthetic import make_adni_dir

    csv_path, mri, pet = make_adni_dir(root, n_per_class=24, classes=("AD", "CN"),
                                       shape=(16, 16, 16), seed=9, pet=True,
                                       extent_jitter=0.3, center_jitter=0.04, noise=0.25)
    recs = ADNIManifest(csv_path, mri, "ADCN", pet_dir=pet, verbose=False).data_dict
    rng = np.random.default_rng(0)
    y = np.asarray([r["label"] for r in recs])
    X = (rng.normal(size=(len(recs), 6)) + 1.5 * y[:, None]).astype(np.float32)
    return csv_path, mri, pet, (X, y, [r["Subject"] for r in recs])


def logreg_embedder():
    from sklearn.linear_model import LogisticRegression

    class LogRegEmbedder(LogisticRegression):
        def get_embeddings(self, X, data_source="test"):
            return self.predict_proba(X)[None]
    return LogRegEmbedder(max_iter=200)


def run_jax(root, table):
    import jax

    from multimodal_ad_tpu.core.config import Config
    from multimodal_ad_tpu.data.adni import ADNIManifest
    from multimodal_ad_tpu.data.splits import stratified_test_split
    from multimodal_ad_tpu.parallel.mesh import make_mesh
    from multimodal_ad_tpu.train import fusion

    csv_path, mri, pet = table[:3]
    recs = ADNIManifest(csv_path, mri, "ADCN", pet_dir=pet, verbose=False).data_dict
    cfg = Config(label_file=csv_path, mri_dir=mri, pet_dir=pet, task="ADCN", num_epochs=20,
                 batch_size=4, lr=1e-3, n_splits=2, checkpoint_dir=os.path.join(root, "jax"),
                 compute_dtype="float32", loader_threads=2)
    n_dev = min(4, len(jax.devices()))
    kw = dict(use_pet=True, use_table=True, table_data=table[3], model_kw=SMALL,
              mesh=make_mesh({"data": n_dev}, devices=jax.devices()[:n_dev]),
              embedder=logreg_embedder(), verbose=False)
    best, _ = fusion.train_fusion_cv(cfg, records=recs, **kw)
    tr_val, test = stratified_test_split(recs, cfg.split_ratio, cfg.seed)
    res = fusion.test_fusion_models(cfg, test, train_subjects=[r["Subject"] for r in tr_val],
                                    **kw)
    return best, res["avg"]["AUC"]


def run_port(root, table, offset, embedder):
    from multimodal_ad_tpu_torch.core.config import Config
    from multimodal_ad_tpu_torch.data.adni import ADNIManifest
    from multimodal_ad_tpu_torch.data.splits import stratified_test_split
    from multimodal_ad_tpu_torch.train import fusion

    csv_path, mri, pet = table[:3]
    recs = ADNIManifest(csv_path, mri, "ADCN", pet_dir=pet, verbose=False).data_dict
    make, state = fusion.make_fusion_model, fusion.create_train_state
    fusion.make_fusion_model = lambda *a, seed=0, **k: make(*a, seed=seed + 1000 * offset, **k)
    fusion.create_train_state = lambda *a, dropout_seed=0, **k: state(
        *a, dropout_seed=dropout_seed + 1000 * offset, **k)
    try:
        cfg = Config(label_file=csv_path, mri_dir=mri, pet_dir=pet, task="ADCN",
                     num_epochs=20, batch_size=4, lr=1e-3, n_splits=2, compute_dtype="float32",
                     checkpoint_dir=os.path.join(root, f"port{offset}"), loader_threads=2)
        kw = dict(use_pet=True, use_table=True, table_data=table[3], model_kw=SMALL,
                  embedder=embedder, device="cpu", verbose=False)
        best, _ = fusion.train_fusion_cv(cfg, records=recs, **kw)
        tr_val, test = stratified_test_split(recs, cfg.split_ratio, cfg.seed)
        res = fusion.test_fusion_models(cfg, test,
                                        train_subjects=[r["Subject"] for r in tr_val], **kw)
    finally:
        fusion.make_fusion_model, fusion.create_train_state = make, state
    return best, res["avg"]["AUC"]


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seeds", type=int, default=6)
    p.add_argument("--skip-jax", action="store_true")
    args = p.parse_args()
    import torch

    from multimodal_ad_tpu_torch.tabular import ICLClassifier

    torch.set_num_threads(4)
    with tempfile.TemporaryDirectory() as root:
        table = make_data(root)

        def show(name, best, auc):
            ok = all(b >= 0.8 for b in best) and auc >= 0.85
            print(f"{name:34s} fold scores {[round(float(b), 4) for b in best]}, "
                  f"held-out AUC {auc:.4f}: {'passes' if ok else 'FAILS'} the bars", flush=True)
        if not args.skip_jax:
            show("JAX package, LogisticRegression", *run_jax(root, table))
        for k in range(args.seeds):
            show(f"port seed +{k}, LogisticRegression", *run_port(root, table, k,
                                                                  logreg_embedder()))
            show(f"port seed +{k}, ICLClassifier()", *run_port(
                root, table, k, ICLClassifier(device="cpu")))


if __name__ == "__main__":
    main()
