"""Example: in-context tabular embeddings + downstream evaluation.

The TPU package's example scores the embeddings with sklearn's linear SVM
(`quick_eval_from_saved`, host-only here); this one scores them with a
least-squares linear classifier in numpy, so it also runs where sklearn is
absent (the card's machine).

Run:  python -m multimodal_ad_tpu_torch.examples.tabular_embeddings [--device cpu]
"""

import os
import tempfile

import numpy as np

from ..data.synthetic import make_table
from ..tabular import ICLClassifier, ICLConfig, pretrain_icl
from ..tabular.pipeline import read_embeddings, tabel_encoder_multi
from . import device_arg


def linear_accuracy(train_csv: str, test_csv: str) -> float:
    """Test accuracy of a standardized least-squares one-vs-rest linear
    classifier fitted on the train embeddings."""
    y_tr, X_tr = read_embeddings(train_csv)
    y_te, X_te = read_embeddings(test_csv)
    mu, sd = X_tr.mean(0), X_tr.std(0) + 1e-8
    classes = np.unique(y_tr)
    A = np.c_[(X_tr - mu) / sd, np.ones(len(X_tr))]
    W = np.linalg.lstsq(A, (y_tr[:, None] == classes[None]).astype(np.float64),
                        rcond=None)[0]
    pred = classes[np.argmax(np.c_[(X_te - mu) / sd, np.ones(len(X_te))] @ W, axis=1)]
    return float(np.mean(pred == y_te))


def main(device="cuda"):
    root = tempfile.mkdtemp(prefix="tab_example_")
    table_csv = make_table(n=120, classes=("CN", "AD"), seed=0,
                           path=os.path.join(root, "clinical.csv"))

    cfg = ICLConfig(d_model=32, n_heads=2, n_layers=2, d_ff=64,
                    max_features=32, max_classes=4, max_context=128)
    params, _ = pretrain_icl(cfg, steps=200, batch=16, n_ctx=48, n_qry=16, device=device)
    clf = ICLClassifier(params=params, cfg=cfg, device=device)

    tr, te = tabel_encoder_multi(
        table_csv, label_col="Group", classes=["CN", "AD"], n_fold=3,
        test_size=0.3, train_out=os.path.join(root, "train_emb.csv"),
        test_out=os.path.join(root, "test_emb.csv"), embedder=clf)
    acc = linear_accuracy(tr, te)
    print("downstream linear accuracy:", round(acc, 4))
    return acc


if __name__ == "__main__":
    main(device_arg(__doc__))
