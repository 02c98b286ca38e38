"""Tabular embedding pipelines (own copy of the TPU package's
tabular/pipeline.py; the reference's tabel_test.py).

- `tabel_encoder`: binary task; the output CSVs' label column is the
  integer class;
- `tabel_encoder_multi`: any class list; the label column keeps the
  ORIGINAL string labels;
- `quick_eval_from_saved` (StandardScaler + linear SVM accuracy) and
  `embedding_downstream_eval` (LogisticRegression ACC + ROC-AUC) are
  host-only: they import sklearn inside, and the card's machine has none.

Output CSV schema: first column 'label', then embedding dims named 0..d-1,
written as pandas' ``to_csv(index=False)`` writes them. The table is read
with `data/tabular.py` (csv module, pandas' type inference) and split with
`estimator.train_test_split`; no pandas anywhere.
"""

from __future__ import annotations

import csv

import numpy as np

from ..data.tabular import (category_codes, is_text, isin, load_adni_data_binary,
                            read_table, write_table)
from .embedding import OoFEmbedding
from .estimator import train_test_split


def _default_embedder(**kw):
    # the shipped embedding path is the diversity ensemble; pass embedder=
    # to the encoders for a single-model or custom path
    from .embedding import EnsembleICLEmbedder
    return EnsembleICLEmbedder(**kw)


def write_embeddings(path: str, labels, emb) -> str:
    """'label', 0, .., d-1 columns, as pandas writes a float32 frame."""
    emb = np.asarray(emb)
    columns = {"label": np.asarray(labels)}
    columns.update((str(j), emb[:, j]) for j in range(emb.shape[1]))
    return write_table(path, columns)


def tabel_encoder(csv_path: str, start_col: int = 14, class0: str = "AD",
                  class1: str = "CN", n_fold: int = 5, test_size: float = 0.3,
                  random_state: int = 42,
                  train_out: str = "train_embeddings.csv",
                  test_out: str = "test_embeddings.csv", embedder=None,
                  device: str = "cuda"):
    X, y = load_adni_data_binary(csv_path, start_col=start_col,
                                 class0=class0, class1=class1)
    X_tr, X_te, y_tr, y_te = train_test_split(
        X, y, test_size=test_size, random_state=random_state)

    embed = OoFEmbedding(embedder or _default_embedder(device=device), n_fold=n_fold)
    train_emb = embed.get_embeddings(X_tr, y_tr, X_te, data_source="train")[0]
    test_emb = embed.get_embeddings(X_tr, y_tr, X_te, data_source="test")[0]
    write_embeddings(train_out, y_tr, train_emb)
    write_embeddings(test_out, y_te, test_emb)
    return train_out, test_out


def tabel_encoder_multi(csv_path: str, start_col: int = 14,
                        label_col: str = "GROUP",
                        classes: list | None = None, n_fold: int = 5,
                        test_size: float = 0.3, random_state: int = 42,
                        train_out: str = "train_embeddings.csv",
                        test_out: str = "test_embeddings.csv", embedder=None,
                        device: str = "cuda"):
    """`device` places the default embedder; a given `embedder` keeps its
    own."""
    classes = classes or ["CN", "AD"]
    names, columns = read_table(csv_path, str_columns=(label_col,))
    labels = columns[label_col]
    keep = isin(labels, classes)
    if not keep.any():
        raise ValueError(f"no rows with {label_col} in {classes} in {csv_path}")
    # integer-encode text columns (over the kept rows)
    feature_cols = [c for c in names[start_col:] if c != label_col]
    X = np.empty((int(keep.sum()), len(feature_cols)), np.float32)
    for j, c in enumerate(feature_cols):
        col = columns[c][keep]
        X[:, j] = category_codes(col) if is_text(col) else col
    y_str = labels[keep]
    label_to_index = {label: idx for idx, label in enumerate(classes)}
    y_num = np.array([label_to_index[v] for v in y_str], np.int64)

    X_tr, X_te, y_tr_num, y_te_num, y_tr_str, y_te_str = train_test_split(
        X, y_num, y_str, test_size=test_size, random_state=random_state,
        stratify=y_num)

    embed = OoFEmbedding(embedder or _default_embedder(device=device), n_fold=n_fold)
    train_emb = embed.get_embeddings(X_tr, y_tr_num, X_te, data_source="train")[0]
    test_emb = embed.get_embeddings(X_tr, y_tr_num, X_te, data_source="test")[0]
    write_embeddings(train_out, y_tr_str, train_emb)
    write_embeddings(test_out, y_te_str, test_emb)
    return train_out, test_out


def read_embeddings(path: str):
    """(labels, X float64) of an embeddings CSV; labels are ints when every
    label reads as one (pandas' inference), else the strings."""
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.reader(f))[1:]
    labels = [r[0] for r in rows]
    try:
        y = np.array([int(v) for v in labels], np.int64)
    except ValueError:
        y = np.array(labels, dtype=object)
    X = np.array([[float(v) if v else np.nan for v in r[1:]] for r in rows], np.float64)
    return y, X


def quick_eval_from_saved(train_csv: str = "train_embeddings.csv",
                          test_csv: str = "test_embeddings.csv") -> float:
    """StandardScaler + linear SVC accuracy on saved embeddings. Host-only:
    needs sklearn."""
    from sklearn.metrics import accuracy_score
    from sklearn.pipeline import make_pipeline
    from sklearn.preprocessing import StandardScaler
    from sklearn.svm import SVC

    y_tr, X_tr = read_embeddings(train_csv)
    y_te, X_te = read_embeddings(test_csv)
    clf = make_pipeline(StandardScaler(), SVC(kernel="linear"))
    clf.fit(X_tr, y_tr)
    acc = accuracy_score(y_te, clf.predict(X_te))
    print(f"[quick eval - SVM-linear] Accuracy on {test_csv}: {acc:.4f}")
    return float(acc)


def embedding_downstream_eval(train_csv: str, test_csv: str) -> dict:
    """LogisticRegression over saved embeddings with ACC + ROC-AUC.
    Host-only: needs sklearn."""
    from sklearn.linear_model import LogisticRegression
    from sklearn.metrics import accuracy_score, roc_auc_score

    y_tr, X_tr = read_embeddings(train_csv)
    y_te, X_te = read_embeddings(test_csv)
    clf = LogisticRegression(max_iter=1000)
    clf.fit(X_tr, y_tr)
    proba = clf.predict_proba(X_te)
    acc = accuracy_score(y_te, clf.predict(X_te))
    try:
        if proba.shape[1] == 2:
            auc = roc_auc_score(y_te, proba[:, 1])
        else:
            auc = roc_auc_score(y_te, proba, multi_class="ovr")
    except ValueError:
        auc = float("nan")
    return {"ACC": float(acc), "AUC": float(auc)}
