"""Backend utilities of the tabular stack (own copy of the TPU package's
tabular/utils.py): device resolution, estimator detection, categorical-
feature inference, a numerically safe softmax, grid expansion."""

from __future__ import annotations

import itertools

import numpy as np


def get_device(device: str = "cuda"):
    """The torch device to run on: ``"cuda"`` by default (raising when no
    card is present), ``"cpu"`` on request. ``"auto"`` means ``"cuda"``:
    the port never falls back to the host quietly."""
    from ..core.device import resolve_device

    return resolve_device("cuda" if device == "auto" else device)


def is_icl_estimator(est) -> bool:
    """True for the in-context estimators."""
    from .icl import ICLClassifier
    from .regression import ICLRegressor

    return isinstance(est, (ICLClassifier, ICLRegressor))


def infer_categorical_features(X, max_unique: int = 10) -> list[int]:
    """Column indices that look categorical: few unique values, all
    integral."""
    X = np.asarray(X)
    out = []
    for j in range(X.shape[1]):
        col = X[:, j]
        col = col[~np.isnan(col.astype(np.float64))]
        u = np.unique(col)
        if len(u) <= max_unique and np.allclose(u, np.round(u.astype(np.float64))):
            out.append(j)
    return out


def softmax(x, axis: int = -1) -> np.ndarray:
    x = np.asarray(x, np.float64)
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def product_dict(**kwargs):
    """Cartesian product of keyword lists as dicts."""
    keys = list(kwargs)
    for combo in itertools.product(*kwargs.values()):
        yield dict(zip(keys, combo))
