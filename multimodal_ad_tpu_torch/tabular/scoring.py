"""Scoring of the tabular meta-estimators (own copy of the TPU package's
tabular/scoring.py), in numpy: the card's machine has no sklearn.

Each metric computes what sklearn 1.9 computes for it, in the same dtype:

- ROC-AUC: binary from `train/metrics.py::binary_auc` (tied scores count
  one half, the positive class the greater label); 2-D scores the macro
  one-vs-rest mean over the sorted classes of `y_true`, which needs one
  column a class and rows that sum to 1;
- `log_loss`: probabilities clipped to [eps, 1 - eps] of their float dtype
  (not renormalised: sklearn 1.9 only warns when a row does not sum to 1);
- accuracy, balanced accuracy (the mean recall of the classes in
  `y_true`) and macro F1 (over the labels of `y_true` and the prediction);
- RMSE, MSE, MAE and R² (1 for a perfect fit of a constant target, 0 for
  any other fit of one).

Degenerate inputs give NaN where the TPU package's do: rows with a NaN
score are dropped, and one class left, or an input sklearn refuses, gives
a NaN AUC.
"""

from __future__ import annotations

import warnings

import numpy as np

from ..train.metrics import binary_auc


def _roc_auc(y_true, y_score) -> float:
    """sklearn's `roc_auc_score` (one-vs-rest, macro, for 2-D scores);
    ValueError where it raises one."""
    classes = np.unique(y_true)
    if y_score.ndim == 1:
        if len(classes) != 2:
            raise ValueError("1-D scores need a binary y_true")
        if not np.isfinite(y_score).all():
            raise ValueError("Input contains infinity")
        return binary_auc(y_true, y_score)
    if y_score.shape[1] != len(classes):
        raise ValueError(f"{len(classes)} classes in y_true, {y_score.shape[1]} "
                         "columns in y_score")
    if not np.allclose(1, y_score.sum(axis=1)):
        raise ValueError("Target scores need to be probabilities for multiclass "
                         "roc_auc, i.e. they should sum up to 1.0 over classes")
    if not np.isfinite(y_score).all():
        raise ValueError("Input contains infinity")
    return float(np.mean([binary_auc(y_true == c, y_score[:, i])
                          for i, c in enumerate(classes)]))


def safe_roc_auc_score(y_true, y_score) -> float:
    """ROC-AUC that returns nan instead of raising on degenerate inputs
    (single class present, NaNs in scores)."""
    y_true = np.asarray(y_true)
    y_score = np.asarray(y_score)
    valid = ~(np.isnan(y_score).reshape(len(y_score), -1).any(axis=1))
    y_true, y_score = y_true[valid], y_score[valid]
    if len(np.unique(y_true)) < 2 or len(y_true) == 0:
        return float("nan")
    if y_score.ndim == 2 and y_score.shape[1] == 2:
        y_score = y_score[:, 1]
    try:
        return float(_roc_auc(y_true, y_score))
    except ValueError:
        return float("nan")


def log_loss(y_true, y_proba) -> float:
    """sklearn 1.9's `log_loss`: the mean negative log-probability of the
    true class, probabilities clipped to [eps, 1 - eps] of their dtype; a
    1-D input is the positive class's probability."""
    y_proba = np.asarray(y_proba)
    if y_proba.dtype not in (np.float64, np.float32, np.float16):
        y_proba = y_proba.astype(np.float64)
    if not np.isfinite(y_proba).all():
        raise ValueError("Input y_proba contains NaN or infinity.")
    if y_proba.max() > 1:
        raise ValueError(f"y_prob contains values greater than 1: {y_proba.max()}")
    if y_proba.min() < 0:
        raise ValueError(f"y_prob contains values lower than 0: {y_proba.min()}")
    y_true = np.asarray(y_true)
    if len(y_true) != len(y_proba):
        raise ValueError(f"Found input variables with inconsistent numbers of "
                         f"samples: [{len(y_proba)}, {len(y_true)}]")
    classes, y_idx = np.unique(y_true, return_inverse=True)
    if len(classes) == 1:
        raise ValueError(f"y_true contains only one label ({classes[0]}). Please "
                         "provide the list of all expected class labels explicitly "
                         "through the labels argument.")
    onehot = np.zeros((len(y_true), len(classes)), dtype=y_proba.dtype)
    onehot[np.arange(len(y_true)), y_idx.ravel()] = 1
    if y_proba.ndim == 1:
        y_proba = y_proba[:, None]
    if y_proba.shape[1] == 1:
        y_proba = np.concatenate([1 - y_proba, y_proba], axis=1)
    eps = np.finfo(y_proba.dtype).eps
    if not np.allclose(y_proba.sum(axis=1), 1, rtol=np.sqrt(eps), atol=0):
        warnings.warn("The y_prob values do not sum to one. Make sure to pass "
                      "probabilities.", UserWarning)
    if len(classes) != y_proba.shape[1]:
        raise ValueError(f"y_true and y_prob contain different number of classes: "
                         f"{len(classes)} vs {y_proba.shape[1]}.")
    y_proba = np.clip(y_proba, eps, 1 - eps)
    xlogy = np.where(onehot == 0, 0, onehot * np.log(y_proba))
    return float(np.average(-np.sum(xlogy, axis=1)))


def _confusion(y_true, y_pred):
    """(labels, matrix) over the sorted union of the labels, rows true."""
    labels = np.unique(np.concatenate([np.unique(y_true), np.unique(y_pred)]))
    t = np.searchsorted(labels, y_true)
    p = np.searchsorted(labels, y_pred)
    cm = np.zeros((len(labels), len(labels)), np.int64)
    np.add.at(cm, (t, p), 1)
    return labels, cm


def balanced_accuracy(y_true, y_pred) -> float:
    """The mean recall over the classes present in `y_true`."""
    _, cm = _confusion(np.asarray(y_true), np.asarray(y_pred))
    with np.errstate(divide="ignore", invalid="ignore"):
        per_class = np.diag(cm) / cm.sum(axis=1)
    if np.any(np.isnan(per_class)):
        warnings.warn("y_pred contains classes not in y_true", UserWarning)
        per_class = per_class[~np.isnan(per_class)]
    return float(np.mean(per_class))


def macro_f1(y_true, y_pred) -> float:
    """F1 of each label of `y_true` and `y_pred`, averaged (0 where a
    label's F1 is 0 / 0)."""
    _, cm = _confusion(np.asarray(y_true), np.asarray(y_pred))
    tp = np.diag(cm).astype(np.float64)
    denom = cm.sum(axis=1) + cm.sum(axis=0)  # true + predicted counts
    f = np.where(denom == 0, 0.0, 2 * tp / np.where(denom == 0, 1, denom))
    return float(np.average(f))


def score_classification(metric: str, y_true, y_pred_or_proba) -> float:
    """metric in {'accuracy', 'roc_auc', 'f1', 'log_loss', 'balanced_accuracy'}.
    Probabilistic metrics expect probabilities; label metrics accept either
    (argmax applied to 2-D input)."""
    y = np.asarray(y_pred_or_proba)
    if metric == "roc_auc":
        return safe_roc_auc_score(y_true, y)
    if metric == "log_loss":
        return log_loss(y_true, y)
    labels = np.argmax(y, axis=1) if y.ndim == 2 else y
    if metric == "accuracy":
        return float(np.average(np.asarray(y_true) == labels))
    if metric == "balanced_accuracy":
        return balanced_accuracy(y_true, labels)
    if metric == "f1":
        return macro_f1(y_true, labels)
    raise ValueError(f"unknown classification metric {metric}")


def _reg_targets(y_true, y_pred):
    """Both as (n, 1) columns of their common float dtype (float64 when
    neither is floating), as sklearn's regression metrics take them."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    floats = [a.dtype for a in (y_true, y_pred) if a.dtype.kind == "f"]
    dtype = np.result_type(*floats) if floats else np.float64
    if len(y_true) != len(y_pred):
        raise ValueError(f"Found input variables with inconsistent numbers of "
                         f"samples: [{len(y_true)}, {len(y_pred)}]")
    return y_true.astype(dtype).reshape(len(y_true), -1), \
        y_pred.astype(dtype).reshape(len(y_pred), -1)


def score_regression(metric: str, y_true, y_pred) -> float:
    if metric not in ("rmse", "mse", "mae", "r2"):
        raise ValueError(f"unknown regression metric {metric}")
    t, p = _reg_targets(y_true, y_pred)
    if metric in ("rmse", "mse"):
        mse = float(np.average(np.average((t - p) ** 2, axis=0)))
        return float(np.sqrt(mse)) if metric == "rmse" else mse
    if metric == "mae":
        return float(np.average(np.average(np.abs(p - t), axis=0)))
    if len(p) < 2:
        warnings.warn("R^2 score is not well-defined with less than two samples.")
        return float("nan")
    num = np.sum((t - p) ** 2, axis=0)
    den = np.sum((t - np.average(t, axis=0)) ** 2, axis=0)
    scores = np.ones(t.shape[1], dtype=t.dtype)
    valid = (den != 0) & (num != 0)
    scores[valid] = 1 - num[valid] / den[valid]
    scores[(num != 0) & (den == 0)] = 0.0
    return float(np.average(scores))


def concordance_index(event_times, predicted_scores, event_observed=None
                      ) -> float:
    """Harrell's c-index: the share of admissible pairs whose predicted
    scores order as their event times do, prediction ties counting 0.5
    (a higher score means a longer survival). Under right-censoring the
    earlier time of an admissible pair is an observed event; equal times
    are admissible only between an event and a censored subject."""
    t = np.asarray(event_times, np.float64)
    p = np.asarray(predicted_scores, np.float64)
    e = (np.ones(len(t), bool) if event_observed is None
         else np.asarray(event_observed).astype(bool))
    if len(t) != len(p) or len(t) != len(e):
        raise ValueError("event_times/predicted_scores/event_observed "
                         "lengths differ")
    num = den = 0.0
    for i in range(len(t)):
        if not e[i]:
            continue
        # subjects strictly later than an observed event at t[i], plus
        # censored subjects tied at t[i]
        later = (t > t[i]) | ((t == t[i]) & ~e)
        later[i] = False
        den += later.sum()
        num += (p[i] < p[later]).sum() + 0.5 * (p[i] == p[later]).sum()
    return float(num / den) if den else float("nan")


def score_survival(optimize_metric: str, y_true, y_pred,
                   event_observed=None) -> float:
    """The c-index between true event times and predicted scores under
    right-censoring; `event_observed` 1 = event, 0 = censored."""
    if optimize_metric in ("cindex", "c_index", "risk_score",
                           "risk_score_capped"):
        return concordance_index(y_true, y_pred, event_observed)
    raise ValueError(f"unknown survival metric {optimize_metric}")
