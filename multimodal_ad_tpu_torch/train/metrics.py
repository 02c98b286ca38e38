"""7-metric classification evaluation in numpy (port of the TPU package's
train/metrics.py, which calls sklearn; the card's machine has none).

ACC, PRE, SEN, SPE, F1, AUC and MCC plus the confusion matrix, computed as
sklearn computes them:

- PRE, SEN and F1 with zero_division=0 (binary: of class 1; multiclass:
  the macro mean over the classes present in y_true or y_pred);
- SPE = TN / (TN + FP + 1e-8) (multiclass: the macro one-vs-rest mean);
- AUC as the trapezoidal ROC area, which gives tied scores half credit
  (the Mann-Whitney statistic); NaN when y_true holds one class or a score
  is not finite; multiclass: the macro one-vs-rest mean over all classes,
  NaN when a class is absent from y_true or the rows do not sum to 1;
- MCC in sklearn's multiclass form (0 where it is undefined).
"""

from __future__ import annotations

import numpy as np

METRIC_KEYS = ("ACC", "PRE", "SEN", "SPE", "F1", "AUC", "MCC")


def confusion_matrix(y_true, y_pred, labels) -> np.ndarray:
    """(len(labels), len(labels)) counts, rows true, columns predicted;
    samples whose label is outside `labels` are left out."""
    labels = np.asarray(labels)
    pos = {int(v): i for i, v in enumerate(labels)}
    n = len(labels)
    cm = np.zeros((n, n), np.int64)
    for t, p in zip(np.asarray(y_true).tolist(), np.asarray(y_pred).tolist()):
        if t in pos and p in pos:
            cm[pos[t], pos[p]] += 1
    return cm


def _div0(num, den):
    """num / den elementwise, 0 where den is 0 (zero_division=0)."""
    num = np.asarray(num, np.float64)
    den = np.asarray(den, np.float64)
    return np.where(den == 0, 0.0, num / np.where(den == 0, 1.0, den))


def binary_auc(y_true, y_score) -> float:
    """Area under the ROC curve of scores for the positive class 1 (the
    greater of two labels): the share of (positive, negative) pairs ranked
    right, ties counting one half. NaN for one class or a non-finite score."""
    y_true = np.asarray(y_true)
    y_score = np.asarray(y_score, np.float64)
    classes = np.unique(y_true)
    if len(classes) != 2 or not np.isfinite(y_score).all():
        return float("nan")
    pos = y_true == classes[1]
    # 1-based ranks; tied scores share their mean rank
    order = np.argsort(y_score, kind="mergesort")
    _, first, counts = np.unique(y_score[order], return_index=True,
                                 return_counts=True)
    ranks = np.empty(len(y_score), np.float64)
    ranks[order] = np.repeat(first + (counts - 1) / 2.0 + 1.0, counts)
    n_pos = int(pos.sum())
    n_neg = len(y_true) - n_pos
    u = ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def roc_curve(y_true, y_score):
    """(fpr, tpr) at every distinct threshold, from (0, 0) to (1, 1), as
    sklearn's roc_curve without dropping intermediate points."""
    y_true = np.asarray(y_true)
    y_score = np.asarray(y_score, np.float64)
    order = np.argsort(-y_score, kind="mergesort")
    s, t = y_score[order], (y_true[order] == np.max(y_true)).astype(np.float64)
    last = np.r_[np.where(np.diff(s))[0], len(s) - 1]
    tps, fps = np.cumsum(t)[last], (last + 1) - np.cumsum(t)[last]
    tpr = np.r_[0.0, tps / max(tps[-1], 1)]
    fpr = np.r_[0.0, fps / max(fps[-1], 1)]
    return fpr, tpr


def _mcc(cm: np.ndarray) -> float:
    t_sum = cm.sum(axis=1, dtype=np.float64)
    p_sum = cm.sum(axis=0, dtype=np.float64)
    n_correct = np.trace(cm, dtype=np.float64)
    n = p_sum.sum()
    cov_ytyp = n_correct * n - np.dot(t_sum, p_sum)
    cov_ypyp = n ** 2 - np.dot(p_sum, p_sum)
    cov_ytyt = n ** 2 - np.dot(t_sum, t_sum)
    den = cov_ypyp * cov_ytyt
    return 0.0 if den == 0 else float(cov_ytyp / np.sqrt(den))


def calculate_metrics(y_true, y_pred, y_score) -> dict:
    """Binary metrics of labels 0/1; `y_score` is the class-1 probability."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    cm = confusion_matrix(y_true, y_pred, [0, 1])
    tn, fp, fn, tp = cm.ravel()
    return {
        "ACC": float(np.mean(y_true == y_pred)),
        "PRE": float(_div0(tp, tp + fp)),
        "SEN": float(_div0(tp, tp + fn)),
        "SPE": tn / (tn + fp + 1e-8),
        "F1": float(_div0(2 * tp, 2 * tp + fp + fn)),
        "AUC": binary_auc(y_true, y_score),
        "MCC": _mcc(confusion_matrix(y_true, y_pred, np.union1d(y_true, y_pred))),
        "cm": np.array([[tn, fp], [fn, tp]]),
    }


def _macro_specificity(cm: np.ndarray) -> float:
    """Macro one-vs-rest specificity: per class c, TN/(TN+FP) over the
    rest-vs-c binarization, averaged (same +1e-8 guard as the binary SPE)."""
    total = cm.sum()
    col = cm.sum(axis=0)
    row = cm.sum(axis=1)
    tp = np.diag(cm)
    fp = col - tp
    tn = total - row - col + tp
    return float(np.mean(tn / (tn + fp + 1e-8)))


def _macro_ovr_auc(y_true, y_prob, n_cls: int) -> float:
    if y_prob.ndim != 2 or y_prob.shape[1] != n_cls:
        return float("nan")
    if not np.allclose(1, y_prob.sum(axis=1)):
        return float("nan")  # sklearn: scores must be probabilities
    if np.setdiff1d(y_true, np.arange(n_cls)).size:
        return float("nan")
    return float(np.mean([binary_auc(y_true == c, y_prob[:, c])
                          for c in range(n_cls)]))


def calculate_metrics_multiclass(y_true, y_pred, y_prob) -> dict:
    """Macro-averaged variant for the 3/4-class tasks."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    y_prob = np.asarray(y_prob)
    n_cls = y_prob.shape[-1] if y_prob.ndim == 2 else int(
        max(y_true.max(), y_pred.max())) + 1
    cm = confusion_matrix(y_true, y_pred, np.arange(n_cls))
    present = np.union1d(y_true, y_pred)
    cm_p = confusion_matrix(y_true, y_pred, present)
    tp = np.diag(cm_p)
    fp = cm_p.sum(axis=0) - tp
    fn = cm_p.sum(axis=1) - tp
    return {
        "ACC": float(np.mean(y_true == y_pred)),
        "PRE": float(np.mean(_div0(tp, tp + fp))),
        "SEN": float(np.mean(_div0(tp, tp + fn))),
        "SPE": _macro_specificity(cm),
        "F1": float(np.mean(_div0(2 * tp, 2 * tp + fp + fn))),
        "AUC": _macro_ovr_auc(y_true, y_prob, n_cls),
        "MCC": _mcc(cm_p),
        "cm": cm,
    }


def model_selection_score(metrics: dict, weights=(0.3, 0.7)) -> float:
    """Best-checkpoint criterion 0.3*AUC + 0.7*ACC; ACC alone when AUC is
    NaN (a validation fold of one class), so every fold keeps a best
    checkpoint."""
    w_auc, w_acc = weights
    if not np.isfinite(metrics["AUC"]):
        return float(metrics["ACC"])
    return w_auc * metrics["AUC"] + w_acc * metrics["ACC"]
