"""Cross-validation significance testing (port of the TPU package's
eval/stats.py): a paired t-test and a Wilcoxon signed-rank test over two
models' per-fold metric vectors (reference utils/p-value.py:13-43).

scipy is imported inside `compute_p_values`, so the package imports
without it.
"""

from __future__ import annotations

import numpy as np


def compute_p_values(a, b) -> dict:
    """{'t_stat', 't_p', 'wilcoxon_stat', 'wilcoxon_p'} for paired per-fold
    metrics `a` against `b`. All-zero differences, which scipy's wilcoxon
    refuses, give W = 0 and p = 1."""
    from scipy import stats

    a = np.asarray(a, float)
    b = np.asarray(b, float)
    if a.shape != b.shape:
        raise ValueError("paired vectors must have equal length")
    t_stat, t_p = stats.ttest_rel(a, b)
    try:
        w_stat, w_p = stats.wilcoxon(a, b)
    except ValueError:  # all-zero differences
        w_stat, w_p = 0.0, 1.0
    return {"t_stat": float(t_stat), "t_p": float(t_p),
            "wilcoxon_stat": float(w_stat), "wilcoxon_p": float(w_p)}
