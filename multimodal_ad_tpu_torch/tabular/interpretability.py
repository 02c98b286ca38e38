"""Interpretability: feature attributions, Shapley interactions, selection
(own copy of the TPU package's tabular/interpretability.py).

- `permutation_importance_values`: the metric drop when a column is
  permuted, repeats averaged;
- `marginal_contribution_values`: per-sample per-feature attribution by
  baseline substitution, f(x) - f(x with feature j at the background mean);
- `shapley_values` / `shapley_interaction_values`: exact (all 2^F
  coalitions, F small) or Monte-Carlo Shapley values and order-2 Shapley
  interaction indices (k-SII, max order 2). A feature is removed by
  substituting the background mean. The coalitions of a sample go through
  `predict_proba` in chunks of 4,096 rows: on the card each chunk is one
  batched forward of the in-context network;
- `feature_selection`: sklearn's SequentialFeatureSelector, host-only.

Every draw comes from ``np.random.default_rng(random_state)`` in the TPU
package's order.
"""

from __future__ import annotations

from math import comb

import numpy as np

from .estimator import host_sklearn
from .scoring import score_classification


def permutation_importance_values(estimator, X, y, metric: str = "roc_auc",
                                  n_repeats: int = 5, random_state: int = 0):
    """(n_features,) mean metric drop when each column is permuted."""
    X = np.asarray(X, np.float32)
    y = np.asarray(y)
    rng = np.random.default_rng(random_state)
    base = score_classification(metric, y, estimator.predict_proba(X))
    drops = np.zeros(X.shape[1])
    for j in range(X.shape[1]):
        vals = []
        for _ in range(n_repeats):
            Xp = X.copy()
            Xp[:, j] = rng.permutation(Xp[:, j])
            vals.append(base - score_classification(
                metric, y, estimator.predict_proba(Xp)))
        drops[j] = np.mean(vals)
    return drops


def marginal_contribution_values(estimator, X, background=None,
                                 class_index: int = 1):
    """(n_samples, n_features) attribution: probability change when feature
    j is replaced by its background mean."""
    X = np.asarray(X, np.float32)
    bg = (np.asarray(background, np.float32).mean(axis=0)
          if background is not None else X.mean(axis=0))
    p_full = estimator.predict_proba(X)[:, class_index]
    out = np.zeros_like(X)
    for j in range(X.shape[1]):
        Xj = X.copy()
        Xj[:, j] = bg[j]
        out[:, j] = p_full - estimator.predict_proba(Xj)[:, class_index]
    return out


def _coalition_values(estimator, x, bg, masks, class_index, chunk=4096):
    """Model value of each coalition: features outside the coalition are
    replaced by the background mean (removal by marginal imputation).
    masks: (M, F) bool -> (M,) probabilities."""
    inp = np.where(masks, x[None], bg[None]).astype(np.float32)
    out = np.empty(len(inp), np.float64)
    for i in range(0, len(inp), chunk):
        out[i:i + chunk] = estimator.predict_proba(
            inp[i:i + chunk])[:, class_index]
    return out


def _all_coalitions(F):
    ints = np.arange(1 << F, dtype=np.int64)
    masks = ((ints[:, None] >> np.arange(F)) & 1).astype(bool)
    return ints, masks


def shapley_values(estimator, X, background=None, class_index: int = 1,
                   n_draws: int = 64, random_state: int = 0,
                   exact_max_features: int = 12):
    """(n_samples, n_features) Shapley values of the positive-class
    probability. Exact for F <= exact_max_features (all 2^F coalitions
    evaluated once); Monte-Carlo permutation sampling otherwise."""
    X = np.asarray(X, np.float32)
    bg = (np.asarray(background, np.float32).mean(axis=0)
          if background is not None else X.mean(axis=0))
    n, F = X.shape
    out = np.zeros((n, F))
    rng = np.random.default_rng(random_state)

    if F <= exact_max_features:
        ints, masks = _all_coalitions(F)
        for si in range(n):
            v = _coalition_values(estimator, X[si], bg, masks, class_index)
            out[si] = _exact_shapley_from_coalitions(v, ints, masks, F)
        return out

    for si in range(n):
        acc = np.zeros(F)
        for _ in range(n_draws):
            # all F+1 masks along one permutation are known upfront: one
            # batched model call instead of F+1 sequential ones
            perm = rng.permutation(F)
            masks = np.zeros((F + 1, F), bool)
            for t, i in enumerate(perm, 1):
                masks[t] = masks[t - 1]
                masks[t, i] = True
            v = _coalition_values(estimator, X[si], bg, masks, class_index)
            acc[perm] += v[1:] - v[:-1]
        out[si] = acc / n_draws
    return out


def _exact_shapley_from_coalitions(v, ints, masks, F):
    """Order-1 Shapley values from a precomputed (2^F,) coalition value
    vector (phi_i = sum_S [v(S+i) - v(S)] / (F * C(F-1, |S|)))."""
    w = np.array([comb(F - 1, s) for s in range(F)], np.float64)
    sizes = masks.sum(axis=1)
    phi = np.zeros(F)
    for i in range(F):
        bit = 1 << i
        s_ints = ints[(ints & bit) == 0]
        delta = v[s_ints | bit] - v[s_ints]
        phi[i] = np.sum(delta / (F * w[sizes[s_ints]]))
    return phi


def shapley_interaction_values(estimator, X, background=None,
                               class_index: int = 1, n_draws: int = 32,
                               random_state: int = 0,
                               exact_max_features: int = 12):
    """Pairwise Shapley interaction indices (SII, order 2) of the
    positive-class probability — the reference's shapiq capability
    (shapiq.py:20-60, index 'k-SII', max_order=2).

    SII_ij = sum_{S subseteq N\\{i,j}} |S|!(F-|S|-2)!/(F-1)! *
             [v(S+ij) - v(S+i) - v(S+j) + v(S)]

    Returns (n_samples, F, F): symmetric off-diagonal interactions, with
    order-1 Shapley values on the diagonal. Exact for small F (every 2^F
    coalition evaluated once per sample); otherwise an unbiased Monte-Carlo
    estimate (uniform coalition size, uniform subset of that size — this
    sampling scheme's expectation IS the SII kernel).
    """
    X = np.asarray(X, np.float32)
    bg = (np.asarray(background, np.float32).mean(axis=0)
          if background is not None else X.mean(axis=0))
    n, F = X.shape
    if F < 2:
        raise ValueError("interactions need >= 2 features")
    out = np.zeros((n, F, F))
    rng = np.random.default_rng(random_state)

    if F <= exact_max_features:
        # one coalition-value vector per sample serves BOTH the pairwise
        # interactions and the order-1 diagonal (no second 2^F sweep)
        out_diag = np.zeros((n, F))
        ints, masks = _all_coalitions(F)
        sizes = masks.sum(axis=1)
        wk = np.array([comb(F - 2, s) * (F - 1) for s in range(F - 1)],
                      np.float64)
        for si in range(n):
            v = _coalition_values(estimator, X[si], bg, masks, class_index)
            out_diag[si] = _exact_shapley_from_coalitions(v, ints, masks, F)
            for i in range(F):
                for j in range(i + 1, F):
                    bi, bj = 1 << i, 1 << j
                    s_ints = ints[((ints & bi) == 0) & ((ints & bj) == 0)]
                    s_sizes = sizes[s_ints]
                    delta = (v[s_ints | bi | bj] - v[s_ints | bi]
                             - v[s_ints | bj] + v[s_ints])
                    val = np.sum(delta / wk[s_sizes])
                    out[si, i, j] = out[si, j, i] = val
    else:
        out_diag = shapley_values(estimator, X, background, class_index,
                                  n_draws=n_draws, random_state=random_state,
                                  exact_max_features=exact_max_features)
        pairs = [(i, j) for i in range(F) for j in range(i + 1, F)]
        for si in range(n):
            masks_all, meta = [], []
            for (i, j) in pairs:
                others = np.array([k for k in range(F) if k not in (i, j)])
                for _ in range(n_draws):
                    s = rng.integers(0, F - 1)  # uniform size in 0..F-2
                    S = rng.choice(others, s, replace=False)
                    base = np.zeros(F, bool)
                    base[S] = True
                    for inc_i, inc_j in ((1, 1), (1, 0), (0, 1), (0, 0)):
                        m = base.copy()
                        m[i], m[j] = bool(inc_i), bool(inc_j)
                        masks_all.append(m)
                    meta.append((i, j))
            v = _coalition_values(estimator, X[si], bg,
                                  np.asarray(masks_all), class_index)
            v = v.reshape(-1, 4)  # [v_ij, v_i, v_j, v_0] per draw
            delta = v[:, 0] - v[:, 1] - v[:, 2] + v[:, 3]
            for d, (i, j) in zip(delta, meta):
                out[si, i, j] += d
            for (i, j) in pairs:
                out[si, i, j] /= n_draws
                out[si, j, i] = out[si, i, j]
    for si in range(n):
        np.fill_diagonal(out[si], out_diag[si])
    return out


def feature_selection(estimator, X, y, n_features_to_select: int = 5,
                      direction: str = "forward", cv: int = 3,
                      scoring: str = "roc_auc"):
    """Returns (support_mask, selector): sklearn's
    `SequentialFeatureSelector` over any of these estimators (host-only:
    sklearn is imported here)."""
    fs = host_sklearn("feature_selection", "feature_selection")
    sfs = fs.SequentialFeatureSelector(
        estimator, n_features_to_select=n_features_to_select,
        direction=direction, cv=cv, scoring=scoring)
    sfs.fit(np.asarray(X, np.float32), np.asarray(y))
    return sfs.get_support(), sfs
