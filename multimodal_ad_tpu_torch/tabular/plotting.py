"""Matplotlib figures over the interpretability outputs (own copy of the
TPU package's tabular/plotting.py): an aggregate-importance bar panel with
a per-sample summary strip (`plot_attributions`), the most important
feature's value against its attribution colored by its strongest
potential interactor (`plot_attribution_scatter`), and a heatmap of the
order-2 Shapley interaction indices (`plot_interactions`). They draw from
the arrays of `marginal_contribution_values`, `shapley_values` and
`shapley_interaction_values`.

Host-only: matplotlib is imported when a function runs (the card's
machine has none). Each renders off-screen (Agg), returns the `Figure`,
and writes a PNG when `out` is given.
"""

from __future__ import annotations

import numpy as np


def _require_matplotlib():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _names(n_features: int, feature_names):
    if feature_names is None:
        return [f"x{j}" for j in range(n_features)]
    names = list(map(str, feature_names))
    if len(names) != n_features:
        raise ValueError(f"feature_names has {len(names)} entries for "
                         f"{n_features} features")
    return names


def plot_attributions(values, X=None, feature_names=None, out=None,
                      max_display: int = 15, title: str | None = None):
    """The reference `plot_shap` figure (shap.py:112-143) from an
    (n_samples, n_features) attribution matrix: left panel = aggregate
    mean |attribution| bar chart; right panel = per-sample summary strip
    per feature (a dot is one feature of one example, the beeswarm
    analogue), colored by the feature's value when ``X`` is given.

    ``values``: output of `marginal_contribution_values` or
    `shapley_values`. Returns the matplotlib Figure.
    """
    plt = _require_matplotlib()
    values = np.atleast_2d(np.asarray(values, np.float64))
    n, F = values.shape
    names = _names(F, feature_names)
    order = np.argsort(np.abs(values).mean(axis=0))[::-1][:max_display]

    fig, (ax_bar, ax_sum) = plt.subplots(
        1, 2, figsize=(11, max(3.0, 0.38 * len(order) + 1.5)), sharey=True)
    ypos = np.arange(len(order))[::-1]

    ax_bar.barh(ypos, np.abs(values).mean(axis=0)[order],
                color="#1f77b4")
    ax_bar.set_yticks(ypos)
    ax_bar.set_yticklabels([names[j] for j in order])
    ax_bar.set_xlabel("mean |attribution|")
    ax_bar.set_title("Aggregate feature importances")

    rng = np.random.default_rng(0)  # deterministic jitter
    for row, j in zip(ypos, order):
        yj = row + rng.uniform(-0.28, 0.28, n)
        if X is not None:
            xj = np.asarray(X, np.float64)[:, j]
            lo, hi = np.nanmin(xj), np.nanmax(xj)
            c = (xj - lo) / (hi - lo) if hi > lo else np.full(n, 0.5)
            ax_sum.scatter(values[:, j], yj, c=c, cmap="coolwarm",
                           s=14, alpha=0.8, linewidths=0)
        else:
            ax_sum.scatter(values[:, j], yj, color="#1f77b4",
                           s=14, alpha=0.6, linewidths=0)
    ax_sum.axvline(0.0, color="0.6", lw=0.8)
    ax_sum.set_xlabel("attribution")
    ax_sum.set_title("Per-sample attributions"
                     + (" (color = feature value)" if X is not None else ""))
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    if out is not None:
        fig.savefig(out, dpi=120, bbox_inches="tight")
    return fig


def plot_attribution_scatter(values, X, feature: int | str | None = None,
                             feature_names=None, out=None):
    """The reference `plot_shap_feature` figure (shap.py:146-178): the
    chosen feature's value vs its attribution, colored by the value of its
    strongest *potential interactor* — the other feature whose value
    correlates most with this feature's attribution (the heuristic behind
    shap.utils.potential_interactions). ``feature=None`` picks the feature
    with the largest mean |attribution|. Returns the Figure.
    """
    plt = _require_matplotlib()
    values = np.atleast_2d(np.asarray(values, np.float64))
    X = np.asarray(X, np.float64)
    n, F = values.shape
    names = _names(F, feature_names)
    j = (int(np.abs(values).mean(axis=0).argmax()) if feature is None
         else (names.index(feature) if isinstance(feature, str)
               else int(feature)))

    # potential interactor: |corr(attribution_j, value_k)| over k != j
    attr = values[:, j]
    scores = np.zeros(F)
    if n > 1 and np.std(attr) > 0:
        for k in range(F):
            if k == j or np.std(X[:, k]) == 0:
                continue
            scores[k] = abs(np.corrcoef(attr, X[:, k])[0, 1])
    k = int(np.argmax(scores))

    fig, ax = plt.subplots(figsize=(6, 4.2))
    sc = ax.scatter(X[:, j], attr, c=X[:, k], cmap="coolwarm", s=18,
                    alpha=0.85, linewidths=0)
    fig.colorbar(sc, ax=ax, label=f"value of {names[k]}")
    ax.axhline(0.0, color="0.6", lw=0.8)
    ax.set_xlabel(f"value of {names[j]}")
    ax.set_ylabel(f"attribution of {names[j]}")
    ax.set_title(f"{names[j]} colored by potential interactor {names[k]}")
    fig.tight_layout()
    if out is not None:
        fig.savefig(out, dpi=120, bbox_inches="tight")
    return fig


def plot_interactions(sii, feature_names=None, out=None,
                      max_display: int = 12, sample: int | None = None,
                      title: str | None = None):
    """Heatmap of order-2 Shapley interaction indices — the figure the
    reference's shapiq explainers exist to feed (shapiq.py:20-161; shapiq
    renders k-SII as interaction-network/heatmap plots). ``sii`` is the
    (n_samples, F, F) output of `shapley_interaction_values` (order-1
    values on the diagonal); ``sample=None`` plots the mean |SII| over
    samples, an int plots that sample's signed matrix. Returns the Figure.
    """
    plt = _require_matplotlib()
    sii = np.asarray(sii, np.float64)
    if sii.ndim == 2:
        sii = sii[None]
    F = sii.shape[1]
    names = _names(F, feature_names)

    if sample is None:
        M = np.abs(sii).mean(axis=0)
        cmap, vmin, vmax, label = "viridis", 0.0, None, "mean |k-SII|"
    else:
        M = sii[sample]
        lim = float(np.abs(M).max()) or 1.0
        cmap, vmin, vmax, label = "coolwarm", -lim, lim, "k-SII"

    # restrict to the strongest features by diagonal (order-1) magnitude
    keep = np.argsort(np.abs(sii).mean(axis=0).diagonal())[::-1][:max_display]
    keep = np.sort(keep)
    M = M[np.ix_(keep, keep)]
    kept_names = [names[j] for j in keep]

    fig, ax = plt.subplots(
        figsize=(max(4.0, 0.5 * len(keep) + 2), max(3.5, 0.5 * len(keep) + 1.5)))
    im = ax.imshow(M, cmap=cmap, vmin=vmin, vmax=vmax)
    fig.colorbar(im, ax=ax, label=label)
    ax.set_xticks(range(len(keep)))
    ax.set_xticklabels(kept_names, rotation=45, ha="right")
    ax.set_yticks(range(len(keep)))
    ax.set_yticklabels(kept_names)
    ax.set_title(title or ("Shapley interactions (diagonal = order-1 values)"
                           if sample is None else
                           f"Shapley interactions, sample {sample}"))
    fig.tight_layout()
    if out is not None:
        fig.savefig(out, dpi=120, bbox_inches="tight")
    return fig
