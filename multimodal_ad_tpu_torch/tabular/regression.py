"""In-context tabular regression: `ICLRegressor` (own copy of the TPU
package's tabular/regression.py:26-269).

Backed by the bar-distribution network (icl_regression.py): context rows
embed the continuous target, the head emits a piecewise-uniform
distribution over context-normalized target space, and `predict` takes the
mean, median or quantiles of the view-averaged distribution. No gradients
at inference. Beside it (the TPU package's regression.py:272-448): the
decision-tree and random-forest hybrids with regressors at the leaves
(host-only: sklearn's tree partitions), and `TunedICLRegressor`, the TPE
search with `hpo.guarded_selection`'s guard over shuffled `KFold` CV.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from .estimator import BaseEstimator, RegressorMixin, clone, host_sklearn
from .icl import FeaturePreprocessMixin, _zscore_by_ctx, asset_key, cached_network, to_host


class ICLRegressor(FeaturePreprocessMixin, RegressorMixin, BaseEstimator):
    """Regressor over the bar-distribution in-context network: fit /
    predict (`output_type` mean | median | quantiles) / get_embeddings.
    `preprocess="auto"` (default) picks the feature transform by holdout
    R², with the identity kept unless a transform beats it by 0.02;
    `n_estimators` feature-permutation views are averaged; `device` as
    ICLClassifier's (where no asset applies, the network is meta-trained
    there)."""

    _param_cache: dict = {}
    _model_cache: dict = {}

    def __init__(self, params=None, cfg=None, pretrain_steps: int = 300,
                 seed: int = 0, softmax_temperature: float = 1.0,
                 context_size: int | None = None,
                 preprocess: str | None = "auto",
                 n_estimators: int = 8,
                 screen_features="auto",
                 device: str = "cuda"):
        self.params = params
        self.cfg = cfg
        self.pretrain_steps = pretrain_steps
        self.seed = seed
        self.softmax_temperature = softmax_temperature
        self.context_size = context_size
        self.preprocess = preprocess
        self.screen_features = screen_features
        self.n_estimators = n_estimators
        self.device = device

    @property
    def _cfg(self):
        from .icl_regression import RegICLConfig

        return self.cfg or RegICLConfig()

    def _asset_key(self):
        from .icl_regression import default_reg_asset_path

        return asset_key(self, default_reg_asset_path())

    def _ensure_params(self):
        """`params`, else the bundled asset's, else a network meta-trained
        here on the estimator's device (`pretrain_icl_regression`)."""
        from .icl_regression import load_default_reg_params, pretrain_icl_regression

        if self.params is not None:
            return self.params
        key = self._asset_key()
        if key not in ICLRegressor._param_cache:
            bundled = load_default_reg_params(self._cfg)
            if bundled is None:
                bundled, _ = pretrain_icl_regression(
                    self._cfg, steps=self.pretrain_steps, seed=self.seed,
                    device=self.device)
            ICLRegressor._param_cache[key] = bundled
        return ICLRegressor._param_cache[key]

    def _state_dict(self, params):
        from ..utils.torch_weights import reg_icl_state_dict_from_flax

        return reg_icl_state_dict_from_flax(params, self._cfg)

    def _network(self):
        from .icl_regression import RegICLTransformer

        return cached_network(ICLRegressor._model_cache, self, self._ensure_params(),
                              lambda: RegICLTransformer(self._cfg))

    def _select_preprocess(self, X, y):
        """Pick the feature transform by internal-validation R²."""
        from .estimator import train_test_split

        if len(X) < 24:
            return None
        idx = np.arange(len(X))
        tr, vl = train_test_split(idx, test_size=0.25, random_state=self.seed)
        var = float(np.var(y[vl]))
        if var < 1e-12:
            return None
        kinds = [None, "whiten", "quantile"]
        if X.shape[1] >= 2 and X.shape[1] + 2 <= self._cfg.max_features:
            kinds.append("pairs")  # room for >=1 screened interaction (2 cols)
        scores = {}
        for kind in kinds:
            sub = ICLRegressor(
                params=self.params, cfg=self.cfg,
                pretrain_steps=self.pretrain_steps, seed=self.seed,
                softmax_temperature=self.softmax_temperature,
                context_size=self.context_size, preprocess=kind,
                n_estimators=self.n_estimators,
                screen_features=self.screen_features, device=self.device)
            try:
                sub.fit(X[tr], y[tr])
                mse = float(np.mean((sub.predict(X[vl]) - y[vl]) ** 2))
            except (ValueError, np.linalg.LinAlgError):
                continue
            scores[kind] = 1.0 - mse / var
        if not scores:
            return None
        base = scores.get(None, -np.inf)
        best_kind, best_r2 = None, base
        for kind in kinds[1:]:
            if scores.get(kind, -np.inf) > max(base + 0.02, best_r2):
                best_kind, best_r2 = kind, scores[kind]
        return best_kind

    def fit(self, X, y):
        self._device = resolve_device(self.device)
        self._ensure_params()  # no weights apply: raise before any work
        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.float64)
        kind = self.preprocess
        if kind == "auto":
            kind = self._select_preprocess(X, y)
        self.preprocess_ = kind
        Xp = self._fit_preprocess(X, kind, y=y)
        f_real = Xp.shape[1]  # width before padding: views permute only this
        X = self._pad_features(Xp)

        n_max = self._cfg.max_context
        if self.context_size is not None:
            n_max = min(n_max, int(self.context_size))
        if len(X) > n_max:
            # target-coverage subsampling: evenly spaced ranks of y
            order = np.argsort(y, kind="stable")
            sel = order[np.linspace(0, len(X) - 1, n_max).round().astype(int)]
            rng = np.random.default_rng(self.seed)
            rng.shuffle(sel)
            X, y = X[sel], y[sel]
        # normalize targets by the KEPT context's statistics
        self._y_mean = float(y.mean())
        self._y_std = float(max(y.std(), 1e-9))
        z = ((y - self._y_mean) / self._y_std).astype(np.float32)

        pad = self.context_bucket(len(X), self._cfg.max_context) - len(X)
        self._fitted = {
            "x_ctx": np.pad(X, ((0, pad), (0, 0)))[None],
            "y_ctx": np.pad(z, (0, pad))[None],
            "ctx_mask": np.pad(np.ones(len(X), np.float32), (0, pad))[None],
        }
        V = max(1, int(self.n_estimators))
        rng = np.random.default_rng((self.seed, 101))
        fp = [np.arange(self._cfg.max_features)]
        for _ in range(V - 1):
            p = np.arange(self._cfg.max_features)
            p[:f_real] = rng.permutation(f_real)
            fp.append(p)
        self._views = np.stack(fp)
        # permuted context views are fit-time constants: built + uploaded once
        x_ctx = self._fitted["x_ctx"][0]
        dev = self._device
        self._views_dev = (
            torch.from_numpy(np.stack([x_ctx[:, p] for p in fp])).to(dev),
            # copies: with V = 1 a broadcast view would alias the fitted arrays
            torch.from_numpy(np.repeat(self._fitted["y_ctx"][0][None], V, 0)).to(dev),
            torch.from_numpy(np.repeat(self._fitted["ctx_mask"][0][None], V, 0)).to(dev))
        return self

    def _bar_probs(self, X):
        """Mixture of per-view bar distributions ((M, n_bins), averaged over
        views) + identity-view embeddings, from one batched forward."""
        if getattr(self, "_fitted", None) is None:
            raise RuntimeError("fit() first")
        net = self._network()
        fp = self._views
        Xq = self._pad_features(self._apply_preprocess(X))
        x_ctx_v, y_ctx_v, mask_v = self._views_dev
        xq = torch.from_numpy(np.stack([Xq[:, p] for p in fp])).to(self._device)
        with torch.inference_mode():
            xc, xq = _zscore_by_ctx(x_ctx_v, xq, mask_v)
            logits, q_emb, _ = net(xc, y_ctx_v, mask_v, xq)
            logits, q0 = to_host(logits, q_emb[0])
        logits = logits.astype(np.float64)  # (V, M, n_bins)
        logits = logits / max(float(self.softmax_temperature), 1e-6)
        e = np.exp(logits - logits.max(-1, keepdims=True))
        probs = (e / e.sum(-1, keepdims=True)).mean(0)
        return probs, q0

    def predict(self, X, output_type: str = "mean", quantiles=None):
        """Decode the bar distribution: 'mean' (default), 'median', or
        'quantiles' (a list of arrays, one per requested quantile; 0.1,
        0.25, 0.5, 0.75, 0.9 by default)."""
        from .icl_regression import bin_centers

        probs, _ = self._bar_probs(X)
        centers = bin_centers(self._cfg).astype(np.float64)
        if output_type == "mean":
            z_hat = probs @ centers
            return z_hat * self._y_std + self._y_mean
        if output_type == "median":
            return self._quantiles_from_bars(probs, [0.5])[0]
        if output_type == "quantiles":
            qs = [0.1, 0.25, 0.5, 0.75, 0.9] if quantiles is None else list(
                quantiles)
            return self._quantiles_from_bars(probs, qs)
        raise ValueError(f"unknown output_type={output_type!r}")

    def _quantiles_from_bars(self, probs, qs):
        cfg = self._cfg
        edges = np.linspace(-cfg.y_clip, cfg.y_clip, cfg.n_bins + 1)
        cdf = np.cumsum(probs, axis=1)
        out = []
        for q in qs:
            # first bar where the CDF crosses q, linear inside it; rows whose
            # CDF ends just under q (q = 1.0) pin to the last bar
            crossed = cdf >= q
            i = np.where(crossed.any(1), np.argmax(crossed, axis=1),
                         cdf.shape[1] - 1)
            prev = np.where(i > 0, np.take_along_axis(
                cdf, np.maximum(i - 1, 0)[:, None], 1)[:, 0], 0.0)
            mass = np.take_along_axis(probs, i[:, None], 1)[:, 0]
            frac = np.clip((q - prev) / np.maximum(mass, 1e-12), 0.0, 1.0)
            z = edges[i] + frac * (edges[i + 1] - edges[i])
            out.append(z * self._y_std + self._y_mean)
        return out

    def get_embeddings(self, X, data_source: str = "test"):
        """(1, n, d_model): the identity view's query states."""
        _, emb = self._bar_probs(X)
        return emb[None]


class DecisionTreeICLRegressor(RegressorMixin, BaseEstimator):
    """Shallow regression tree (sklearn's, imported by `fit`: host-only)
    with base regressors at the leaves; a leaf with fewer than
    `min_leaf_fit` samples or a constant target predicts its mean."""

    def __init__(self, estimator=None, max_depth: int = 2,
                 min_leaf_fit: int = 8, random_state: int = 0):
        self.estimator = estimator
        self.max_depth = max_depth
        self.min_leaf_fit = min_leaf_fit
        self.random_state = random_state

    def fit(self, X, y):
        tree = host_sklearn("tree", "DecisionTreeICLRegressor")
        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.float64)
        self.tree_ = tree.DecisionTreeRegressor(
            max_depth=self.max_depth, random_state=self.random_state,
            min_samples_leaf=max(2, self.min_leaf_fit // 2))
        self.tree_.fit(X, y)
        leaves = self.tree_.apply(X)
        self.leaf_models_ = {}
        self.leaf_means_ = {}
        for leaf in np.unique(leaves):
            m = leaves == leaf
            self.leaf_means_[int(leaf)] = float(y[m].mean())
            if m.sum() >= self.min_leaf_fit and np.std(y[m]) > 1e-12:
                est = (clone(self.estimator) if self.estimator is not None
                       else tree.DecisionTreeRegressor(max_depth=3))
                est.fit(X[m], y[m])
                self.leaf_models_[int(leaf)] = est
        return self

    def predict(self, X):
        X = np.asarray(X, np.float32)
        leaves = self.tree_.apply(X)
        out = np.zeros(len(X))
        for leaf in np.unique(leaves):
            m = leaves == leaf
            model = self.leaf_models_.get(int(leaf))
            out[m] = (self.leaf_means_.get(int(leaf), 0.0) if model is None
                      else model.predict(X[m]))
        return out


class RandomForestICLRegressor(RegressorMixin, BaseEstimator):
    """Bagged DecisionTreeICLRegressors over bootstrap samples from
    ``np.random.default_rng(random_state)``."""

    def __init__(self, estimator=None, n_estimators: int = 4,
                 max_depth: int = 2, min_leaf_fit: int = 8,
                 bootstrap: bool = True, random_state: int = 0):
        self.estimator = estimator
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.min_leaf_fit = min_leaf_fit
        self.bootstrap = bootstrap
        self.random_state = random_state

    def fit(self, X, y):
        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.float64)
        rng = np.random.default_rng(self.random_state)
        self.trees_ = []
        for t in range(self.n_estimators):
            idx = (rng.integers(0, len(X), len(X)) if self.bootstrap
                   else np.arange(len(X)))
            tree = DecisionTreeICLRegressor(
                estimator=self.estimator, max_depth=self.max_depth,
                min_leaf_fit=self.min_leaf_fit,
                random_state=self.random_state + t)
            tree.fit(X[idx], y[idx])
            self.trees_.append(tree)
        return self

    def predict(self, X):
        return np.mean([t.predict(X) for t in self.trees_], axis=0)


class TunedICLRegressor(RegressorMixin, BaseEstimator):
    """Tuned regressor (TunedTabPFNRegressor's role): adaptive TPE trial
    proposal (`hpo.TPESampler`, the reference's hyperopt dimension;
    ``search="random"`` recovers random search) with the same
    selection-bias guard as the classifier wrapper — the default config
    wins unless a trial beats it by more than CV noise
    (`hpo.guarded_selection`)."""

    def __init__(self, base_estimator=None, n_trials: int = 10,
                 metric: str = "rmse", n_splits: int = 3,
                 random_state: int = 0, search: str = "adaptive"):
        self.search = search
        self.base_estimator = base_estimator
        self.n_trials = n_trials
        self.metric = metric
        self.n_splits = n_splits
        self.random_state = random_state

    def _cv_scores(self, X, y, trial, seed):
        from .estimator import KFold
        from .scoring import score_regression

        kf = KFold(n_splits=self.n_splits, shuffle=True, random_state=seed)
        scores = []
        for tr, vl in kf.split(X):
            est = self._make(trial).fit(X[tr], y[tr])
            scores.append(score_regression(self.metric, y[vl],
                                           est.predict(X[vl])))
        return scores

    def fit(self, X, y):
        from .hpo import TPESampler, guarded_selection

        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.float64)
        rng = np.random.default_rng(self.random_state)

        def draw(r):
            return {
                "softmax_temperature": float(r.choice([0.75, 1.0, 1.25])),
                "seed": int(r.integers(0, 10_000)),
                "preprocess": [None, None, "quantile", "whiten", "pairs"][
                    int(r.integers(0, 5))],
                # permuted-view count (the classifier HPO space's
                # n_estimators dimension); _make only applies it when the
                # base exposes it
                "n_estimators": int(r.choice([1, 4, 8])),
            }

        proposer = None
        if self.search == "adaptive":
            proposer = TPESampler(
                {"softmax_temperature": [0.75, 1.0, 1.25],
                 "preprocess": [None, "quantile", "whiten", "pairs"],
                 "n_estimators": [1, 4, 8]}, init_sampler=draw,
                n_init=max(4, min(8, self.n_trials // 2)))
        elif self.search != "random":
            raise ValueError(f"unknown search={self.search!r}")
        # trial None = the unmodified base config; tuning never loses to it
        trials, fold_scores = [], []
        for t in range(1 + self.n_trials):
            if t == 0:
                trial = None
            elif proposer is None:
                trial = draw(rng)
            else:
                trial = dict(proposer.ask(rng))
                trial["seed"] = int(rng.integers(0, 10_000))
            scores = self._cv_scores(X, y, trial, self.random_state)
            trials.append(trial)
            fold_scores.append(scores)
            if proposer is not None and trial is not None:
                # losses: negate so the sampler's good set is low-rmse
                proposer.tell(trial, -float(np.nanmean(scores)))
        pick, fresh = guarded_selection(
            trials, fold_scores,
            rescore=lambda tr, rep: self._cv_scores(
                X, y, tr, self.random_state + 1 + rep),
            sign=-1.0, return_evidence=True)  # rmse/mse/mae: lower better
        self.best_params_ = trials[pick]
        # fresh-fold mean when the guard re-scored (winner's-curse fix)
        self.best_score_ = float(np.nanmean(
            fresh if fresh else fold_scores[pick]))
        self.best_estimator_ = self._make(trials[pick]).fit(X, y)
        return self

    def _make(self, trial):
        if self.base_estimator is not None:
            est = clone(self.base_estimator)
            if trial is not None:
                est.set_params(**{k: v for k, v in trial.items()
                                  if k in est.get_params()})
            return est
        if trial is None:  # the unmodified base config (auto preprocess)
            return ICLRegressor()
        return ICLRegressor(softmax_temperature=trial["softmax_temperature"],
                            seed=trial["seed"],
                            preprocess=trial.get("preprocess"),
                            n_estimators=trial.get("n_estimators", 8))

    def predict(self, X):
        return self.best_estimator_.predict(X)
