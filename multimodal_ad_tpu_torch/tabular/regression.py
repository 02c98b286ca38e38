"""In-context tabular regression: `ICLRegressor` (own copy of the TPU
package's tabular/regression.py:26-269).

Backed by the bar-distribution network (icl_regression.py): context rows
embed the continuous target, the head emits a piecewise-uniform
distribution over context-normalized target space, and `predict` takes the
mean, median or quantiles of the view-averaged distribution. No gradients
at inference. The decision-tree, random-forest and tuned regressors of the
TPU package are not ported here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from .estimator import BaseEstimator, RegressorMixin
from .icl import (FeaturePreprocessMixin, _zscore_by_ctx, asset_key, cached_network,
                  no_asset_error, to_host)


class ICLRegressor(FeaturePreprocessMixin, RegressorMixin, BaseEstimator):
    """Regressor over the bar-distribution in-context network: fit /
    predict (`output_type` mean | median | quantiles) / get_embeddings.
    `preprocess="auto"` (default) picks the feature transform by holdout
    R², with the identity kept unless a transform beats it by 0.02;
    `n_estimators` feature-permutation views are averaged; `device` as
    ICLClassifier's."""

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
        from .icl_regression import load_default_reg_params

        if self.params is not None:
            return self.params
        key = self._asset_key()
        if key not in ICLRegressor._param_cache:
            bundled = load_default_reg_params(self._cfg)
            if bundled is None:
                raise no_asset_error(self._cfg)
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
        n = x_ctx.shape[0]
        dev = self._device
        self._views_dev = (
            torch.from_numpy(np.stack([x_ctx[:, p] for p in fp])).to(dev),
            torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
                self._fitted["y_ctx"][0], (V, n)))).to(dev),
            torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
                self._fitted["ctx_mask"][0], (V, n)))).to(dev))
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
