"""Unsupervised tabular modeling: imputation, outlier scoring, generation
(own copy of the TPU package's tabular/unsupervised.py).

The joint feature distribution is modeled by per-feature CONDITIONAL fits
over random column permutations:

- `impute(X)`: missing entries predicted from observed columns, averaged
  over permutations,
- `outliers(X)`: per-sample negative log-likelihood under the chain of
  conditionals (higher = more outlying),
- `generate_synthetic_data(n)`: sequential column-by-column sampling from
  the fitted conditionals,
- `get_embeddings(X)`: per-column conditional predictions concatenated.

The conditional of a numeric column is a gaussian linear model: sklearn's
`Ridge(alpha=1)` with an intercept, solved here in closed form as sklearn's
'cholesky' solver solves it (the dual form when there are more columns
than rows). The conditional of a low-cardinality integer column is a
multinomial logistic model: sklearn's `LogisticRegression(max_iter=500)`
objective (mean log-loss + ||W||² / (2 C n), C = 1, the intercept not
penalised; one weight vector for two classes) minimised by scipy's L-BFGS-B
from zeros with sklearn's options. So nothing here needs sklearn, and the
card's machine (scipy, no sklearn) runs it. Its probabilities agree with
sklearn's to the solver's tolerance, not bit for bit
(tests/test_torch_port_tabular_meta.py states the bound).
"""

from __future__ import annotations

import numpy as np

from .estimator import BaseEstimator


class _Ridge:
    """sklearn's dense `Ridge(alpha=1)` with an intercept, 'cholesky'
    solver: centre X and y, solve (XᵀX + I) w = Xᵀy (or, with more columns
    than rows, (XXᵀ + I) d = y and w = Xᵀd) with a symmetric positive
    solve."""

    def fit(self, X, y):
        from scipy import linalg

        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        x_off, y_off = X.mean(axis=0), y.mean()
        Xc, yc = X - x_off, (y - y_off)[:, None]
        n, f = Xc.shape
        if f > n:
            K = Xc @ Xc.T
            K.flat[::n + 1] += 1.0
            coef = (Xc.T @ linalg.solve(K, yc, assume_a="pos")).T
        else:
            A = Xc.T @ Xc
            A.flat[::f + 1] += 1.0
            coef = linalg.solve(A, Xc.T @ yc, assume_a="pos", overwrite_a=True).T
        self.coef_ = coef.ravel()
        self.intercept_ = y_off - x_off @ self.coef_
        return self

    def predict(self, X):
        return np.asarray(X, np.float64) @ self.coef_ + self.intercept_


def _softmax(z):
    """(row softmax, row log-sum-exp) of `z`, shifted by the row maxima."""
    top = z.max(axis=1, keepdims=True)
    e = np.exp(z - top)
    s = e.sum(axis=1, keepdims=True)
    return e / s, (np.log(s) + top)[:, 0]


class _Logistic:
    """sklearn's `LogisticRegression(max_iter=500)` (lbfgs, L2, C = 1,
    tol 1e-4): the binomial model for two classes, the multinomial for
    more."""

    def fit(self, X, y_idx, n_classes: int):
        from scipy import optimize, special

        X = np.asarray(X, np.float64)
        n, f = X.shape
        l2 = 1.0 / n  # 1 / (C n)
        self.binary_ = n_classes == 2
        if self.binary_:
            t = (y_idx == 1).astype(np.float64)

            def loss_grad(w):
                z = X @ w[:f] + w[f]
                g = (special.expit(z) - t) / n
                loss = np.sum(np.logaddexp(0.0, z) - t * z) / n
                return (loss + 0.5 * l2 * (w[:f] @ w[:f]),
                        np.r_[X.T @ g + l2 * w[:f], g.sum()])
            w0 = np.zeros(f + 1)
        else:
            onehot = np.eye(n_classes)[y_idx]

            def loss_grad(w):
                W = w.reshape((n_classes, f + 1), order="F")
                z = X @ W[:, :f].T + W[:, f]
                p, lse = _softmax(z)
                g = (p - onehot) / n
                loss = np.sum(lse - z[np.arange(n), y_idx]) / n
                grad = np.empty((n_classes, f + 1), order="F")
                grad[:, :f] = g.T @ X + l2 * W[:, :f]
                grad[:, f] = g.sum(axis=0)
                return (loss + 0.5 * l2 * np.sum(W[:, :f] ** 2),
                        grad.ravel(order="F"))
            w0 = np.zeros(n_classes * (f + 1))
        res = optimize.minimize(loss_grad, w0, method="L-BFGS-B", jac=True, options={
            "maxiter": 500, "maxls": 50, "gtol": 1e-4,
            "ftol": 64 * np.finfo(float).eps})
        self.w_ = res.x if self.binary_ else res.x.reshape((n_classes, f + 1), order="F")
        return self

    def predict_proba(self, X):
        from scipy import special

        X = np.asarray(X, np.float64)
        f = X.shape[1]
        if self.binary_:
            p = special.expit(X @ self.w_[:f] + self.w_[f])
            return np.stack([1 - p, p], axis=1)
        return _softmax(X @ self.w_[:, :f].T + self.w_[:, f])[0]

    def predict(self, X):
        return np.argmax(self.predict_proba(X), axis=1)


def _is_categorical(col: np.ndarray, max_card: int = 10) -> bool:
    vals = col[~np.isnan(col)]
    u = np.unique(vals)
    return len(u) <= max_card and np.allclose(u, np.round(u))


class _ColumnConditional:
    """p(col j | other cols): gaussian-linear or multinomial."""

    def __init__(self, categorical: bool):
        self.categorical = categorical

    def fit(self, X_others, y_col):
        if self.categorical:
            self.classes_, y_idx = np.unique(y_col, return_inverse=True)
            if len(self.classes_) < 2:
                self.model = None
                return self
            self.model = _Logistic().fit(X_others, y_idx, len(self.classes_))
        else:
            self.model = _Ridge().fit(X_others, y_col)
            resid = y_col - self.model.predict(X_others)
            self.sigma_ = float(max(np.std(resid), 1e-3))
        return self

    def predict(self, X_others):
        if self.categorical:
            if self.model is None:
                return np.full(len(X_others), self.classes_[0])
            return self.classes_[self.model.predict(X_others)]
        return self.model.predict(X_others)

    def nll(self, X_others, y_col):
        if self.categorical:
            if self.model is None:
                return np.zeros(len(X_others))
            proba = self.model.predict_proba(X_others)
            idx = np.searchsorted(self.classes_, y_col)
            idx = np.clip(idx, 0, len(self.classes_) - 1)
            p = proba[np.arange(len(y_col)), idx]
            return -np.log(np.clip(p, 1e-12, 1.0))
        mu = self.model.predict(X_others)
        z = (y_col - mu) / self.sigma_
        return 0.5 * z ** 2 + np.log(self.sigma_) + 0.5 * np.log(2 * np.pi)

    def sample(self, X_others, rng):
        if self.categorical:
            if self.model is None:
                return np.full(len(X_others), self.classes_[0])
            proba = self.model.predict_proba(X_others)
            cum = np.cumsum(proba, axis=1)
            r = rng.random((len(X_others), 1))
            return self.classes_[(r > cum).sum(axis=1).clip(0, len(self.classes_) - 1)]
        mu = self.model.predict(X_others)
        return mu + rng.normal(0, self.sigma_, len(X_others))


class TabularUnsupervisedModel(BaseEstimator):
    """The joint feature distribution as chains of per-column conditionals
    over `n_permutations` random column orders (``np.random.
    default_rng(random_state)``): `impute`, `outliers`,
    `generate_synthetic_data` and `get_embeddings` as in the TPU
    package."""

    def __init__(self, n_permutations: int = 5, random_state: int = 0,
                 max_categorical_cardinality: int = 10):
        self.n_permutations = n_permutations
        self.random_state = random_state
        self.max_categorical_cardinality = max_categorical_cardinality

    def fit(self, X):
        X = np.asarray(X, np.float64)
        complete = ~np.isnan(X).any(axis=1)
        self.X_ = X[complete]
        if len(self.X_) < 4:
            raise ValueError("need at least 4 complete rows to fit")
        self.n_features_ = X.shape[1]
        self.col_means_ = np.nanmean(X, axis=0)
        self.categorical_ = [
            _is_categorical(X[:, j], self.max_categorical_cardinality)
            for j in range(self.n_features_)]

        rng = np.random.default_rng(self.random_state)
        self.permutations_ = [rng.permutation(self.n_features_)
                              for _ in range(self.n_permutations)]
        # one conditional per (permutation, position): col perm[k] given
        # cols perm[:k] (position 0 conditions on a constant column)
        self.conditionals_ = []
        for perm in self.permutations_:
            chain = []
            for k, j in enumerate(perm):
                prev = perm[:k]
                Xo = (self.X_[:, prev] if k else
                      np.zeros((len(self.X_), 1)))
                chain.append(_ColumnConditional(self.categorical_[j])
                             .fit(Xo, self.X_[:, j]))
            self.conditionals_.append(chain)
        return self

    def _check(self, X):
        X = np.asarray(X, np.float64)
        if X.shape[1] != self.n_features_:
            raise ValueError("feature count mismatch")
        return X

    def impute(self, X, iterations: int = 2) -> np.ndarray:
        """Missing entries <- mean over permutation chains of the
        conditional prediction given (iteratively refined) other columns."""
        X = self._check(X)
        missing = np.isnan(X)
        filled = np.where(missing, self.col_means_[None, :], X)
        for _ in range(iterations):
            acc = np.zeros_like(filled)
            wsum = np.zeros(self.n_features_)
            for perm, chain in zip(self.permutations_, self.conditionals_):
                est = filled.copy()
                for k, j in enumerate(perm):
                    prev = perm[:k]
                    Xo = est[:, prev] if k else np.zeros((len(est), 1))
                    pred = chain[k].predict(Xo)
                    est[:, j] = np.where(missing[:, j], pred, est[:, j])
                    # weight chains by conditioning depth: a column predicted
                    # from many observed columns beats one predicted from few
                    w = float(k + 1)
                    acc[:, j] += w * est[:, j]
                    wsum[j] += w
            filled = np.where(missing, acc / wsum[None, :], filled)
        return filled

    def outliers(self, X) -> np.ndarray:
        """Per-sample mean negative log-likelihood over permutation chains
        (reference outliers(): low density = outlier)."""
        X = self._check(X)
        X = np.where(np.isnan(X), self.col_means_[None, :], X)
        total = np.zeros(len(X))
        for perm, chain in zip(self.permutations_, self.conditionals_):
            for k, j in enumerate(perm):
                prev = perm[:k]
                Xo = X[:, prev] if k else np.zeros((len(X), 1))
                total += chain[k].nll(Xo, X[:, j])
        return total / len(self.permutations_)

    def generate_synthetic_data(self, n_samples: int = 100) -> np.ndarray:
        """Sequential sampling along one random permutation chain per
        sample batch."""
        rng = np.random.default_rng(self.random_state + 1)
        pick = rng.integers(0, len(self.permutations_))
        perm, chain = self.permutations_[pick], self.conditionals_[pick]
        out = np.zeros((n_samples, self.n_features_))
        for k, j in enumerate(perm):
            prev = perm[:k]
            Xo = out[:, prev] if k else np.zeros((n_samples, 1))
            out[:, j] = chain[k].sample(Xo, rng)
        return out

    def get_embeddings(self, X) -> np.ndarray:
        """Concatenation of per-column conditional predictions across
        permutations — a joint-structure feature map (reference
        get_embeddings_per_column analogue)."""
        X = self._check(X)
        X = np.where(np.isnan(X), self.col_means_[None, :], X)
        embs = []
        for perm, chain in zip(self.permutations_, self.conditionals_):
            pred = np.zeros_like(X)
            for k, j in enumerate(perm):
                prev = perm[:k]
                Xo = X[:, prev] if k else np.zeros((len(X), 1))
                pred[:, j] = chain[k].predict(Xo)
            embs.append(pred)
        return np.concatenate(embs, axis=1)
