"""ManyClassClassifier: more classes than a base estimator takes, by
error-correcting output codes (own copy of the TPU package's
tabular/many_class.py).

Each codebook column groups the true classes into at most
`alphabet_size` pseudo-classes (a random balanced partition; the rows
distinct), a clone of the base estimator is fitted per column, and
prediction sums each column's log-probabilities onto the true classes.
The codebook is drawn from ``np.random.default_rng(random_state)`` as the
TPU package draws it. It needs only the port's `clone`, so it runs on the
card's machine over the port's in-context estimators.
"""

from __future__ import annotations

import numpy as np

from .estimator import BaseEstimator, ClassifierMixin, clone


class ManyClassClassifier(ClassifierMixin, BaseEstimator):
    def __init__(self, estimator=None, alphabet_size: int = 10,
                 n_estimators: int | None = None, random_state: int = 0):
        self.estimator = estimator
        self.alphabet_size = alphabet_size
        self.n_estimators = n_estimators
        self.random_state = random_state

    def _make_codebook(self, n_classes: int, n_cols: int, rng):
        """(n_classes, n_cols) ints in [0, alphabet_size) with distinct rows
        and every symbol used in every column."""
        for _ in range(200):
            book = np.stack([
                rng.permutation(
                    np.resize(np.arange(self.alphabet_size), n_classes))
                for _ in range(n_cols)
            ], axis=1)
            if len({tuple(r) for r in book}) == n_classes:
                return book
        raise RuntimeError("could not build a distinct-row codebook; "
                           "increase n_estimators")

    def fit(self, X, y):
        X = np.asarray(X)
        y = np.asarray(y)
        self.classes_, y_idx = np.unique(y, return_inverse=True)
        k = len(self.classes_)
        if self.estimator is None:
            raise ValueError("estimator is required")
        if k <= self.alphabet_size:
            # no codes needed: delegate on class indices 0..k-1
            self.code_book_ = None
            self.estimators_ = [clone_or_refit(self.estimator, X, y_idx)]
            return self

        rng = np.random.default_rng(self.random_state)
        n_cols = self.n_estimators or max(
            4, int(np.ceil(2 * np.log(max(k, 2)) /
                           np.log(self.alphabet_size))))
        self.code_book_ = self._make_codebook(k, n_cols, rng)
        self.estimators_ = []
        for j in range(n_cols):
            yj = self.code_book_[y_idx, j]
            self.estimators_.append(clone_or_refit(self.estimator, X, yj))
        return self

    def predict_proba(self, X):
        X = np.asarray(X)
        k = len(self.classes_)
        if self.code_book_ is None:
            # fitted on indices 0..k-1, so the columns are classes_'s
            return self.estimators_[0].predict_proba(X)
        logp = np.zeros((len(X), k))
        for j, est in enumerate(self.estimators_):
            pj = est.predict_proba(X)  # (n, alphabet_used)
            symbols = np.asarray(est.classes_).astype(int)
            col = np.full((len(X), self.alphabet_size), 1e-12)
            col[:, symbols] = np.clip(pj, 1e-12, 1.0)
            logp += np.log(col[:, self.code_book_[:, j]])
        logp -= logp.max(axis=1, keepdims=True)
        p = np.exp(logp)
        return p / p.sum(axis=1, keepdims=True)

    def predict(self, X):
        return self.classes_[np.argmax(self.predict_proba(X), axis=1)]


def clone_or_refit(est, X, y):
    """A fitted clone of `est`; an object `clone` cannot copy (no
    `get_params`) is fitted itself."""
    try:
        e = clone(est)
    except TypeError:
        e = est
    e.fit(X, y)
    return e
