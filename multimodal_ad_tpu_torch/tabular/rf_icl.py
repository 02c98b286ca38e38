"""Decision-tree / random-forest hybrids with in-context learners at the
leaves (own copy of the TPU package's tabular/rf_icl.py).

A shallow tree partitions the data; a clone of the base estimator (the
port's ICLClassifier on its device, or any classifier with `fit` /
`predict_proba`) is fitted on each leaf's samples; prediction routes rows
to their leaf's model. Leaves with fewer than `min_leaf_fit` samples or
one class answer with the leaf's class prior. The forest bags such trees
over bootstrap samples drawn from ``np.random.default_rng(random_state)``.

The partitioning tree is sklearn's `DecisionTreeClassifier`, imported when
`fit` runs: these wrappers are host-only (the card's machine has no
sklearn), while their leaf estimators may run on the card.
"""

from __future__ import annotations

import numpy as np

from .estimator import BaseEstimator, ClassifierMixin, clone, host_sklearn


class DecisionTreeICLClassifier(ClassifierMixin, BaseEstimator):
    def __init__(self, estimator=None, max_depth: int = 2,
                 min_leaf_fit: int = 8, random_state: int = 0):
        self.estimator = estimator
        self.max_depth = max_depth
        self.min_leaf_fit = min_leaf_fit
        self.random_state = random_state

    def fit(self, X, y):
        tree = host_sklearn("tree", "DecisionTreeICLClassifier")
        X = np.asarray(X, np.float32)
        y = np.asarray(y)
        self.classes_, y_idx = np.unique(y, return_inverse=True)
        k = len(self.classes_)
        self.tree_ = tree.DecisionTreeClassifier(
            max_depth=self.max_depth, random_state=self.random_state,
            min_samples_leaf=max(2, self.min_leaf_fit // 2))
        self.tree_.fit(X, y_idx)
        leaves = self.tree_.apply(X)

        self.leaf_models_ = {}
        self.leaf_priors_ = {}
        for leaf in np.unique(leaves):
            m = leaves == leaf
            prior = np.bincount(y_idx[m], minlength=k).astype(float)
            self.leaf_priors_[int(leaf)] = prior / prior.sum()
            if m.sum() >= self.min_leaf_fit and len(np.unique(y_idx[m])) > 1:
                est = clone(self.estimator) if self.estimator is not None \
                    else tree.DecisionTreeClassifier(max_depth=3)
                est.fit(X[m], y_idx[m])
                self.leaf_models_[int(leaf)] = est
        return self

    def predict_proba(self, X):
        X = np.asarray(X, np.float32)
        k = len(self.classes_)
        leaves = self.tree_.apply(X)
        out = np.zeros((len(X), k))
        for leaf in np.unique(leaves):
            m = leaves == leaf
            model = self.leaf_models_.get(int(leaf))
            if model is None:
                out[m] = self.leaf_priors_.get(
                    int(leaf), np.full(k, 1.0 / k))[None, :]
            else:
                p = model.predict_proba(X[m])
                seen = np.asarray(model.classes_, int)
                full = np.zeros((m.sum(), k))
                full[:, seen] = p
                out[m] = full
        return out

    def predict(self, X):
        return self.classes_[np.argmax(self.predict_proba(X), axis=1)]


class RandomForestICLClassifier(ClassifierMixin, BaseEstimator):
    """Bagged DecisionTreeICLClassifiers over bootstrap samples."""

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
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        rng = np.random.default_rng(self.random_state)
        self.trees_ = []
        for t in range(self.n_estimators):
            idx = (rng.integers(0, len(X), len(X)) if self.bootstrap
                   else np.arange(len(X)))
            tree = DecisionTreeICLClassifier(
                estimator=self.estimator, max_depth=self.max_depth,
                min_leaf_fit=self.min_leaf_fit,
                random_state=self.random_state + t)
            tree.fit(X[idx], y[idx])
            self.trees_.append(tree)
        return self

    def predict_proba(self, X):
        k = len(self.classes_)
        acc = np.zeros((len(np.asarray(X)), k))
        for tree in self.trees_:
            p = tree.predict_proba(X)
            seen = np.searchsorted(self.classes_, tree.classes_)
            full = np.zeros_like(acc)
            full[:, seen] = p
            acc += full
        return acc / len(self.trees_)

    def predict(self, X):
        return self.classes_[np.argmax(self.predict_proba(X), axis=1)]
