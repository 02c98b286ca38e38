"""Post-hoc and sklearn-style ensembles (own copy of the TPU package's
tabular/ensembles.py):

- `GreedyWeightedEnsemble`: Caruana-style greedy forward selection WITH
  replacement over base-model validation probabilities,
- `AutoICLClassifier` (AutoTabPFNClassifier's role): a config sweep of the
  in-context learner -> a stratified holdout (`estimator.py::
  train_test_split`, sklearn's split) -> the greedy weighted ensemble,
  members refit on all the data,
- `make_voting_classifier` / `make_stacking_classifier`: sklearn's
  meta-models over any of these estimators, host-only (sklearn is imported
  inside them; the card's machine has none).
"""

from __future__ import annotations

import numpy as np

from .estimator import BaseEstimator, ClassifierMixin, host_sklearn, train_test_split
from .scoring import score_classification


class GreedyWeightedEnsemble:
    """Greedy forward selection with replacement (Caruana et al. 2004):
    at each round add the model whose inclusion maximizes the validation
    metric of the averaged probabilities. Weights = selection counts."""

    def __init__(self, metric: str = "roc_auc", n_rounds: int = 25,
                 higher_is_better: bool = True):
        self.metric = metric
        self.n_rounds = n_rounds
        self.higher_is_better = higher_is_better

    def fit(self, probas: list[np.ndarray], y_val) -> "GreedyWeightedEnsemble":
        probas = [np.asarray(p) for p in probas]
        m = len(probas)
        counts = np.zeros(m, np.int64)
        running = np.zeros_like(probas[0])
        best_overall = -np.inf

        for _ in range(self.n_rounds):
            best_i, best_s = None, -np.inf
            k = counts.sum()
            for i in range(m):
                cand = (running * k + probas[i]) / (k + 1)
                s = score_classification(self.metric, y_val, cand)
                if not self.higher_is_better:
                    s = -s
                if np.isnan(s):
                    continue
                if s > best_s:
                    best_i, best_s = i, s
            if best_i is None or (k > 0 and best_s <= best_overall - 1e-12):
                break
            counts[best_i] += 1
            running = (running * k + probas[best_i]) / (k + 1)
            best_overall = max(best_overall, best_s)

        if counts.sum() == 0:
            counts[:] = 1  # degenerate: uniform
        self.weights_ = counts / counts.sum()
        self.val_score_ = best_overall if self.higher_is_better else -best_overall
        return self

    def predict_proba(self, probas: list[np.ndarray]) -> np.ndarray:
        probas = [np.asarray(p) for p in probas]
        return sum(w * p for w, p in zip(self.weights_, probas))


class AutoICLClassifier(ClassifierMixin, BaseEstimator):
    """AutoTabPFNClassifier parity: sample `n_configs` inference configs of
    the base in-context learner, evaluate on a holdout split, build a greedy
    weighted ensemble of their probabilities, then refit members on the full
    training set for prediction."""

    def __init__(self, base_estimator=None, n_configs: int = 8,
                 metric: str = "roc_auc", holdout_frac: float = 0.33,
                 max_rounds: int = 25, random_state: int = 0):
        self.base_estimator = base_estimator
        self.n_configs = n_configs
        self.metric = metric
        self.holdout_frac = holdout_frac
        self.max_rounds = max_rounds
        self.random_state = random_state

    def _configs(self, rng, n_train):
        from .hpo import default_search_space

        # the UNMODIFIED base estimator (with its own fit-time automatic
        # preprocessing selection) is always candidate #0 — random config
        # draws can miss the one transform a family needs, and the greedy
        # ensemble must never end up strictly worse than plain ICL
        return [None] + [default_search_space(rng, n_train)
                         for _ in range(self.n_configs)]

    def _make(self, trial):
        from .hpo import make_from_trial

        # shared trial builder: every sampled dimension (incl. n_ensemble
        # members and n_estimators views) is applied, so trials_ always
        # describes the estimator that was actually scored
        return make_from_trial(self.base_estimator, trial)

    def fit(self, X, y):
        X = np.asarray(X, np.float32)
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        rng = np.random.default_rng(self.random_state)
        X_tr, X_vl, y_tr, y_vl = train_test_split(
            X, y, test_size=self.holdout_frac,
            random_state=self.random_state, stratify=y)

        self.trials_ = self._configs(rng, len(X_tr))
        val_probas = []
        for trial in self.trials_:
            est = self._make(trial).fit(X_tr, y_tr)
            val_probas.append(est.predict_proba(X_vl))

        self.ensemble_ = GreedyWeightedEnsemble(
            self.metric, n_rounds=self.max_rounds).fit(val_probas, y_vl)
        # refit ensemble members on ALL data for inference
        self.members_ = [self._make(t).fit(X, y) for t, w in
                         zip(self.trials_, self.ensemble_.weights_) if w > 0]
        self.member_weights_ = np.asarray(
            [w for w in self.ensemble_.weights_ if w > 0])
        self.member_weights_ = self.member_weights_ / self.member_weights_.sum()
        return self

    def predict_proba(self, X):
        probas = [m.predict_proba(X) for m in self.members_]
        return sum(w * p for w, p in zip(self.member_weights_, probas))

    def predict(self, X):
        return self.classes_[np.argmax(self.predict_proba(X), axis=1)]


def make_voting_classifier(estimators, voting: str = "soft", **kw):
    """sklearn's `VotingClassifier` over any of these estimators
    (host-only: sklearn is imported here)."""
    ensemble = host_sklearn("ensemble", "make_voting_classifier")
    return ensemble.VotingClassifier(estimators=estimators, voting=voting, **kw)


def make_stacking_classifier(estimators, final_estimator=None, **kw):
    """sklearn's `StackingClassifier` (a logistic regression on top by
    default) over any of these estimators (host-only)."""
    ensemble = host_sklearn("ensemble", "make_stacking_classifier")
    if final_estimator is None:
        linear = host_sklearn("linear_model", "make_stacking_classifier")
        final_estimator = linear.LogisticRegression(max_iter=1000)
    return ensemble.StackingClassifier(estimators=estimators,
                                       final_estimator=final_estimator, **kw)
