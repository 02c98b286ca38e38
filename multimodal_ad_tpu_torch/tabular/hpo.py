"""Hyperparameter-tuned in-context classifier (own copy of the TPU
package's tabular/hpo.py).

A search over the *inference* hyperparameters of the prior-fitted network
(no gradient training): the best trial by CV metric is refit on the full
data. Trials come from `TPESampler`, a Tree-structured Parzen Estimator
over finite choice lists, after exploratory draws from
`default_search_space` (``search="random"`` keeps to those draws), and
`guarded_selection` keeps the default configuration unless a trial beats
it by more than the noise of the comparison.

Search space (ICLClassifier inference knobs): softmax temperature, context
size and subsample seed; the feature transform (none, quantile rank-gauss,
ZCA whitening or the quadratic 'pairs' expansion); the seed-ensemble size
(optionally with preprocess-diverse members); the permuted-view count; log-
or probability-space member averaging; the width-screen cap.

Every draw comes from the caller's ``np.random.Generator`` in the TPU
package's order, so the same fold scores give the same trials and the same
pick. The CV folds are `estimator.py::StratifiedKFold` (sklearn's), so
everything here runs on the card's machine.
"""

from __future__ import annotations

import numpy as np

from .estimator import BaseEstimator, ClassifierMixin, StratifiedKFold, clone
from .scoring import score_classification


class SeedEnsembleICL(ClassifierMixin, BaseEstimator):
    """Average predict_proba over members that differ in context-subsample
    seed (and, when `diverse_preprocess`, cycle through feature
    transforms) — the reference HPO's N_ensemble_configurations analogue;
    each member is one more forward, no extra training.

    `average_logits` averages members in LOG space before the softmax
    (the reference space's `average_before_softmax` dimension,
    hpo/search_space.py:126) — sharper when members agree, since the
    geometric mean does not dilute confident members the way the
    arithmetic probability mean does."""

    def __init__(self, base_estimator=None, n_members: int = 4,
                 diverse_preprocess: bool = False,
                 average_logits: bool = False):
        self.base_estimator = base_estimator
        self.n_members = n_members
        self.diverse_preprocess = diverse_preprocess
        self.average_logits = average_logits

    def fit(self, X, y):
        from .icl import ICLClassifier

        base = (self.base_estimator if self.base_estimator is not None
                else ICLClassifier())
        cycle = ([None, "whiten", "quantile", "pairs"]
                 if self.diverse_preprocess
                 else [base.get_params().get("preprocess", None)])
        self.members_ = []
        for i in range(self.n_members):
            est = clone(base)
            # only set knobs the base actually exposes — a non-ICL base
            # (plain sklearn estimator) still works, it just gets
            # identical members beyond any internal randomness
            have = est.get_params()
            updates = {}
            if "seed" in have:
                updates["seed"] = int(have["seed"] or 0) + 37 * i
            if "preprocess" in have:
                updates["preprocess"] = cycle[i % len(cycle)]
            if updates:
                est.set_params(**updates)
            self.members_.append(est.fit(X, y))
        self.classes_ = self.members_[0].classes_
        return self

    def predict_proba(self, X):
        probas = [m.predict_proba(X) for m in self.members_]
        if not self.average_logits:
            return np.mean(probas, axis=0)
        # geometric mean renormalized = softmax of mean log-probabilities
        logp = np.mean([np.log(np.maximum(p, 1e-12)) for p in probas], axis=0)
        e = np.exp(logp - logp.max(1, keepdims=True))
        return e / e.sum(1, keepdims=True)

    def predict(self, X):
        return self.classes_[np.argmax(self.predict_proba(X), axis=1)]


def default_search_space(rng: np.random.Generator, n_train: int) -> dict:
    return {
        "softmax_temperature": float(rng.choice([0.5, 0.75, 1.0, 1.25, 1.5])),
        "context_size": int(rng.choice(
            [s for s in (64, 128, 256, 512) if s <= max(64, n_train)])),
        "seed": int(rng.integers(0, 10_000)),
        "preprocess": [None, None, "quantile", "whiten", "pairs"][
            int(rng.integers(0, 5))],
        "n_ensemble": int(rng.choice([1, 1, 2, 4])),
        "diverse_preprocess": bool(rng.random() < 0.3),
        # permuted-view count inside each member (the reference searches
        # its ensemble-configurations dimension the same way)
        "n_estimators": int(rng.choice([1, 2, 4, 8])),
        # log- vs probability-space member averaging (the reference's
        # average_before_softmax dimension, hpo/search_space.py:126)
        "average_logits": bool(rng.random() < 0.5),
        # width-screen cap for wide tables ("auto" = meta-trained range,
        # max_features//2; smaller caps discard more noise columns — the
        # analogue of the reference's feature-subsampling dimension,
        # hpo/search_space.py:18-244)
        "screen_features": ["auto", "auto", 64, 32, 16][
            int(rng.integers(0, 5))],
    }


def classifier_choice_space(n_train: int) -> dict:
    """The `default_search_space` dimensions as deduplicated choice lists
    (the declarative form `TPESampler` models densities over). The `seed`
    nuisance dimension is excluded — it is drawn uniformly per trial and
    carries no structure worth modeling."""
    return {
        "softmax_temperature": [0.5, 0.75, 1.0, 1.25, 1.5],
        "context_size": [s for s in (64, 128, 256, 512)
                         if s <= max(64, n_train)],
        "preprocess": [None, "quantile", "whiten", "pairs"],
        "n_ensemble": [1, 2, 4],
        "diverse_preprocess": [False, True],
        "n_estimators": [1, 2, 4, 8],
        "average_logits": [False, True],
        "screen_features": ["auto", 64, 32, 16],
    }


class TPESampler:
    """Adaptive trial proposal: univariate Tree-structured Parzen
    Estimator over a finite choice space.

    The reference tunes with hyperopt TPE; every dimension of this space
    is a finite choice list, for which TPE's
    per-dimension Parzen densities reduce exactly to Laplace-smoothed
    category frequencies. After ``n_init`` exploratory draws (from
    ``init_sampler`` so the hand-tuned prior weighting of
    `default_search_space` is kept), each ask() splits the observed
    trials at the top-``gamma`` quantile into good/bad sets, samples
    ``n_candidates`` joint configurations from the good-set density
    l(x) (plus exploratory draws from the prior), and proposes the
    candidate maximizing sum_d log l_d(x_d) / g_d(x_d) — hyperopt's
    expected-improvement surrogate on categorical dimensions.

    Scores passed to tell() must be HIGHER-better (callers with losses
    negate). Non-finite scores are kept as worst-tier evidence."""

    def __init__(self, space: dict, init_sampler, n_init: int = 8,
                 gamma: float = 0.33, n_candidates: int = 24,
                 n_explore: int = 4, smoothing: float = 1.0):
        self.space = {k: list(v) for k, v in space.items()}
        self.init_sampler = init_sampler
        self.n_init = n_init
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.n_explore = n_explore
        self.smoothing = smoothing
        self.observations: list[tuple[dict, float]] = []

    def _project(self, trial: dict) -> dict:
        """Keep only modeled dimensions whose value is in the choice list
        (init_sampler may carry extra keys like `seed`)."""
        return {k: trial[k] for k in self.space
                if k in trial and trial[k] in self.space[k]}

    def _densities(self, trials: list[dict]) -> dict:
        dens = {}
        for k, choices in self.space.items():
            counts = np.full(len(choices), self.smoothing, np.float64)
            for t in trials:
                if k in t:
                    counts[choices.index(t[k])] += 1.0
            dens[k] = counts / counts.sum()
        return dens

    def ask(self, rng: np.random.Generator) -> dict:
        obs = self.observations
        if len(obs) < self.n_init:
            return self._project(self.init_sampler(rng))
        scores = np.array([s if np.isfinite(s) else -np.inf
                           for _, s in obs])
        n_good = max(1, int(np.ceil(self.gamma * len(obs))))
        order = np.argsort(scores)[::-1]
        good = [self._project(obs[i][0]) for i in order[:n_good]]
        bad = [self._project(obs[i][0]) for i in order[n_good:]]
        l, g = self._densities(good), self._densities(bad)

        cands = []
        for _ in range(self.n_candidates):
            cands.append({k: self.space[k][int(rng.choice(
                len(self.space[k]), p=l[k]))] for k in self.space})
        for _ in range(self.n_explore):
            cands.append(self._project(self.init_sampler(rng)))
        ei = [sum(np.log(l[k][self.space[k].index(c[k])]
                         / g[k][self.space[k].index(c[k])])
                  for k in self.space if k in c)
              for c in cands]
        return cands[int(np.argmax(ei))]

    def tell(self, trial: dict, score: float):
        self.observations.append((self._project(trial), float(score)))


def make_from_trial(base_estimator, trial: dict | None):
    """Build the estimator a `default_search_space` trial describes — the
    ONE place trial keys are applied, shared by the Tuned and Auto
    wrappers so a sampled dimension is never silently ignored. trial=None
    means the unmodified base config (auto preprocess)."""
    from .icl import ICLClassifier

    est = (clone(base_estimator) if base_estimator is not None
           else ICLClassifier())
    if trial is None:
        return est
    params = est.get_params()
    est.set_params(softmax_temperature=trial["softmax_temperature"],
                   context_size=trial["context_size"], seed=trial["seed"],
                   preprocess=trial["preprocess"],
                   **({"n_estimators": trial["n_estimators"]}
                      if "n_estimators" in trial
                      and "n_estimators" in params else {}),
                   **({"screen_features": trial["screen_features"]}
                      if "screen_features" in trial
                      and "screen_features" in params else {}))
    if trial.get("n_ensemble", 1) > 1:
        return SeedEnsembleICL(
            est, n_members=trial["n_ensemble"],
            diverse_preprocess=trial.get("diverse_preprocess", False),
            average_logits=trial.get("average_logits", False))
    return est


def guarded_selection(trials, fold_scores, rescore, sign: float = 1.0,
                      n_finalists: int = 2, n_rescore: int = 2,
                      verbose: bool = False,
                      return_evidence: bool = False):
    """Selection-bias guard for HPO over noisy CV scores: the default
    config (trials[0] is None) wins unless a searched trial beats it by
    more than the NOISE of the comparison.

    An HPO wrapper whose space contains the default must never finish
    below it, but picking the argmax of noisy CV means does exactly that
    about half the time on near-tied spaces. Guard: the top
    ``n_finalists`` candidates that beat the default's first-pass mean are
    RE-SCORED (together with the default) on ``n_rescore`` fresh,
    differently-seeded CVs via ``rescore(trial, rep)``; a candidate is
    adopted only if its PAIRED per-fold advantage over the default ON THE
    FRESH FOLDS ONLY has mean > TWICE its standard error. The SE is the
    LARGER of the pooled per-fold SE and the between-rep-mean SE: fold
    diffs within a rep share overlapping k-fold training sets and all
    reps share the dataset, so the pooled estimate alone understates the
    noise — the rep-level spread catches the correlated component. Even
    so the bar is a *nominal* ~95% one-sided under an independence
    approximation, not an exact guarantee; the strict 2x multiplier and
    the fresh-folds rule are what carry the asymmetric-cost design in
    practice. The first-pass folds are deliberately EXCLUDED from the
    decision: the finalist was selected *because* it scored high on them,
    so they carry winner's-curse bias — pooling them in can still adopt
    a trial that loses on test even at a 2x-SE bar. The asymmetric cost ("Tuned must never
    lose to its own default") warrants both the fresh-folds-only rule and
    the strict multiplier. ``sign`` is +1 when higher scores are better,
    -1 for losses (rmse/mse/mae).

    ``fold_scores`` must be paired: every trial scored on the SAME CV
    splits, and ``rescore(trial, rep)`` must use the same splits for every
    trial at a given ``rep``. Returns the index into ``trials`` of the
    guarded pick (0 = the default); with ``return_evidence=True`` returns
    ``(pick, fresh_scores)`` where ``fresh_scores`` is the flat list of
    the picked trial's fresh re-scored fold scores (``None`` when the
    default is kept without any re-scoring) — callers should report
    ``best_score_`` from these rather than the winner's-curse-biased
    first-pass mean.

    Cost note: when any candidate beats the default's first-pass mean,
    the guard runs up to ``(1 + n_finalists) * n_rescore`` EXTRA full CVs
    (default shape: up to 6) on top of the search itself; ``verbose``
    logs the count so fit-time regressions on slow backends are
    attributable."""
    means = [float(sign * np.nanmean(s)) for s in fold_scores]
    order = np.argsort(means)[::-1]
    cands = [int(i) for i in order
             if i != 0 and means[i] > means[0]][:n_finalists]
    if not cands:
        return (0, None) if return_evidence else 0
    base_fresh = [np.asarray(rescore(trials[0], r), np.float64)
                  for r in range(n_rescore)]
    if verbose:
        print(f"[hpo guard] re-scoring default + {len(cands)} finalist(s) "
              f"x {n_rescore} fresh CVs "
              f"({(1 + len(cands)) * n_rescore} extra CV fits)")
    best_i, best_adv, best_fresh = 0, 0.0, None
    for i in cands:
        cand_fresh = [np.asarray(rescore(trials[i], r), np.float64)
                      for r in range(n_rescore)]
        per_rep = [sign * (cand_fresh[r] - base_fresh[r])
                   for r in range(n_rescore)]
        d = np.concatenate(per_rep)
        d = d[np.isfinite(d)]
        if len(d) < 2:
            continue
        se = float(d.std(ddof=1) / np.sqrt(len(d)))
        rep_means = [float(np.nanmean(r)) for r in per_rep
                     if np.isfinite(r).any()]
        if len(rep_means) >= 2:
            se = max(se, float(np.std(rep_means, ddof=1)
                               / np.sqrt(len(rep_means))))
        if verbose:
            print(f"[hpo guard] finalist {i}: fresh paired advantage "
                  f"{d.mean():+.4f} (se {se:.4f})")
        if d.mean() > max(2.0 * se, 1e-6) and d.mean() > best_adv:
            best_i, best_adv = i, float(d.mean())
            best_fresh = [float(v) for v in
                          np.concatenate(cand_fresh) if np.isfinite(v)]
    if return_evidence:
        if best_i == 0:
            base_flat = [float(v) for v in np.concatenate(base_fresh)
                         if np.isfinite(v)]
            return 0, base_flat
        return best_i, best_fresh
    return best_i


class TunedICLClassifier(ClassifierMixin, BaseEstimator):
    """Adaptive-search HPO with a selection-bias guard: trials after the
    exploratory phase are proposed by `TPESampler` (the reference's
    hyperopt-TPE dimension; ``search="random"``
    recovers pure random search), and `best_params_` stays None (the
    default config) unless a searched trial beats it by more than CV
    noise — see `guarded_selection`. The reference's TunedTabPFN has no
    such guard (raw hyperopt argmin); the divergence is deliberate."""

    def __init__(self, base_estimator=None, n_trials: int = 20,
                 metric: str = "roc_auc", n_splits: int = 3,
                 random_state: int = 0, verbose: bool = False,
                 search: str = "adaptive"):
        self.base_estimator = base_estimator
        self.n_trials = n_trials
        self.metric = metric
        self.n_splits = n_splits
        self.random_state = random_state
        self.verbose = verbose
        self.search = search

    def _make(self, trial: dict | None):
        return make_from_trial(self.base_estimator, trial)

    def _cv_scores(self, X, y, trial, seed):
        kf = StratifiedKFold(n_splits=self.n_splits, shuffle=True,
                             random_state=seed)
        scores = []
        for tr, vl in kf.split(X, y):
            est = self._make(trial).fit(X[tr], y[tr])
            scores.append(score_classification(
                self.metric, y[vl], est.predict_proba(X[vl])))
        return scores

    def fit(self, X, y):
        X = np.asarray(X, np.float32)
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        rng = np.random.default_rng(self.random_state)

        # trial None = the unmodified base config (with fit-time automatic
        # preprocessing): tuning must never end up worse than plain ICL
        if self.search == "random":
            proposer = None
        elif self.search == "adaptive":
            proposer = TPESampler(
                classifier_choice_space(len(X)),
                init_sampler=lambda r: default_search_space(r, len(X)),
                # scale the exploratory phase to the budget so small
                # n_trials (the benchmarks run 8) still get adaptive
                # proposals for the back half
                n_init=max(4, min(8, self.n_trials // 2)))
        else:
            raise ValueError(f"unknown search={self.search!r}")
        trials, fold_scores = [], []
        for t in range(1 + self.n_trials):
            if t == 0:
                trial = None
            elif proposer is None:
                trial = default_search_space(rng, len(X))
            else:
                # sequential ask -> score -> tell: each proposal sees every
                # previous trial's CV mean (the adaptivity random search
                # lacks)
                trial = dict(proposer.ask(rng))
                # nuisance seed drawn outside the modeled space
                trial["seed"] = int(rng.integers(0, 10_000))
            scores = self._cv_scores(X, y, trial, self.random_state)
            trials.append(trial)
            fold_scores.append(scores)
            if proposer is not None and trial is not None:
                proposer.tell(trial, float(np.nanmean(scores)))
            if self.verbose:
                print(f"[hpo] trial {t}: {trial} -> "
                      f"{float(np.nanmean(scores)):.4f}")

        pick, fresh = guarded_selection(
            trials, fold_scores,
            rescore=lambda tr, rep: self._cv_scores(
                X, y, tr, self.random_state + 1 + rep),
            sign=1.0, verbose=self.verbose, return_evidence=True)
        self.best_params_ = trials[pick]
        # report the fresh-fold mean when the guard re-scored: the
        # first-pass mean of an argmax-selected trial carries
        # winner's-curse bias (the very thing the guard corrects for)
        self.best_score_ = float(np.nanmean(
            fresh if fresh else fold_scores[pick]))
        self.best_estimator_ = self._make(trials[pick]).fit(X, y)
        return self

    def predict(self, X):
        return self.best_estimator_.predict(X)

    def predict_proba(self, X):
        return self.best_estimator_.predict_proba(X)
