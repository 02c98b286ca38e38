"""The tabular meta-estimators' numpy parts against the JAX package on the
CPU: every scoring metric, degenerate and NaN cases included, to 1e-12
(the c-index on the JAX test's hand-computed cases); the splitters'
indices equal to sklearn's; TPE's proposals after the same `tell`s, the
guard's picks and evidence, ECOC codebooks and the greedy ensemble's
weights equal; Shapley values, interactions and attributions of the JAX
tests' analytic models to 1e-12; the tree hybrids, ECOC and the voting /
stacking factories over sklearn leaves equal; the unsupervised model's
impute / outliers / synthetic data / embeddings (its conditionals solved
without sklearn) against the JAX package's; the figures; `Experiment`; the
export surfaces; the context tensors of one view (F2, F3)."""

import os
import warnings

import numpy as np
import pytest
import torch
from sklearn import model_selection as skms
from sklearn.linear_model import LinearRegression, LogisticRegression
from test_torch_port_support import cap_torch_threads

import multimodal_ad_tpu.data as jdata
import multimodal_ad_tpu.models as jmodels
import multimodal_ad_tpu.tabular as jtab
import multimodal_ad_tpu.train as jtrain
import multimodal_ad_tpu_torch.data as tdata
import multimodal_ad_tpu_torch.models as tmodels
import multimodal_ad_tpu_torch.tabular as ttab
import multimodal_ad_tpu_torch.train as ttrain
from multimodal_ad_tpu.tabular import ensembles as jens
from multimodal_ad_tpu.tabular import hpo as jhpo
from multimodal_ad_tpu.tabular import interpretability as jint
from multimodal_ad_tpu.tabular import many_class as jmc
from multimodal_ad_tpu.tabular import regression as jreg
from multimodal_ad_tpu.tabular import rf_icl as jrf
from multimodal_ad_tpu.tabular import scoring as jsc
from multimodal_ad_tpu.tabular import unsupervised as jun
from multimodal_ad_tpu_torch.tabular import ensembles as tens
from multimodal_ad_tpu_torch.tabular import estimator as test_
from multimodal_ad_tpu_torch.tabular import hpo as thpo
from multimodal_ad_tpu_torch.tabular import icl as ticl
from multimodal_ad_tpu_torch.tabular import icl_regression as ticr
from multimodal_ad_tpu_torch.tabular import interpretability as tint
from multimodal_ad_tpu_torch.tabular import many_class as tmc
from multimodal_ad_tpu_torch.tabular import regression as treg
from multimodal_ad_tpu_torch.tabular import rf_icl as trf
from multimodal_ad_tpu_torch.tabular import scoring as tsc
from multimodal_ad_tpu_torch.tabular import unsupervised as tun

cap_torch_threads()

SCORE_TOL = 1e-12  # the same float64 sums; AUC by ranks against sklearn's trapezoids
EXACT_TOL = 1e-12  # the same numpy arithmetic on the same inputs
# the unsupervised model's conditionals: ridge by the same symmetric solve,
# the logistic model by scipy's L-BFGS-B on sklearn's objective and options
# (measured here: probabilities within 3e-16 of sklearn's, outputs 2e-13)
UNSUP_TOL = 1e-9

#: names of the JAX package's __all__ lists with no counterpart in the port
#: (README "Divergences"): jitted step factories and a flax apply helper
ABSENT = {"train": {"make_train_step", "make_eval_step"},
          "models": {"unet_forward_with_features"}}


def clusters(n=200, f=5, k=2, sep=3.0, seed=0):
    """The JAX test suite's tests/test_tabular_ext.py::clusters."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, n)
    centers = rng.normal(size=(k, f)) * sep
    X = (centers[y] + rng.normal(size=(n, f))).astype(np.float32)
    return X, y


def _same(a, b, tol=SCORE_TOL):
    if np.isnan(a):
        assert np.isnan(b), (a, b)
    else:
        assert abs(a - b) <= tol, (a, b)


def _call(fn, *args):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            return fn(*args)
        except ValueError:
            return "ValueError"


# ---- scoring -----------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_scoring_equals_jax(seed):
    """Random probabilities (float64 and float32, rounded to make ties,
    NaN rows, 2-4 classes, one class present, a missing column) through
    every classification metric, and every regression metric."""
    rng = np.random.default_rng(seed)
    for trial in range(25):
        k = int(rng.integers(2, 5))
        n = int(rng.integers(4, 40))
        y = rng.integers(0, k, n)
        p = rng.dirichlet(np.ones(k), n)
        if trial % 3 == 0:
            p = np.round(p, 1)
            p /= p.sum(1, keepdims=True)
        if trial % 4 == 1:
            p = p.astype(np.float32)
        if trial % 5 == 2:
            p[rng.integers(0, n)] = np.nan
        if trial % 7 == 3:
            y[:] = 1
        if trial % 11 == 4 and k > 2:
            p = p[:, :-1]
        for m in ("roc_auc", "accuracy", "balanced_accuracy", "f1", "log_loss"):
            a = _call(jsc.score_classification, m, y, p)
            b = _call(tsc.score_classification, m, y, p)
            if isinstance(a, str) or isinstance(b, str):
                assert a == b, (m, a, b)
            else:
                _same(a, b)
        _same(_call(jsc.safe_roc_auc_score, y, p[:, -1]),
              _call(tsc.safe_roc_auc_score, y, p[:, -1]))
        yt = rng.normal(size=n)
        yp = yt + 0.3 * rng.normal(size=n)
        if trial % 2:
            yt = yt.astype(np.float32)
        for m in ("rmse", "mse", "mae", "r2"):
            _same(jsc.score_regression(m, yt, yp), tsc.score_regression(m, yt, yp))
        _same(jsc.score_regression("r2", np.ones(n), np.ones(n)),
              tsc.score_regression("r2", np.ones(n), np.ones(n)))
        _same(jsc.score_regression("r2", np.ones(n), yp),
              tsc.score_regression("r2", np.ones(n), yp))


def test_scoring_cases_of_the_jax_tests():
    """tests/test_tabular_ext.py::TestScoring's cases, and the errors."""
    assert np.isnan(tsc.safe_roc_auc_score([1, 1, 1], [0.2, 0.3, 0.4]))
    assert tsc.safe_roc_auc_score([0, 1], [0.1, 0.9]) == 1.0
    assert tsc.safe_roc_auc_score([0, 1, 0, 1], [0.1, np.nan, 0.2, 0.9]) == 1.0
    p3 = np.array([[0.8, 0.1, 0.1], [0.1, 0.8, 0.1], [0.1, 0.1, 0.8]])
    assert tsc.safe_roc_auc_score([0, 1, 2], p3) == 1.0
    assert np.isnan(tsc.safe_roc_auc_score([0, 1, 2], p3 * 2))  # not probabilities
    p = np.array([[0.9, 0.1], [0.2, 0.8]])
    assert tsc.score_classification("accuracy", [0, 1], p) == 1.0
    assert tsc.score_classification("roc_auc", [0, 1], p) == 1.0
    assert tsc.score_classification("f1", [0, 1], [0, 1]) == 1.0
    for fn, bad in ((tsc.score_classification, "nope"), (tsc.score_regression, "nope"),
                    (tsc.score_survival, "nope")):
        with pytest.raises(ValueError):
            fn(bad, [0, 1], [0, 1])
    with pytest.raises(ValueError):
        tsc.score_classification("log_loss", [1, 1], p)  # one class
    with pytest.raises(ValueError):
        tsc.score_classification("log_loss", [0, 1], p * 2)  # above 1


@pytest.mark.parametrize("case", [
    ([1, 2, 3], [1, 2, 3], None), ([1, 2, 3], [3, 2, 1], None), ([1, 2, 3], [5, 5, 5], None),
    ([2, 4], [1, 2], [0, 1]), ([2, 4], [1, 2], [1, 0]), ([2, 4], [2, 1], [1, 0]),
    ([3, 3], [1, 2], [1, 0]), ([3, 3], [1, 2], [1, 1]),
    ([1, 3, 2, 4], [0.5, 1, 2, 3], [1, 1, 0, 0])])
def test_concordance_index_equals_jax(case):
    """The JAX test's hand-computed c-index cases (NaN where no pair is
    admissible), and the survival scorer on them."""
    a = jsc.concordance_index(*case)
    _same(a, tsc.concordance_index(*case))
    _same(a, tsc.score_survival("cindex", *case))


def test_concordance_index_random_censoring():
    rng = np.random.default_rng(3)
    t = rng.integers(1, 8, 60).astype(float)
    p = np.round(rng.normal(size=60), 1)
    e = rng.random(60) < 0.7
    _same(jsc.concordance_index(t, p, e), tsc.concordance_index(t, p, e))


# ---- splitters ----------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_splitters_equal_sklearn(seed):
    """StratifiedKFold (shuffled: the only form ported) and KFold (shuffled
    and not) yield sklearn's (train, test) index arrays, in its order; the
    errors too."""
    rng = np.random.default_rng(seed)
    for _ in range(10):
        n = int(rng.integers(8, 60))
        k = int(rng.integers(2, 5))
        y = rng.choice(np.array(["a", "b", "c"])[:int(rng.integers(2, 4))], n)
        for shuffle, rs in ((True, int(rng.integers(0, 1000))), (False, None)):
            if not shuffle:
                with pytest.raises(ValueError, match="shuffle=True"):
                    test_.StratifiedKFold(k, shuffle=False)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                ref = _call(lambda: list(skms.StratifiedKFold(
                    k, shuffle=True, random_state=rs or 0).split(np.zeros(n), y)))
                got = _call(lambda: list(test_.StratifiedKFold(
                    k, shuffle=True, random_state=rs or 0).split(np.zeros(n), y)))
            assert isinstance(ref, str) == isinstance(got, str)
            if not isinstance(ref, str):
                for (a, b), (c, d) in zip(ref, got, strict=True):
                    np.testing.assert_array_equal(a, c)
                    np.testing.assert_array_equal(b, d)
            ref = list(skms.KFold(k, shuffle=shuffle, random_state=rs).split(np.zeros(n)))
            got = list(test_.KFold(k, shuffle=shuffle, random_state=rs).split(np.zeros(n)))
            for (a, b), (c, d) in zip(ref, got, strict=True):
                np.testing.assert_array_equal(a, c)
                np.testing.assert_array_equal(b, d)
    for cls in (test_.KFold, test_.StratifiedKFold):
        with pytest.raises(ValueError):
            cls(3, shuffle=False, random_state=0)
        with pytest.raises(ValueError):
            cls(1)
    with pytest.warns(UserWarning):
        list(test_.StratifiedKFold(3, shuffle=True, random_state=0).split(
            np.zeros(7), [0, 0, 0, 0, 0, 1, 1]))


# ---- TPE and the guard -------------------------------------------------------

def _tpe_pair(n_init):
    space = {"preprocess": [None, "quantile", "whiten", "pairs"], "n_estimators": [1, 2, 4]}

    def init(rng):
        return {"preprocess": space["preprocess"][int(rng.integers(0, 4))],
                "n_estimators": int(rng.choice(space["n_estimators"])), "seed": 7}

    return (jhpo.TPESampler(space, init_sampler=init, n_init=n_init),
            thpo.TPESampler(space, init_sampler=init, n_init=n_init))


@pytest.mark.parametrize("seed,n_init", [(0, 6), (1, 5), (4, 3)])
def test_tpe_asks_equal_jax_after_the_same_tells(seed, n_init):
    """40 ask/tell rounds of the JAX test's hidden objective from one seed:
    every proposal equal; then the non-finite-scores case."""
    j, t = _tpe_pair(n_init)
    rj, rt, rs = (np.random.default_rng(seed) for _ in range(3))
    for _ in range(40):
        a, b = j.ask(rj), t.ask(rt)
        assert a == b
        score = (1.0 if a["preprocess"] == "quantile" else 0.0) + 0.05 * rs.normal()
        j.tell(a, score)
        t.tell(b, score)
    assert j.observations == t.observations
    j, t = _tpe_pair(4)
    for v in ("whiten", "whiten", "quantile", "quantile"):
        s = np.nan if v == "whiten" else 1.0
        j.tell({"preprocess": v, "n_estimators": 1}, s)
        t.tell({"preprocess": v, "n_estimators": 1}, s)
    rj, rt = np.random.default_rng(2), np.random.default_rng(2)
    assert [j.ask(rj) for _ in range(20)] == [t.ask(rt) for _ in range(20)]


def test_search_spaces_draw_equal_jax():
    for n_train in (30, 100, 700):
        rj, rt = np.random.default_rng(n_train), np.random.default_rng(n_train)
        for _ in range(30):
            assert jhpo.default_search_space(rj, n_train) == thpo.default_search_space(rt, n_train)
        assert jhpo.classifier_choice_space(n_train) == thpo.classifier_choice_space(n_train)


GUARD_CASES = [  # tests/test_tabular_ext.py::TestGuardedSelection's inputs
    ([[0.9, 0.9, 0.9], [0.7, 0.8, 0.6]], {None: [0.0], 1: [0.0]}, 1.0),
    ([[0.6, 0.6, 0.6], [0.9, 0.4, 0.62]], {None: [0.6, 0.6, 0.6], 1: [0.4, 0.9, 0.5]}, 1.0),
    ([[0.6, 0.6, 0.6], [0.9, 0.9, 0.9]], {None: [0.6, 0.6, 0.6], 1: [0.61, 0.59, 0.6]}, 1.0),
    ([[0.5, 0.5, 0.5], [0.8, 0.79, 0.81]], {None: [0.5, 0.5, 0.5], 1: [0.78, 0.82, 0.8]}, 1.0),
    ([[1.0, 1.0], [0.5, 0.52]], {None: [1.0, 1.0], 1: [0.5, 0.55]}, -1.0),
    ([[0.5, 0.5], [1.0, 1.0]], {None: [0.0], 1: [0.0]}, -1.0),
    ([[0.5, np.nan, 0.5], [0.8, 0.8, np.nan]], {None: [0.5, 0.5, 0.5], 1: [0.8, 0.8, 0.8]},
     1.0),
]


@pytest.mark.parametrize("case", range(len(GUARD_CASES) + 4))
def test_guarded_selection_equals_jax(case):
    """The JAX tests' guard inputs, and random ones with three trials and
    rep-dependent re-scores: the same pick, evidence and re-score calls."""
    if case < len(GUARD_CASES):
        scores, rescores, sign = GUARD_CASES[case]
        trials = [None, {"t": 1}]

        def rescore(tr, rep):
            return rescores[None if tr is None else 1]
    else:
        rng = np.random.default_rng(case)
        trials = [None, {"t": 1}, {"t": 2}]
        scores = [list(0.5 + 0.1 * rng.normal(size=3)) for _ in trials]
        table = {(i, r): list(0.5 + 0.05 * i + 0.05 * rng.normal(size=3))
                 for i in range(3) for r in range(2)}
        sign = 1.0

        def rescore(tr, rep):
            return table[(0 if tr is None else tr["t"], rep)]
    out = []
    for fn in (jhpo.guarded_selection, thpo.guarded_selection):
        calls = []

        def rec(tr, rep):
            calls.append((tr, rep))
            return rescore(tr, rep)
        res = fn(trials, scores, rescore=rec, sign=sign, return_evidence=True)
        out.append((res, calls, fn(trials, scores, rescore=rescore, sign=sign)))
    assert out[0] == out[1]


def test_make_from_trial_and_search_errors():
    base = ticl.ICLClassifier(preprocess=None, device="cpu")
    trial = {"softmax_temperature": 0.75, "context_size": 64, "seed": 5,
             "preprocess": "quantile", "n_ensemble": 2, "diverse_preprocess": False,
             "n_estimators": 2, "screen_features": 32}
    est = thpo.make_from_trial(base, trial)
    assert isinstance(est, thpo.SeedEnsembleICL) and est.n_members == 2
    b = est.base_estimator
    assert (b.softmax_temperature, b.context_size, b.seed, b.preprocess, b.n_estimators,
            b.screen_features, b.device) == (0.75, 64, 5, "quantile", 2, 32, "cpu")
    assert not isinstance(thpo.make_from_trial(base, {**trial, "n_ensemble": 1}),
                          thpo.SeedEnsembleICL)
    assert thpo.make_from_trial(base, None).get_params() == base.get_params()
    with pytest.raises(ValueError):
        thpo.TunedICLClassifier(search="bayes").fit(np.zeros((8, 2), np.float32),
                                                    np.arange(8) % 2)
    with pytest.raises(ValueError):
        treg.TunedICLRegressor(search="bayes").fit(np.zeros((8, 2), np.float32),
                                                   np.arange(8.0))


# ---- ECOC, the greedy ensemble ------------------------------------------------

@pytest.mark.parametrize("k,alphabet,n_cols,seed", [
    (7, 3, 4, 0), (14, 10, 4, 1), (26, 10, 5, 2), (5, 2, 6, 3), (40, 4, 8, 4)])
def test_ecoc_codebook_equals_jax(k, alphabet, n_cols, seed):
    a = jmc.ManyClassClassifier(alphabet_size=alphabet)._make_codebook(
        k, n_cols, np.random.default_rng(seed))
    b = tmc.ManyClassClassifier(alphabet_size=alphabet)._make_codebook(
        k, n_cols, np.random.default_rng(seed))
    np.testing.assert_array_equal(a, b)


def _many_class_data(k=7, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, 5)) * 4
    y = rng.integers(0, k, 300)
    return centers[y] + rng.normal(size=(300, 5)) * 0.3, y


def test_many_class_over_sklearn_equals_jax():
    """TestManyClass's data with a logistic base: the same codebook and
    probabilities (both fit sklearn's model on the same codes), the
    delegate path, and the errors."""
    X, y = _many_class_data()
    kw = dict(alphabet_size=3, random_state=0)
    j = jmc.ManyClassClassifier(LogisticRegression(max_iter=500), **kw).fit(X[:200], y[:200])
    t = tmc.ManyClassClassifier(LogisticRegression(max_iter=500), **kw).fit(X[:200], y[:200])
    np.testing.assert_array_equal(j.code_book_, t.code_book_)
    np.testing.assert_allclose(t.predict_proba(X[200:]), j.predict_proba(X[200:]),
                               rtol=0, atol=EXACT_TOL)
    assert (t.predict(X[200:]) == y[200:]).mean() > 0.8
    d = tmc.ManyClassClassifier(LogisticRegression(), alphabet_size=10).fit(X, y % 2)
    assert d.code_book_ is None and d.predict(X).shape == y.shape
    with pytest.raises(ValueError):
        tmc.ManyClassClassifier().fit(X, y)


@pytest.mark.parametrize("seed", range(4))
def test_greedy_ensemble_equals_jax(seed):
    """The JAX tests' good/bad pair and the all-NaN case, then random
    members under AUC, accuracy and log-loss: the same weights and score."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, 100)
    good = np.zeros((100, 2))
    good[np.arange(100), y] = 0.9
    good[np.arange(100), 1 - y] = 0.1
    members = [rng.dirichlet([1, 1], 100), good,
               0.5 * good + 0.5 * rng.dirichlet([1, 1], 100)]
    for metric, higher in (("roc_auc", True), ("accuracy", True), ("log_loss", False)):
        j = jens.GreedyWeightedEnsemble(metric, n_rounds=10, higher_is_better=higher)
        t = tens.GreedyWeightedEnsemble(metric, n_rounds=10, higher_is_better=higher)
        j.fit(members, y)
        t.fit(members, y)
        np.testing.assert_array_equal(j.weights_, t.weights_)
        _same(j.val_score_, t.val_score_)
        np.testing.assert_allclose(t.predict_proba(members), j.predict_proba(members),
                                   rtol=0, atol=EXACT_TOL)
    flat = np.tile([0.5, 0.5], (10, 1))
    t = tens.GreedyWeightedEnsemble("roc_auc", n_rounds=3).fit([flat, flat], np.ones(10, int))
    np.testing.assert_array_equal(t.weights_, [0.5, 0.5])


# ---- the tree hybrids over sklearn leaves (host) --------------------------------

def test_tree_hybrids_over_sklearn_equal_jax():
    """TestRFDT's and TestTreeRegressors' cases: the same bootstrap draws,
    trees and leaf models, so the same outputs."""
    X, y = clusters(n=240, sep=2.0)
    for cls_j, cls_t, kw in ((jrf.DecisionTreeICLClassifier, trf.DecisionTreeICLClassifier,
                              dict(max_depth=2)),
                             (jrf.RandomForestICLClassifier, trf.RandomForestICLClassifier,
                              dict(n_estimators=3, max_depth=2))):
        j = cls_j(LogisticRegression(max_iter=300), **kw).fit(X[:160], y[:160])
        t = cls_t(LogisticRegression(max_iter=300), **kw).fit(X[:160], y[:160])
        np.testing.assert_allclose(t.predict_proba(X[160:]), j.predict_proba(X[160:]),
                                   rtol=0, atol=EXACT_TOL)
        assert (t.predict(X[160:]) == y[160:]).mean() > 0.85
    t = trf.DecisionTreeICLClassifier(min_leaf_fit=100, max_depth=1).fit(X[:20], y[:20])
    assert not t.leaf_models_ and t.predict_proba(X[:20]).shape == (20, 2)
    rng = np.random.default_rng(5)
    Xr = rng.normal(size=(300, 4)).astype(np.float32)
    yr = Xr @ np.array([1.0, -2.0, 0.5, 0.0]) + 0.1 * rng.normal(size=300)
    for cls_j, cls_t, kw in ((jreg.DecisionTreeICLRegressor, treg.DecisionTreeICLRegressor,
                              dict(max_depth=2)),
                             (jreg.RandomForestICLRegressor, treg.RandomForestICLRegressor,
                              dict(n_estimators=3))):
        j = cls_j(LinearRegression(), **kw).fit(Xr[:200], yr[:200])
        t = cls_t(LinearRegression(), **kw).fit(Xr[:200], yr[:200])
        np.testing.assert_allclose(t.predict(Xr[200:]), j.predict(Xr[200:]),
                                   rtol=0, atol=EXACT_TOL)
    const = treg.DecisionTreeICLRegressor().fit(np.zeros((20, 2), np.float32), np.ones(20))
    np.testing.assert_array_equal(const.predict(np.zeros((3, 2), np.float32)), 1.0)


def test_voting_stacking_and_selection_take_the_port_estimators():
    """sklearn's meta-models and SequentialFeatureSelector over the port's
    ICLClassifier (a random TINY network on the CPU) and a logistic model."""
    cfg = ticl.ICLConfig(d_model=16, n_heads=2, n_layers=1, d_ff=32, max_features=8,
                         max_classes=3, max_context=64)
    icl = ticl.ICLClassifier(params=ticl.init_icl_params(cfg, seed=0), cfg=cfg,
                             preprocess=None, n_estimators=2, device="cpu")
    X, y = clusters(n=120, f=6, sep=2.5, seed=5)
    members = [("icl", icl), ("lr", LogisticRegression(max_iter=300))]
    vc = tens.make_voting_classifier(members).fit(X[:80], y[:80])
    assert (vc.predict(X[80:]) == y[80:]).mean() > 0.8
    sc = tens.make_stacking_classifier(members, cv=2).fit(X[:80], y[:80])
    assert (sc.predict(X[80:]) == y[80:]).mean() > 0.8
    rng = np.random.default_rng(0)
    ys = rng.integers(0, 2, 150)
    Xs = rng.normal(size=(150, 6)).astype(np.float32)
    Xs[:, 1] += 2.5 * ys
    Xs[:, 4] += 2.5 * ys
    support, _ = tint.feature_selection(LogisticRegression(max_iter=300), Xs, ys,
                                        n_features_to_select=2, cv=2)
    ref, _ = jint.feature_selection(LogisticRegression(max_iter=300), Xs, ys,
                                    n_features_to_select=2, cv=2)
    np.testing.assert_array_equal(support, ref)


# ---- interpretability on analytic models ---------------------------------------

class _FnEstimator:
    """tests/test_tabular_ext.py::_FnEstimator: predict_proba from p(x)."""

    def __init__(self, fn):
        self.fn = fn

    def predict_proba(self, X):
        p = np.clip(self.fn(np.asarray(X, np.float64)), 0.01, 0.99)
        return np.stack([1 - p, p], axis=1)


FNS = [lambda X: 0.5 + 0.04 * X[:, 0] - 0.03 * X[:, 2],
       lambda X: 0.5 + 0.05 * X[:, 0] * X[:, 1],
       lambda X: 0.5 + 0.04 * X[:, 0] * X[:, 1] + 0.03 * X[:, 2],
       lambda X: 0.5 + 0.2 * np.tanh(X[:, 0] * X[:, 3]) - 0.05 * X[:, 1] ** 2]


@pytest.mark.parametrize("fn", range(len(FNS)))
def test_shapley_on_analytic_models_equals_jax(fn):
    """Exact and Monte-Carlo Shapley values and interaction indices, with
    and without a background, and the coalition solver, to 1e-12."""
    est = _FnEstimator(FNS[fn])
    rng = np.random.default_rng(fn)
    X = rng.normal(size=(3, 5)).astype(np.float32)
    bg = rng.normal(size=(4, 5)).astype(np.float32)
    for kw in (dict(), dict(background=bg), dict(n_draws=8, exact_max_features=0),
               dict(n_draws=5, random_state=3, exact_max_features=0, background=bg)):
        np.testing.assert_allclose(tint.shapley_values(est, X, **kw),
                                   jint.shapley_values(est, X, **kw), rtol=0, atol=EXACT_TOL)
        np.testing.assert_allclose(tint.shapley_interaction_values(est, X, **kw),
                                   jint.shapley_interaction_values(est, X, **kw),
                                   rtol=0, atol=EXACT_TOL)
    ints, masks = tint._all_coalitions(5)
    v = rng.normal(size=32)
    np.testing.assert_allclose(tint._exact_shapley_from_coalitions(v, ints, masks, 5),
                               jint._exact_shapley_from_coalitions(v, ints, masks, 5),
                               rtol=0, atol=EXACT_TOL)
    np.testing.assert_allclose(tint.marginal_contribution_values(est, X, bg),
                               jint.marginal_contribution_values(est, X, bg),
                               rtol=0, atol=EXACT_TOL)
    with pytest.raises(ValueError):
        tint.shapley_interaction_values(est, X[:, :1])


def test_shapley_properties_of_the_jax_tests():
    """Efficiency of the Monte-Carlo estimator, zero interactions of an
    additive model, a localized bilinear interaction."""
    est = _FnEstimator(FNS[0])
    X = np.random.default_rng(3).normal(size=(3, 4)).astype(np.float32)
    bg = X.mean(axis=0)
    mc = tint.shapley_values(est, X, n_draws=8, exact_max_features=0)
    for si in range(3):
        ends = tint._coalition_values(est, X[si], bg, np.array([[False] * 4, [True] * 4]), 1)
        assert abs(mc[si].sum() - (ends[1] - ends[0])) < 1e-9
    np.testing.assert_allclose(mc, tint.shapley_values(est, X), atol=1e-9)
    est = _FnEstimator(FNS[1])
    sii = tint.shapley_interaction_values(est, np.full((1, 4), 2.0, np.float32),
                                          background=np.zeros((1, 4), np.float32))
    assert sii[0, 0, 1] == pytest.approx(0.2, abs=1e-9)
    assert abs(sii[0, 2, 3]) < 1e-9 and abs(sii[0, 0, 2]) < 1e-9


def test_permutation_importance_equals_jax():
    rng = np.random.default_rng(0)
    y = rng.integers(0, 2, 300)
    X = rng.normal(size=(300, 4)).astype(np.float32)
    X[:, 2] += 3.0 * y
    clf = LogisticRegression(max_iter=300).fit(X, y)
    for metric in ("roc_auc", "accuracy", "log_loss"):
        a = jint.permutation_importance_values(clf, X, y, metric=metric, n_repeats=3)
        b = tint.permutation_importance_values(clf, X, y, metric=metric, n_repeats=3)
        np.testing.assert_allclose(b, a, rtol=0, atol=SCORE_TOL)
        assert np.abs(b).argmax() == 2  # a loss rises where a score falls


# ---- the unsupervised model ---------------------------------------------------

@pytest.fixture(scope="module")
def unsupervised_pair():
    """TestUnsupervised's table with a binary and a 3-level integer column,
    so both conditionals (ridge and logistic) run."""
    X, _ = clusters(n=300, f=6, sep=2.0, seed=2)
    X = X.astype(np.float64)
    X[:, 3] = X[:, 0] * 2.0 + 0.1 * np.random.default_rng(0).normal(size=300)
    X[:, 4] = (X[:, 1] > 0).astype(float)
    X[:, 5] = np.digitize(X[:, 2], [-1.0, 1.0]).astype(float)
    return (jun.TabularUnsupervisedModel(n_permutations=3).fit(X),
            tun.TabularUnsupervisedModel(n_permutations=3).fit(X), X)


def test_unsupervised_conditionals_equal_sklearn(unsupervised_pair):
    j, t, X = unsupervised_pair
    assert t.categorical_ == j.categorical_ == [False] * 4 + [True, True]
    for perm, pt, cj, ct in zip(j.permutations_, t.permutations_, j.conditionals_,
                                t.conditionals_, strict=True):
        np.testing.assert_array_equal(perm, pt)
        for k, (a, b) in enumerate(zip(cj, ct)):
            Xo = X[:, perm[:k]] if k else np.zeros((len(X), 1))
            if a.categorical:
                np.testing.assert_allclose(b.model.predict_proba(Xo),
                                           a.model.predict_proba(Xo), rtol=0, atol=UNSUP_TOL)
            else:
                np.testing.assert_allclose(b.model.predict(Xo), a.model.predict(Xo),
                                           rtol=0, atol=UNSUP_TOL)
                assert abs(a.sigma_ - b.sigma_) <= UNSUP_TOL


def test_unsupervised_outputs_equal_jax(unsupervised_pair):
    j, t, X = unsupervised_pair
    Xm = X[:50].copy()
    truth = Xm[:, 3].copy()
    Xm[:, 3] = np.nan
    Xm[:10, 5] = np.nan
    filled = t.impute(Xm)
    np.testing.assert_allclose(filled, j.impute(Xm), rtol=0, atol=UNSUP_TOL)
    np.testing.assert_array_equal(filled[:, :3], Xm[:, :3])
    assert np.abs(filled[:, 3] - truth).mean() < 0.5 * np.abs(X[:, 3].mean() - truth).mean()
    weird = X[:20] + 15.0
    for rows in (X[:20], weird):
        a, b = j.outliers(rows), t.outliers(rows)
        np.testing.assert_allclose(b, a, rtol=UNSUP_TOL, atol=UNSUP_TOL)
    assert t.outliers(weird).mean() > t.outliers(X[:20]).mean() + 1.0
    np.testing.assert_allclose(t.generate_synthetic_data(80), j.generate_synthetic_data(80),
                               rtol=0, atol=UNSUP_TOL)
    emb = t.get_embeddings(X[:10])
    assert emb.shape == (10, X.shape[1] * 3)
    np.testing.assert_allclose(emb, j.get_embeddings(X[:10]), rtol=0, atol=UNSUP_TOL)
    with pytest.raises(ValueError):
        t.impute(X[:, :3])
    with pytest.raises(ValueError):
        tun.TabularUnsupervisedModel().fit(np.full((3, 2), np.nan))


# ---- figures and the experiment harness ----------------------------------------

def test_figures_write_pngs_like_jax(tmp_path):
    """TestPlottingFacade's calls: PNGs written, the same panels, titles and
    the same interactor picked as the JAX package's figures."""
    from multimodal_ad_tpu.tabular import plotting as jplot
    from multimodal_ad_tpu_torch.tabular import plotting as tplot

    rng = np.random.default_rng(1)
    X = rng.normal(size=(40, 4))
    vals = np.zeros((40, 4))
    vals[:, 0] = X[:, 2] * 0.3
    sii = rng.normal(size=(3, 5, 5))
    sii = sii + sii.transpose(0, 2, 1)
    calls = [("plot_attributions", (rng.normal(size=(20, 6)),),
              dict(X=rng.normal(size=(20, 6)), feature_names=[f"f{j}" for j in range(6)])),
             ("plot_attribution_scatter", (vals, X), {}),
             ("plot_interactions", (sii,), {}), ("plot_interactions", (sii,), dict(sample=1))]
    titles = []
    for i, (name, args, kw) in enumerate(calls):
        out = tmp_path / f"{i}.png"
        ft = getattr(tplot, name)(*args, out=str(out), **kw)
        fj = getattr(jplot, name)(*args, **kw)
        assert out.exists() and out.stat().st_size > 1000
        titles.append([a.get_title() for a in ft.axes])
        assert titles[-1] == [a.get_title() for a in fj.axes]
    assert len(titles[0]) >= 2 and "x2" in titles[1][0]  # colored by its interactor
    with pytest.raises(ValueError):
        tplot.plot_attributions(np.zeros((2, 3)), feature_names=["a"])


def test_experiment_seeds_numpy_and_torch(tmp_path):
    from multimodal_ad_tpu_torch.tabular.benchmarking import Experiment

    class Demo(Experiment):
        name = "demo"

        def run_experiment(self, x=2):
            return {"acc": float(np.random.rand()), "t": float(torch.rand(1)), "x": x}

    e1 = Demo(seed=7, output_dir=str(tmp_path))
    r1 = e1.run(x=3)
    r2 = Demo(seed=7, output_dir=str(tmp_path)).run(x=3)
    assert (r1["acc"], r1["t"]) == (r2["acc"], r2["t"]) and r1["x"] == 3
    assert "wall_time_s" in r1 and r1["seed"] == 7
    assert os.path.getsize(e1.save()) > 10
    assert os.path.getsize(e1.plot()) > 500
    with pytest.raises(RuntimeError):
        Demo(output_dir=str(tmp_path)).save()


# ---- the surfaces, and F2 -------------------------------------------------------

@pytest.mark.parametrize("pkg", ["tabular", "models", "train", "data"])
def test_every_jax_export_has_a_counterpart(pkg):
    jax_pkg, port_pkg = {"tabular": (jtab, ttab), "models": (jmodels, tmodels),
                         "train": (jtrain, ttrain), "data": (jdata, tdata)}[pkg]
    absent = ABSENT.get(pkg, set())
    missing = [n for n in jax_pkg.__all__ if n not in absent and not hasattr(port_pkg, n)]
    assert not missing, missing
    assert set(port_pkg.__all__) >= set(jax_pkg.__all__) - absent
    assert all(hasattr(port_pkg, n) for n in port_pkg.__all__)
    assert not absent & set(port_pkg.__all__)


def test_aliases_and_factories():
    assert ttab.TunedTabPFNClassifier is ttab.TunedICLClassifier
    assert ttab.AutoTabPFNClassifier is ttab.AutoICLClassifier
    assert ttab.RandomForestTabPFNRegressor is ttab.RandomForestICLRegressor
    assert ttab.TabPFNUnsupervisedModel is ttab.TabularUnsupervisedModel
    from multimodal_ad_tpu_torch.tabular.interpretability import shapley_values

    assert shapley_values is tint.shapley_values
    for depth in (10, 18, 34, 50, 101, 152, 200):
        make = getattr(tmodels, f"resnet{depth}")
        assert make.__name__ == f"resnet{depth}"
    net = tmodels.resnet10(num_classes=3, head="pool")
    assert (net.depth, net.head) == (10, "pool")


def test_context_arrays_are_copies_with_one_view():
    """F2 (ICLClassifier) and F3 (ICLRegressor): with n_estimators=1 the
    context tensors own their memory: they do not alias the fitted arrays,
    and building them raises no warning."""
    cfg = ticl.ICLConfig(d_model=16, n_heads=2, n_layers=1, d_ff=32, max_features=8,
                         max_classes=3, max_context=64)
    rcfg = ticr.RegICLConfig(d_model=16, n_heads=2, n_layers=1, d_ff=32, max_features=8,
                             max_context=64, n_bins=8)
    X, y = clusters(n=40, f=4, seed=1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        clf = ticl.ICLClassifier(params=ticl.init_icl_params(cfg, seed=0), cfg=cfg,
                                 preprocess=None, n_estimators=1, device="cpu").fit(X, y)
        p = clf.predict_proba(X[:5])
        reg = treg.ICLRegressor(params=ticr.init_reg_icl_params(rcfg, seed=0), cfg=rcfg,
                                preprocess=None, n_estimators=1, device="cpu").fit(X, X[:, 0])
        r = reg.predict(X[:5])
    assert p.shape == (5, 2) and np.isfinite(p).all()
    assert r.shape == (5,) and np.isfinite(r).all()
    for est, views in ((clf, {2: "ctx_mask"}), (reg, {1: "y_ctx", 2: "ctx_mask"})):
        for i, key in views.items():
            t = est._views_dev[i]
            assert t.shape == (1, est._fitted[key].shape[1])
            assert not np.shares_memory(t.numpy(), est._fitted[key])
            before = est._fitted[key].copy()
            t.zero_()
            np.testing.assert_array_equal(est._fitted[key], before)


def _load(path, name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_quality_script_families_equal_the_jax_benchmarks():
    """scripts/icl_quality_port.py's copies of the six generators draw what
    benchmarks/icl_quality.py's draw, and it reads the JAX figures."""
    port = _load("scripts/icl_quality_port.py", "icl_quality_port")
    ref = _load("benchmarks/icl_quality.py", "icl_quality")
    assert list(port.FAMILIES) == list(ref.FAMILIES) and port.N == ref.N
    assert port.SEEDS == ref.SEEDS
    for fam in ref.FAMILIES:
        for seed in ref.SEEDS:
            a = ref.FAMILIES[fam](np.random.default_rng(seed))
            b = port.FAMILIES[fam](np.random.default_rng(seed))
            for u, v in zip(a, b, strict=True):
                assert u.dtype == v.dtype
                np.testing.assert_array_equal(u, v)
    figures = port.jax_figures()
    assert set(figures) == set(ref.FAMILIES)
    assert figures["cluster"]["ICL"] == (0.922, 0.977)
    assert "AutoICL" not in figures["many-class-6"]
