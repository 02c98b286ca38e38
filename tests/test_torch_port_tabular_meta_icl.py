"""The tabular meta-estimators over the in-context networks against the JAX
package on the CPU, both packages on the same weights: one TINY classifier
and one TINY regressor meta-trained once by the port (module fixtures) and
given to both as `params`. TunedICLClassifier and TunedICLRegressor (the
same trials, the same guard decisions and `best_params_`), SeedEnsembleICL
(both averagings), AutoICLClassifier (the same greedy weights), ECOC over
the classifier beyond its class limit, the tree hybrids with in-context
leaves (host: sklearn's trees), and the Shapley values (exact and
Monte-Carlo), interactions and permutation importance of the classifier:
probabilities and predictions within the forward's tolerance."""

import re

import numpy as np
import pytest
from test_torch_port_support import cap_torch_threads

from multimodal_ad_tpu.tabular import ensembles as jens
from multimodal_ad_tpu.tabular import hpo as jhpo
from multimodal_ad_tpu.tabular import icl as jicl
from multimodal_ad_tpu.tabular import icl_regression as jicr
from multimodal_ad_tpu.tabular import interpretability as jint
from multimodal_ad_tpu.tabular import many_class as jmc
from multimodal_ad_tpu.tabular import regression as jreg
from multimodal_ad_tpu.tabular import rf_icl as jrf
from multimodal_ad_tpu_torch.tabular import ensembles as tens
from multimodal_ad_tpu_torch.tabular import hpo as thpo
from multimodal_ad_tpu_torch.tabular import icl as ticl
from multimodal_ad_tpu_torch.tabular import icl_regression as ticr
from multimodal_ad_tpu_torch.tabular import interpretability as tint
from multimodal_ad_tpu_torch.tabular import many_class as tmc
from multimodal_ad_tpu_torch.tabular import regression as treg
from multimodal_ad_tpu_torch.tabular import rf_icl as trf

cap_torch_threads()

TINY = dict(d_model=32, n_heads=2, n_layers=2, d_ff=64, max_features=12)
PROBA_TOL = 1e-5  # the forward's tolerance: fp32 sums in another order
REG_TOL = 1e-5  # predictions, relative to the target's spread


def clusters(n=200, f=5, k=2, sep=3.0, seed=0):
    """The JAX test suite's tests/test_tabular_ext.py::clusters."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, n)
    centers = rng.normal(size=(k, f)) * sep
    X = (centers[y] + rng.normal(size=(n, f))).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def clf_pair():
    """(JAX base, port base): ICLClassifier over one meta-trained TINY tree
    (150 steps of the host prior), no preprocessing, two views."""
    cfg_t = ticl.ICLConfig(max_classes=4, max_context=64, **TINY)
    params, _ = ticl.pretrain_icl(cfg_t, steps=150, batch=16, n_ctx=48, n_qry=16, lr=1e-3,
                                  seed=0, device="cpu")
    kw = dict(params=params, preprocess=None, n_estimators=2)
    return (jicl.ICLClassifier(cfg=jicl.ICLConfig(max_classes=4, max_context=64, **TINY), **kw),
            ticl.ICLClassifier(cfg=cfg_t, device="cpu", **kw))


@pytest.fixture(scope="module")
def reg_pair():
    cfg_t = ticr.RegICLConfig(max_context=64, n_bins=16, **TINY)
    params, _ = ticr.pretrain_icl_regression(cfg_t, steps=150, batch=16, n_ctx=48, n_qry=16,
                                             lr=1e-3, seed=0, device="cpu")
    kw = dict(params=params, preprocess=None, n_estimators=2)
    return (jreg.ICLRegressor(cfg=jicr.RegICLConfig(max_context=64, n_bins=16, **TINY), **kw),
            treg.ICLRegressor(cfg=cfg_t, device="cpu", **kw))


def _close(a, b, tol=PROBA_TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=tol)


def _trials(text):
    """The trials and guard lines a verbose TunedICLClassifier.fit printed,
    scores left out (they are compared numerically elsewhere)."""
    return ([re.sub(r" -> \S+$", "", ln) for ln in text.splitlines() if ln.startswith("[hpo] ")],
            [re.sub(r"advantage .*", "", ln) for ln in text.splitlines()
             if ln.startswith("[hpo guard]")])


@pytest.mark.parametrize("seed,sep,n_trials", [(5, 1.0, 4), (3, 2.5, 3)])
def test_tuned_classifier_equals_jax(clf_pair, capsys, seed, sep, n_trials):
    """The same trials (TPE after its exploratory draws), the same guard
    re-scores and pick, best_score_ within the forward's tolerance, and the
    refit estimator's probabilities."""
    X, y = clusters(n=150, f=6, sep=sep, seed=seed)
    out = []
    for base, mod in zip(clf_pair, (jhpo, thpo)):
        tuned = mod.TunedICLClassifier(base_estimator=base, n_trials=n_trials, n_splits=2,
                                       random_state=0, verbose=True).fit(X[:100], y[:100])
        out.append((tuned, _trials(capsys.readouterr().out)))
    (j, jlog), (t, tlog) = out
    assert tlog == jlog and len(tlog[0]) == n_trials + 1
    assert t.best_params_ == j.best_params_
    assert abs(t.best_score_ - j.best_score_) <= PROBA_TOL
    _close(t.predict_proba(X[100:]), j.predict_proba(X[100:]))
    np.testing.assert_array_equal(t.classes_, j.classes_)


def test_tuned_regressor_equals_jax(reg_pair):
    """TestTunedRegressor's task (n_trials 3, two folds) under RMSE and R²:
    the same best_params_, best_score_ and predictions."""
    rng = np.random.default_rng(7)
    X = rng.normal(size=(120, 4)).astype(np.float32)
    y = X @ np.array([1.0, -2.0, 0.5, 0.0]) + 0.1 * rng.normal(size=120)
    spread = float(y.max() - y.min())
    for metric in ("rmse", "r2"):
        j = jreg.TunedICLRegressor(base_estimator=reg_pair[0], n_trials=3, n_splits=2,
                                   metric=metric).fit(X[:90], y[:90])
        t = treg.TunedICLRegressor(base_estimator=reg_pair[1], n_trials=3, n_splits=2,
                                   metric=metric).fit(X[:90], y[:90])
        assert t.best_params_ == j.best_params_
        assert abs(t.best_score_ - j.best_score_) <= REG_TOL * spread
        _close(t.predict(X[90:]), j.predict(X[90:]), REG_TOL * spread)


def test_seed_ensembles_equal_jax(clf_pair):
    """Members' seeds and transforms, probabilities in both averagings and
    with diverse preprocessing."""
    X, y = clusters(n=120, f=5, sep=2.5, seed=9)
    for kw in (dict(n_members=3), dict(n_members=3, average_logits=True),
               dict(n_members=4, diverse_preprocess=True)):
        j = jhpo.SeedEnsembleICL(clf_pair[0], **kw).fit(X[:80], y[:80])
        t = thpo.SeedEnsembleICL(clf_pair[1], **kw).fit(X[:80], y[:80])
        assert ([(m.seed, m.preprocess) for m in t.members_]
                == [(m.seed, m.preprocess) for m in j.members_])
        p = t.predict_proba(X[80:])
        _close(p, j.predict_proba(X[80:]))
        np.testing.assert_allclose(p.sum(1), 1.0, rtol=1e-5)


def test_auto_ensemble_equals_jax(clf_pair):
    """The same configs, holdout, greedy weights and member weights, and the
    probabilities."""
    X, y = clusters(n=150, f=6, sep=1.5, seed=4)
    j = jens.AutoICLClassifier(base_estimator=clf_pair[0], n_configs=3).fit(X[:100], y[:100])
    t = tens.AutoICLClassifier(base_estimator=clf_pair[1], n_configs=3).fit(X[:100], y[:100])
    assert t.trials_ == j.trials_
    np.testing.assert_array_equal(t.ensemble_.weights_, j.ensemble_.weights_)
    np.testing.assert_array_equal(t.member_weights_, j.member_weights_)
    _close(t.predict_proba(X[100:]), j.predict_proba(X[100:]))
    assert (t.predict(X[100:]) == y[100:]).mean() > 0.8


def test_many_class_over_icl_equals_jax(clf_pair):
    """Six classes over a four-class network: ECOC with alphabet 4, the same
    codebook and probabilities."""
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(6, 5)) * 4
    y = rng.integers(0, 6, 160)
    X = (centers[y] + rng.normal(size=(160, 5))).astype(np.float32)
    j = jmc.ManyClassClassifier(clf_pair[0], alphabet_size=4).fit(X[:120], y[:120])
    t = tmc.ManyClassClassifier(clf_pair[1], alphabet_size=4).fit(X[:120], y[:120])
    assert t.code_book_.shape == (6, 4)
    np.testing.assert_array_equal(t.code_book_, j.code_book_)
    _close(t.predict_proba(X[120:]), j.predict_proba(X[120:]))
    with pytest.raises(ValueError, match="ManyClassClassifier"):
        clf_pair[1].fit(X, y)  # beyond the network's four classes


def test_tree_hybrids_with_icl_leaves_equal_jax(clf_pair, reg_pair):
    X, y = clusters(n=200, sep=2.0, seed=1)
    for cls_j, cls_t, kw in ((jrf.DecisionTreeICLClassifier, trf.DecisionTreeICLClassifier,
                              dict(max_depth=1, min_leaf_fit=20)),
                             (jrf.RandomForestICLClassifier, trf.RandomForestICLClassifier,
                              dict(n_estimators=2, max_depth=1, min_leaf_fit=20))):
        j = cls_j(clf_pair[0], **kw).fit(X[:140], y[:140])
        t = cls_t(clf_pair[1], **kw).fit(X[:140], y[:140])
        assert t.predict_proba(X[140:]).shape == (60, 2)
        _close(t.predict_proba(X[140:]), j.predict_proba(X[140:]))
    rng = np.random.default_rng(6)
    Xr = rng.normal(size=(160, 4)).astype(np.float32)
    yr = Xr[:, 0] * 2.0 - Xr[:, 1] + 0.1 * rng.normal(size=160)
    spread = float(yr.max() - yr.min())
    for cls_j, cls_t, kw in ((jreg.DecisionTreeICLRegressor, treg.DecisionTreeICLRegressor,
                              dict(max_depth=1, min_leaf_fit=20)),
                             (jreg.RandomForestICLRegressor, treg.RandomForestICLRegressor,
                              dict(n_estimators=2, max_depth=1, min_leaf_fit=20))):
        j = cls_j(reg_pair[0], **kw).fit(Xr[:120], yr[:120])
        t = cls_t(reg_pair[1], **kw).fit(Xr[:120], yr[:120])
        _close(t.predict(Xr[120:]), j.predict(Xr[120:]), REG_TOL * spread)


def test_shapley_of_the_classifier_equals_jax(clf_pair):
    """Exact Shapley values (2^6 coalitions a sample), Monte-Carlo values,
    interactions, marginal contributions and permutation importance of the
    fitted classifier: within the forward's tolerance; exact values satisfy
    efficiency."""
    X, y = clusters(n=120, f=6, sep=1.5, seed=2)
    j = clf_pair[0].__class__(**clf_pair[0].get_params()).fit(X[:80], y[:80])
    t = clf_pair[1].__class__(**clf_pair[1].get_params()).fit(X[:80], y[:80])
    rows, bg = X[80:83], X[:80]
    sv = tint.shapley_values(t, rows, background=bg)
    _close(sv, jint.shapley_values(j, rows, background=bg))
    full = t.predict_proba(rows)[:, 1]
    base = t.predict_proba(bg.mean(axis=0, keepdims=True))[0, 1]
    np.testing.assert_allclose(sv.sum(axis=1), full - base, rtol=0, atol=1e-5)
    mc = dict(n_draws=4, random_state=1, exact_max_features=0)
    _close(tint.shapley_values(t, rows, bg, **mc), jint.shapley_values(j, rows, bg, **mc))
    _close(tint.shapley_interaction_values(t, rows[:1], bg),
           jint.shapley_interaction_values(j, rows[:1], bg))
    _close(tint.marginal_contribution_values(t, rows, bg),
           jint.marginal_contribution_values(j, rows, bg))
    _close(tint.permutation_importance_values(t, X[80:], y[80:], n_repeats=2),
           jint.permutation_importance_values(j, X[80:], y[80:], n_repeats=2))
