"""The in-context networks and ICLClassifier against the JAX package on the
CPU: ICLTransformer and RegICLTransformer at a tiny config (d_model 32, 2
heads, 2 layers) on converted random flax weights, with and without the
categorical mask and with padded contexts, every output within 1e-5; the
full-width classifier asset on a 64-row bucket within 1e-4; ICLClassifier
with the bundled asset on small tables, one case per `preprocess`
(`preprocess_`, the width screen and the pairs selection equal,
`predict_proba` within 1e-5, `predict` equal, every `embedding_kind` within
1e-4), a table wider than the screen, a context subsample, the errors, and
the asset policy (the NotImplementedError where no asset applies)."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_ad_tpu.tabular import icl as jicl
from multimodal_ad_tpu.tabular import icl_regression as jreg
from multimodal_ad_tpu_torch.tabular import icl as ticl
from multimodal_ad_tpu_torch.tabular import icl_regression as treg
from multimodal_ad_tpu_torch.tabular.flax_msgpack import read_state
from multimodal_ad_tpu_torch.tabular.regression import ICLRegressor
from multimodal_ad_tpu_torch.utils.torch_weights import (icl_state_dict_from_flax,
                                                         reg_icl_state_dict_from_flax)

TINY = dict(d_model=32, n_heads=2, n_layers=2, d_ff=64, max_features=12)
NET_TOL = 1e-5  # fp32, the same products in another summation order
ASSET_TOL = 1e-4  # the full-width asset: 6 layers of d_model 256
PROBA_TOL = 1e-5
EMB_TOL = 1e-4


def _random_variables(model, rng, *args):
    """flax variables with every leaf random (the zero-init categorical
    projections included)."""
    v = model.init(jax.random.PRNGKey(0), *args)
    return jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * 0.3).astype(np.float32), v)


def _task(rng, b=3, n=20, m=7, f=12, classes=4):
    x_ctx = rng.normal(size=(b, n, f)).astype(np.float32)
    y_ctx = rng.integers(0, classes, (b, n)).astype(np.int32)
    mask = np.ones((b, n), np.float32)
    mask[1, 15:] = 0  # padded contexts
    mask[2, 4:] = 0
    x_ctx[mask == 0] = 0
    x_qry = rng.normal(size=(b, m, f)).astype(np.float32)
    cat = (rng.random((b, f)) < 0.3).astype(np.float32)
    return x_ctx, y_ctx, mask, x_qry, cat


@pytest.mark.parametrize("with_cat", [False, True])
def test_icl_transformer_matches_flax(with_cat):
    rng = np.random.default_rng(0)
    cfg_j = jicl.ICLConfig(max_classes=4, max_context=64, **TINY)
    cfg_t = ticl.ICLConfig(max_classes=4, max_context=64, **TINY)
    x_ctx, y_ctx, mask, x_qry, cat = _task(rng)
    jm = jicl.ICLTransformer(cfg_j)
    v = _random_variables(jm, rng, x_ctx, y_ctx, mask, x_qry, cat)
    tm = ticl.ICLTransformer(cfg_t).eval()
    tm.load_state_dict(icl_state_dict_from_flax(v, cfg_t))
    cm = cat if with_cat else None
    xc, xq = jicl._zscore_by_ctx(x_ctx, x_qry, mask)
    (logits, q, c), inter = jm.apply(v, xc, y_ctx, mask, xq, cm, mutable=["intermediates"])
    ref = (logits, q, c, inter["intermediates"]["h_penult"][0])
    t = [torch.from_numpy(a) for a in (x_ctx, y_ctx, mask, x_qry)]
    with torch.no_grad():
        txc, txq = ticl._zscore_by_ctx(t[0], t[3], t[2])
        np.testing.assert_allclose(txc.numpy(), np.asarray(xc), rtol=0, atol=NET_TOL)
        out = tm(txc, t[1], t[2], txq, None if cm is None else torch.from_numpy(cm),
                 return_penult=True)
        plain = tm(txc, t[1], t[2], txq, None if cm is None else torch.from_numpy(cm))
    assert len(plain) == 3  # the default forward does not return the tap
    for a, b in zip(out, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=NET_TOL)


def test_reg_icl_transformer_matches_flax():
    rng = np.random.default_rng(1)
    cfg_j = jreg.RegICLConfig(**TINY)
    cfg_t = treg.RegICLConfig(**TINY)
    x_ctx, _, mask, x_qry, _ = _task(rng)
    y = rng.normal(size=mask.shape).astype(np.float32) * 3 + 1
    jm = jreg.RegICLTransformer(cfg_j)
    v = _random_variables(jm, rng, x_ctx, y, mask, x_qry)
    tm = treg.RegICLTransformer(cfg_t).eval()
    tm.load_state_dict(reg_icl_state_dict_from_flax(v, cfg_t))
    zc, _, _ = jreg._zscore_y_by_ctx(jnp.asarray(y), jnp.asarray(mask))
    ref = jm.apply(v, x_ctx, np.asarray(zc), mask, x_qry)
    with torch.no_grad():
        tz, _, _ = treg._zscore_y_by_ctx(torch.from_numpy(y), torch.from_numpy(mask))
        np.testing.assert_allclose(tz.numpy(), np.asarray(zc), rtol=0, atol=NET_TOL)
        out = tm(torch.from_numpy(x_ctx), tz, torch.from_numpy(mask), torch.from_numpy(x_qry))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=NET_TOL)
    centers = treg.bin_centers(cfg_t)
    np.testing.assert_array_equal(centers, jreg.bin_centers(cfg_j))
    yq = np.linspace(-4, 4, 17).astype(np.float32)
    np.testing.assert_allclose(treg.soft_two_hot(yq, centers),
                               np.asarray(jreg.soft_two_hot(jnp.asarray(yq),
                                                            jnp.asarray(centers))),
                               rtol=0, atol=1e-6)


def test_full_width_classifier_asset_on_a_64_row_bucket():
    cfg = ticl.ICLConfig()
    tree = read_state(ticl.default_asset_path())
    params = jicl._load_params_file(jicl.ICLConfig(), jicl.default_asset_path())
    tm = ticl.ICLTransformer(cfg).eval()
    tm.load_state_dict(icl_state_dict_from_flax(tree, cfg))
    rng = np.random.default_rng(2)
    b, n, m, f = 2, 64, 16, cfg.max_features
    x_ctx = np.zeros((b, n, f), np.float32)
    x_ctx[:, :50, :30] = rng.normal(size=(b, 50, 30))
    y_ctx = rng.integers(0, 4, (b, n)).astype(np.int32)
    mask = np.zeros((b, n), np.float32)
    mask[:, :50] = 1
    x_qry = np.zeros((b, m, f), np.float32)
    x_qry[:, :, :30] = rng.normal(size=(b, m, 30))
    cat = np.zeros((b, f), np.float32)
    cat[:, [2, 5]] = 1
    xc, xq = jicl._zscore_by_ctx(x_ctx, x_qry, mask)
    (logits, q, c), inter = jicl.ICLTransformer(jicl.ICLConfig()).apply(
        params, xc, y_ctx, mask, xq, cat, mutable=["intermediates"])
    with torch.no_grad():
        txc, txq = ticl._zscore_by_ctx(torch.from_numpy(x_ctx), torch.from_numpy(x_qry),
                                       torch.from_numpy(mask))
        out = tm(txc, torch.from_numpy(y_ctx), torch.from_numpy(mask), txq,
                 torch.from_numpy(cat), return_penult=True)
    for a, r in zip(out, (logits, q, c, inter["intermediates"]["h_penult"][0])):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=0, atol=ASSET_TOL)


def test_converter_rejects_a_tree_that_does_not_fit_the_config():
    cfg = ticl.ICLConfig(**TINY)
    tree = read_state(ticl.default_asset_path())
    with pytest.raises(ValueError, match=r"array shape mismatch: \['params'\]"):
        icl_state_dict_from_flax(tree, ticl.ICLConfig(max_features=100))
    with pytest.raises(ValueError, match="tree structure mismatch"):
        icl_state_dict_from_flax(tree, cfg)
    reg = read_state(treg.default_reg_asset_path())
    with pytest.raises(ValueError, match="missing"):
        icl_state_dict_from_flax(reg, ticl.ICLConfig())


def _table(seed, n=60, f=12, classes=3):
    """A small mixed table: an informative column, an integer-coded
    categorical, a product interaction, NaN cells."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n + 20, f)).astype(np.float32)
    y = rng.integers(0, classes, n + 20)
    X[:, 0] += y
    X[:, 1] = rng.integers(0, 3, n + 20)
    X[:, 2] = X[:, 3] * X[:, 4] + 0.5 * y
    X[:n][rng.random((n, f)) < 0.05] = np.nan
    return X[:n], y[:n], X[n:]


def _pairs_choice(est):
    pre = getattr(est, "_pre", None)
    if pre is None or pre[0] != "pairs":
        return None
    return np.asarray(pre[2]).tolist(), np.asarray(pre[3]).tolist()


def _assert_same_classifier(j, t, Xt):
    assert t.preprocess_ == j.preprocess_
    js, ts = getattr(j, "_screen_idx_", None), getattr(t, "_screen_idx_", None)
    assert (js is None) == (ts is None)
    if js is not None:
        np.testing.assert_array_equal(ts, js)
    assert _pairs_choice(t) == _pairs_choice(j)
    np.testing.assert_allclose(t.predict_proba(Xt), j.predict_proba(Xt), rtol=0,
                               atol=PROBA_TOL)
    np.testing.assert_array_equal(t.predict(Xt), j.predict(Xt))


@pytest.mark.parametrize("preprocess", [None, "whiten", "quantile", "pairs", "onehot",
                                        "auto"])
def test_classifier_matches_jax(preprocess):
    X, y, Xt = _table(0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = jicl.ICLClassifier(preprocess=preprocess).fit(X, y)
        t = ticl.ICLClassifier(preprocess=preprocess, device="cpu").fit(X, y)
    _assert_same_classifier(j, t, Xt)
    if preprocess == "pairs":
        assert _pairs_choice(t)[0], "the pairs screen kept no product"
    for kind in ("rich", "rich2", "compact", "hidden"):
        j.embedding_kind = t.embedding_kind = kind
        a, b = t.get_embeddings(Xt), j.get_embeddings(Xt)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=EMB_TOL)


def test_classifier_width_screen_and_context_subsample_match_jax():
    rng = np.random.default_rng(3)
    X, y, Xt = _table(3, n=70, f=110)  # wider than the 96-column screen
    X[:, 50] = rng.integers(0, 4, 70)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for kw in ({"preprocess": None}, {"preprocess": "quantile", "context_size": 40},
                   {"preprocess": None, "screen_features": 20, "n_estimators": 3}):
            j = jicl.ICLClassifier(**kw).fit(X, y)
            t = ticl.ICLClassifier(device="cpu", **kw).fit(X, y)
            assert t._screen_idx_ is not None
            assert t._fitted["ctx_mask"].sum() == min(70, kw.get("context_size", 512))
            np.testing.assert_array_equal(t._fitted["y_ctx"], j._fitted["y_ctx"])
            _assert_same_classifier(j, t, Xt)


def test_classifier_errors_match_jax():
    X, y, Xt = _table(4, n=40)
    many = np.arange(40) % 11  # 11 classes > max_classes
    with pytest.raises(ValueError, match="classes > max_classes"):
        jicl.ICLClassifier(preprocess=None).fit(X, many)
    with pytest.raises(ValueError, match="classes > max_classes"):
        ticl.ICLClassifier(preprocess=None, device="cpu").fit(X, many)
    j = jicl.ICLClassifier(preprocess=None).fit(X, y)
    t = ticl.ICLClassifier(preprocess=None, device="cpu").fit(X, y)
    for est in (j, t):
        with pytest.raises(ValueError, match="features, but this estimator"):
            est.predict(Xt[:, :5])
    with pytest.raises(RuntimeError, match="fit"):
        ticl.ICLClassifier(device="cpu").predict_proba(Xt)
    with pytest.raises(ValueError, match="unknown embedding_kind"):
        t.set_params(embedding_kind="nope").get_embeddings(Xt)


def test_no_asset_raises_not_implemented(monkeypatch):
    """Where no asset applies and no params are given the port raises; the
    JAX package would meta-train here."""
    X, y, _ = _table(5, n=30)
    small = ticl.ICLConfig(**TINY)
    with pytest.raises(NotImplementedError, match="meta-training"):
        ticl.ICLClassifier(cfg=small, preprocess=None, device="cpu").fit(X[:, :12], y)
    with pytest.raises(NotImplementedError, match="meta-training"):
        ICLRegressor(cfg=treg.RegICLConfig(**TINY), preprocess=None,
                     device="cpu").fit(X, y.astype(float))
    assert ticl.load_default_params(small) is None
    monkeypatch.setenv("MAD_ICL_ASSET", "/nonexistent/asset.msgpack")
    with pytest.raises(FileNotFoundError, match="MAD_ICL_ASSET"):
        ticl.load_default_params(ticl.ICLConfig())
    monkeypatch.setenv("MAD_ICL_ASSET", treg.default_reg_asset_path())
    with pytest.raises(ValueError, match="does not match"):
        ticl.load_default_params(ticl.ICLConfig())


def test_explicit_params_and_one_network_per_asset_and_device():
    X, y, Xt = _table(6)
    tree = read_state(ticl.default_asset_path())
    a = ticl.ICLClassifier(preprocess=None, device="cpu").fit(X, y)
    b = ticl.ICLClassifier(preprocess="whiten", device="cpu").fit(X, y)
    assert a._network() is b._network()  # the bundled asset: one network
    c = ticl.ICLClassifier(params=tree, preprocess=None, device="cpu").fit(X, y)
    d = ticl.ICLClassifier(params=tree, preprocess=None, n_estimators=2,
                           device="cpu").fit(X, y)
    assert c._network() is d._network() and c._network() is not a._network()
    np.testing.assert_allclose(c.predict_proba(Xt), a.predict_proba(Xt), rtol=0, atol=1e-6)
