"""The tabular slice's host parts against their references: the msgpack
reader against flax on the three bundled assets (every leaf bit-equal in
dtype and value) and the port's asset copies byte-identical to the JAX
package's; the csv-module table loaders and `make_table` against the JAX
package's pandas ones; `estimator.py` against sklearn (f_classif,
f_regression and QuantileTransformer within 1e-6, the splits' indices
equal, the estimator protocol); the tabular utils against the JAX
package's."""

import hashlib
import os
import warnings

import numpy as np
import pandas as pd
import pytest
from flax import serialization
from sklearn import feature_selection as skfs
from sklearn import model_selection as skms
from sklearn import preprocessing as skpre

from multimodal_ad_tpu.data import tabular as jtab
from multimodal_ad_tpu.data.synthetic import make_table as jax_make_table
from multimodal_ad_tpu.tabular import utils as jutils
from multimodal_ad_tpu_torch.data import tabular as ttab
from multimodal_ad_tpu_torch.data.synthetic import make_table
from multimodal_ad_tpu_torch.tabular import estimator as est
from multimodal_ad_tpu_torch.tabular import utils as tutils
from multimodal_ad_tpu_torch.tabular.flax_msgpack import read_state, tree_leaves, unpackb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = {"icl_default": (107, 4_892_426), "icl_embedder": (107, 4_892_426),
          "icl_regression_default": (105, 4_797_472)}
TOL = 1e-6  # the sklearn replacements compute what sklearn computes


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("name", sorted(ASSETS))
def test_reader_equals_flax_on_the_bundled_assets(name):
    path = os.path.join(REPO, "multimodal_ad_tpu_torch", "assets", f"{name}.msgpack")
    jax_path = os.path.join(REPO, "multimodal_ad_tpu", "assets", f"{name}.msgpack")
    assert _sha(path) == _sha(jax_path)  # a byte-identical copy
    ours = tree_leaves(read_state(path))
    with open(path, "rb") as f:
        ref = tree_leaves(serialization.msgpack_restore(f.read()))
    assert [p for p, _ in ours] == [p for p, _ in ref]
    for (p, a), (_, b) in zip(ours, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, p
        assert a.tobytes() == b.tobytes(), p
    leaves, n_params = ASSETS[name]
    assert len(ours) == leaves and sum(a.size for _, a in ours) == n_params


def test_reader_equals_flax_on_other_types():
    tree = {"scalar": np.float32(1.5), "i64": np.arange(6, dtype=np.int64).reshape(2, 3),
            "u8": np.array([0, 255], np.uint8), "f64": np.linspace(0, 1, 7),
            "b": np.array([True, False]), "empty": np.zeros((0, 3), np.float16),
            "nested": {"ints": [0, 1, -1, -33, 127, 128, 300, -300, 70000, -70000,
                                2 ** 40, -2 ** 40, 2 ** 63], "text": "ß" * 40,
                       "flags": [True, False, None], "float": 2.5,
                       "complex": 1.5 - 2j, "bytes": b"\x00\x01" * 200}}
    data = serialization.msgpack_serialize(tree)
    ours = unpackb(data)
    ref = serialization.msgpack_restore(data)
    for (p, a), (q, b) in zip(tree_leaves(ours), tree_leaves(ref)):
        assert p == q
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), p
        else:
            assert a == b and type(a) is type(b), p


@pytest.mark.parametrize("data,match", [
    (b"\xc1", "0xc1"),
    (b"\xd4\x07\x00", "extension type 7"),
    (b"\x81\xa1a\x01\x00", "bytes left"),
    (b"\x92\x01", "ends"),
])
def test_reader_raises_on_what_it_does_not_know(data, match):
    with pytest.raises(ValueError, match=match):
        unpackb(data)


def test_reader_raises_on_bfloat16_and_chunked_leaves():
    import msgpack

    payload = msgpack.packb(((2,), "bfloat16", b"\x00" * 4), use_bin_type=True)
    with pytest.raises(ValueError, match="bfloat16"):
        unpackb(msgpack.packb(msgpack.ExtType(1, payload)))
    chunked = msgpack.packb({"w": {"__msgpack_chunked_array__": True, "shape": [2]}})
    with pytest.raises(ValueError, match="chunked"):
        unpackb(chunked)


@pytest.fixture(scope="module")
def table_csv(tmp_path_factory):
    """make_table with blanks in numeric columns, a string column with
    missing cells and a numeric column that is all blank."""
    df = jax_make_table(n=70, classes=("CN", "MCI", "AD", "SMCI", "PMCI"), seed=5)
    rng = np.random.default_rng(5)
    df.loc[rng.random(70) < 0.2, "feat3"] = np.nan
    df.loc[rng.random(70) < 0.95, "feat5"] = np.nan
    df.loc[rng.random(70) < 0.3, "cat1"] = None
    df["feat7"] = np.nan
    path = str(tmp_path_factory.mktemp("tab") / "table.csv")
    df.to_csv(path, index=False)
    return path


@pytest.mark.parametrize("loader,kw", [
    ("load_adni_data_binary", {}),
    ("load_adni_data_binary", {"class0": "AD", "class1": "PMCI"}),
    ("load_adni_data_triclass", {}),
    ("load_adni_data_quadclass", {}),
    ("load_adni_table", {"classes": ["SMCI", "CN", "AD"]}),
])
def test_loaders_equal_the_jax_loaders(table_csv, loader, kw):
    a = getattr(jtab, loader)(table_csv, start_col=14, **kw)
    b = getattr(ttab, loader)(table_csv, start_col=14, **kw)
    assert len(a) == len(b)
    assert a[0].dtype == b[0].dtype == np.float32
    np.testing.assert_array_equal(a[0], b[0])  # NaN in the same cells
    assert a[1].dtype == b[1].dtype == np.int64
    np.testing.assert_array_equal(a[1], b[1])
    if len(a) == 3:
        assert a[2] == b[2]


def test_loader_errors_equal_the_jax_loaders(table_csv):
    for kw, match in (({"start_col": 40}, "fewer than"),
                      ({"label_col": "Nope"}, "Missing column"),
                      ({"classes": ["XX"]}, "No samples")):
        args = dict(start_col=14, label_col="Group", classes=["CN"])
        args.update(kw)
        with pytest.raises(ValueError, match=match):
            jtab.load_adni_table(table_csv, **args)
        with pytest.raises(ValueError, match=match):
            ttab.load_adni_table(table_csv, **args)


def test_make_table_equals_the_jax_one_and_writes_pandas_bytes(tmp_path):
    kw = dict(n=40, n_features=9, classes=("CN", "SMCI", "PMCI", "AD"), seed=2,
              n_categorical=2)
    df = jax_make_table(**kw)
    cols = make_table(**kw)
    assert list(cols) == list(df.columns)
    for c in df.columns:
        np.testing.assert_array_equal(np.asarray(cols[c]), df[c].to_numpy())
    df.to_csv(tmp_path / "pandas.csv", index=False)
    assert make_table(**kw, path=str(tmp_path / "port.csv")) == str(tmp_path / "port.csv")
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "pandas.csv").read_bytes()


def test_write_table_float_text_equals_pandas(tmp_path):
    rng = np.random.default_rng(0)
    cols = {"f32": (rng.normal(size=200) * 10.0 ** rng.integers(-9, 9, 200)).astype(np.float32),
            "f64": rng.normal(size=200) * 10.0 ** rng.integers(-20, 20, 200),
            "i": rng.integers(-5, 5, 200)}
    cols["f32"][::7] = np.nan
    pd.DataFrame(cols).to_csv(tmp_path / "a.csv", index=False)
    ttab.write_table(str(tmp_path / "b.csv"), cols)
    assert (tmp_path / "a.csv").read_bytes() == (tmp_path / "b.csv").read_bytes()


def test_read_table_infers_types_as_pandas(tmp_path):
    path = tmp_path / "t.csv"
    path.write_text("a,b,c,d,e,f\n"
                    "1,x,,1.5,NA,True\n"
                    "2,,,n/a,1e3,False\n"
                    "NaN,y,,-inf,zz,True\n"
                    "4,x,,3,2,\n")
    names, cols = ttab.read_table(str(path))
    df = pd.read_csv(path)
    assert names == list(df.columns)
    for c in names:
        dt = df[c].dtype
        if dt == object or str(dt) in ("str", "category"):
            np.testing.assert_array_equal(ttab.category_codes(cols[c]),
                                          pd.Categorical(df[c]).codes)
        else:
            np.testing.assert_array_equal(cols[c].astype(np.float32),
                                          df[c].astype("float32").to_numpy())


def _screen_cases():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(90, 7)).astype(np.float32)
    ties = rng.integers(0, 3, (50, 5)).astype(np.float32)  # many ties
    const = X[:30].copy()
    const[:, 2] = 4.0  # a constant column
    small = rng.normal(size=(12, 4)).astype(np.float32)  # n < 64
    wide64 = rng.normal(size=(80, 6))  # float64 input
    return {"float32": X, "ties": ties, "constant": const, "n<64": small,
            "float64": wide64}


@pytest.mark.parametrize("case", sorted(_screen_cases()))
def test_f_classif_equals_sklearn(case):
    X = _screen_cases()[case]
    y = np.random.default_rng(1).integers(0, 3, len(X))
    y[:3] = [0, 1, 2]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours = est.f_classif(X, y)
        ref = skfs.f_classif(X, y)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, equal_nan=True)
    labels = np.array(["CN", "AD", "MCI"])[y]  # string labels
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        np.testing.assert_allclose(est.f_classif(X, labels)[0], skfs.f_classif(X, labels)[0],
                                   rtol=TOL, atol=TOL, equal_nan=True)


@pytest.mark.parametrize("case", sorted(_screen_cases()))
def test_f_regression_equals_sklearn(case):
    X = _screen_cases()[case]
    rng = np.random.default_rng(2)
    y = X[:, 0].astype(np.float64) * 2 + rng.normal(size=len(X))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours = est.f_regression(X, y)
        ref = skfs.f_regression(X, y)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    X2 = X.copy()
    X2[:, 1] = y  # a perfect correlation: F = float64 max
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        np.testing.assert_array_equal(est.f_regression(X2, y)[0], skfs.f_regression(X2, y)[0])


@pytest.mark.parametrize("case", sorted(_screen_cases()))
@pytest.mark.parametrize("n_quantiles", ["min(64, n)", 5])
def test_quantile_transformer_equals_sklearn(case, n_quantiles):
    X = _screen_cases()[case]
    rng = np.random.default_rng(3)
    X_new = (X[:10] + rng.normal(size=X[:10].shape) * 3).astype(X.dtype)  # out of range too
    X_new[0, 0] = np.nan
    nq = min(64, len(X)) if n_quantiles == "min(64, n)" else n_quantiles
    kw = dict(n_quantiles=nq, output_distribution="normal", random_state=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours = est.QuantileTransformer(**kw).fit(X)
        ref = skpre.QuantileTransformer(**kw).fit(X)
    np.testing.assert_array_equal(ours.quantiles_, ref.quantiles_)
    for data in (X, X_new):
        a, b = ours.transform(data), ref.transform(data)
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, equal_nan=True)


def test_quantile_transformer_subsample_equals_sklearn():
    X = np.random.default_rng(4).normal(size=(300, 3)).astype(np.float32)
    kw = dict(n_quantiles=40, output_distribution="normal", subsample=100, random_state=7)
    ours = est.QuantileTransformer(**kw).fit(X)
    ref = skpre.QuantileTransformer(**kw).fit(X)
    np.testing.assert_array_equal(ours.quantiles_, ref.quantiles_)
    np.testing.assert_allclose(ours.transform(X), ref.transform(X), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n,test_size,seed", [(60, 0.25, 0), (61, 0.3, 42), (25, 7, 3)])
def test_train_test_split_equals_sklearn(n, test_size, seed):
    rng = np.random.default_rng(n)
    X = rng.normal(size=(n, 3))
    y = rng.integers(0, 3, n)
    names = np.array([f"s{i}" for i in range(n)], dtype=object)
    ours = est.train_test_split(X, y, names, test_size=test_size, random_state=seed)
    ref = skms.train_test_split(X, y, names, test_size=test_size, random_state=seed)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    ours = est.train_test_split(X, y, test_size=test_size, random_state=seed, stratify=y)
    ref = skms.train_test_split(X, y, test_size=test_size, random_state=seed, stratify=y)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    labels = np.array(["CN", "AD", "MCI"], dtype=object)[y]  # string strata
    ours = est.train_test_split(X, labels, test_size=test_size, random_state=seed,
                                stratify=labels)
    ref = skms.train_test_split(X, labels, test_size=test_size, random_state=seed,
                                stratify=labels)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


def test_stratified_split_raises_on_a_class_of_one_as_sklearn():
    y = np.array([0] * 10 + [1] * 10 + [2])
    idx = np.arange(len(y))
    with pytest.raises(ValueError):
        skms.train_test_split(idx, test_size=0.25, random_state=0, stratify=y)
    with pytest.raises(ValueError):
        est.train_test_split(idx, test_size=0.25, random_state=0, stratify=y)


@pytest.mark.parametrize("n,k", [(10, 2), (23, 5), (464, 5), (7, 7)])
def test_kfold_equals_sklearn(n, k):
    X = np.zeros((n, 2))
    ours = list(est.KFold(n_splits=k, shuffle=False).split(X))
    ref = list(skms.KFold(n_splits=k, shuffle=False).split(X))
    assert len(ours) == len(ref) == k
    for (a, b), (c, d) in zip(ours, ref):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    with pytest.raises(ValueError):
        list(est.KFold(n_splits=n + 1).split(X))


class _Inner(est.BaseEstimator):
    def __init__(self, alpha=1.0, tags=None):
        self.alpha = alpha
        self.tags = tags


class _Outer(est.ClassifierMixin, est.BaseEstimator):
    def __init__(self, inner=None, k=3, weights=None):
        self.inner = inner
        self.k = k
        self.weights = weights


def test_estimator_protocol_round_trips():
    from multimodal_ad_tpu_torch.tabular.icl import ICLClassifier
    from multimodal_ad_tpu_torch.tabular.regression import ICLRegressor

    clf = ICLClassifier(seed=3, preprocess="whiten", n_estimators=2, device="cpu")
    params = clf.get_params()
    assert params["seed"] == 3 and params["device"] == "cpu"
    assert sorted(params) == sorted(
        ["params", "cfg", "pretrain_steps", "seed", "softmax_temperature",
         "context_size", "preprocess", "n_estimators", "screen_features",
         "embedding_kind", "device"])
    copy = est.clone(clf)
    assert copy is not clf and copy.get_params() == params
    assert copy.set_params(seed=5, context_size=40) is copy
    assert (copy.seed, copy.context_size, clf.seed) == (5, 40, 3)
    with pytest.raises(ValueError, match="Invalid parameter"):
        copy.set_params(nope=1)
    outer = _Outer(inner=_Inner(alpha=2.0, tags=[1, 2]), weights=np.ones(3))
    deep = outer.get_params()
    assert deep["inner__alpha"] == 2.0 and deep["k"] == 3
    outer.set_params(inner__alpha=5.0, k=4)
    assert outer.inner.alpha == 5.0 and outer.k == 4
    twin = est.clone(outer)
    assert twin.inner is not outer.inner and twin.inner.alpha == 5.0
    assert twin.inner.tags == [1, 2] and twin.inner.tags is not outer.inner.tags
    assert twin.weights is not outer.weights
    np.testing.assert_array_equal(twin.weights, outer.weights)
    with pytest.raises(TypeError):
        est.clone(object())
    assert est.is_regressor(ICLRegressor()) and not est.is_regressor(clf)


def test_tabular_utils_equal_the_jax_ones():
    rng = np.random.default_rng(0)
    X = np.column_stack([rng.integers(0, 4, 30), rng.normal(size=30),
                         rng.integers(0, 30, 30), np.r_[np.nan, np.ones(29)]])
    assert tutils.infer_categorical_features(X) == jutils.infer_categorical_features(X)
    z = rng.normal(size=(4, 5)) * 50
    np.testing.assert_array_equal(tutils.softmax(z, axis=1), jutils.softmax(z, axis=1))
    assert (list(tutils.product_dict(a=[1, 2], b="xy"))
            == list(jutils.product_dict(a=[1, 2], b="xy")))
    import torch

    assert tutils.get_device("cpu") == torch.device("cpu")
