"""ICLRegressor, the out-of-fold harness, the ensemble embedder, the
embedding pipelines and cli.tabular_embed against the JAX package on the
CPU: the regressor's mean, median and quantiles within 1e-4 of the
target's spread with the same `preprocess_`; OoFEmbedding's folds equal;
EnsembleICLEmbedder + tabel_encoder_multi (and tabel_encoder, and the CLI)
writing CSVs whose values agree within 1e-4 and whose header and label
columns are equal; the duplicate-candidate-name ValueError of
select_embedder_params, where the JAX package lets names collide."""

import csv
import warnings

import numpy as np
import pytest

from multimodal_ad_tpu.cli import tabular_embed as jcli
from multimodal_ad_tpu.data.synthetic import make_table as jax_make_table
from multimodal_ad_tpu.tabular import embedding as jemb
from multimodal_ad_tpu.tabular import pipeline as jpipe
from multimodal_ad_tpu.tabular.icl import ICLClassifier as JaxClassifier
from multimodal_ad_tpu.tabular.regression import ICLRegressor as JaxRegressor
from multimodal_ad_tpu_torch.cli import tabular_embed as tcli
from multimodal_ad_tpu_torch.tabular import embedding as temb
from multimodal_ad_tpu_torch.tabular import pipeline as tpipe
from multimodal_ad_tpu_torch.tabular.icl import ICLClassifier
from multimodal_ad_tpu_torch.tabular.regression import ICLRegressor

REG_TOL = 1e-4  # of the target's spread (max - min)
EMB_TOL = 1e-4
CLASSES = ["CN", "SMCI", "PMCI", "AD"]


def _reg_data(seed, n=60, f=8):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n + 15, f)).astype(np.float32)
    y = 2.0 * X[:, 0] - X[:, 1] * X[:, 2] + 0.3 * rng.normal(size=n + 15)
    X[:n][rng.random((n, f)) < 0.05] = np.nan
    return X[:n], y[:n], X[n:]


@pytest.mark.parametrize("preprocess,context_size", [("auto", None), (None, 40),
                                                     ("quantile", None)])
def test_regressor_matches_jax(preprocess, context_size):
    X, y, Xt = _reg_data(0)
    kw = dict(preprocess=preprocess, context_size=context_size)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = JaxRegressor(**kw).fit(X, y)
        t = ICLRegressor(device="cpu", **kw).fit(X, y)
    assert t.preprocess_ == j.preprocess_
    spread = float(y.max() - y.min())
    for out in ("mean", "median"):
        np.testing.assert_allclose(t.predict(Xt, out), j.predict(Xt, out), rtol=0,
                                   atol=REG_TOL * spread)
    for a, b in zip(t.predict(Xt, "quantiles"), j.predict(Xt, "quantiles")):
        np.testing.assert_allclose(a, b, rtol=0, atol=REG_TOL * spread)
    qs = [0.05, 0.5, 1.0]
    for a, b in zip(t.predict(Xt, "quantiles", qs), j.predict(Xt, "quantiles", qs)):
        np.testing.assert_allclose(a, b, rtol=0, atol=REG_TOL * spread)
    np.testing.assert_allclose(t.get_embeddings(Xt), j.get_embeddings(Xt), rtol=0,
                               atol=EMB_TOL)
    with pytest.raises(ValueError, match="output_type"):
        t.predict(Xt, "mode")


class _Recorder:
    """An embedder that records what it is fitted on and embeds a row as
    (its first value, the fit's size)."""

    def __init__(self):
        self.fits = []

    def fit(self, X, y):
        self.fits.append((X[:, 0].copy(), y.copy()))
        self.n = len(X)
        return self

    def get_embeddings(self, X, data_source="test"):
        return np.stack([X[:, 0], np.full(len(X), self.n)], 1)[None]


@pytest.mark.parametrize("n_fold", [0, 2, 5])
def test_oof_folds_match_jax(n_fold):
    rng = np.random.default_rng(1)
    X = rng.normal(size=(23, 3))
    y = rng.integers(0, 2, 23)
    Xq = rng.normal(size=(4, 3))
    ours, ref = _Recorder(), _Recorder()
    for source in ("train", "test"):
        a = temb.OoFEmbedding(ours, n_fold=n_fold).get_embeddings(X, y, Xq, source)
        b = jemb.OoFEmbedding(ref, n_fold=n_fold).get_embeddings(X, y, Xq, source)
        np.testing.assert_array_equal(a, b)
    assert len(ours.fits) == len(ref.fits)
    for (xa, ya), (xb, yb) in zip(ours.fits, ref.fits):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
    with pytest.raises(ValueError, match="greater than 1"):
        temb.OoFEmbedding(ours, n_fold=1).get_embeddings(X, y, Xq, "train")
    with pytest.raises(ValueError, match="No model"):
        temb.OoFEmbedding(None).fit(X, y)


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    df = jax_make_table(n=80, n_features=14, classes=tuple(CLASSES), seed=7,
                        n_categorical=2)
    rng = np.random.default_rng(7)
    df.loc[rng.random(80) < 0.1, "feat2"] = np.nan
    df.loc[rng.random(80) < 0.2, "cat0"] = None
    path = str(tmp_path_factory.mktemp("emb") / "ADNI_Tabel.csv")
    df.to_csv(path, index=False)
    return path


def _read(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], [r[0] for r in rows[1:]], np.array([[float(v) for v in r[1:]]
                                                       for r in rows[1:]])


def _assert_same_csvs(ours, ref):
    for a, b in zip(ours, ref):
        ha, la, va = _read(a)
        hb, lb, vb = _read(b)
        assert ha == hb and la == lb
        assert va.shape == vb.shape and np.isfinite(va).all()
        np.testing.assert_allclose(va, vb, rtol=0, atol=EMB_TOL)


def test_ensemble_embedder_and_tabel_encoder_multi_match_jax(table, tmp_path):
    kw = dict(start_col=14, label_col="Group", classes=CLASSES, n_fold=3,
              test_size=0.25, random_state=42)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = jpipe.tabel_encoder_multi(table, train_out=str(tmp_path / "j_tr.csv"),
                                        test_out=str(tmp_path / "j_te.csv"), **kw)
        ours = tpipe.tabel_encoder_multi(table, train_out=str(tmp_path / "t_tr.csv"),
                                         test_out=str(tmp_path / "t_te.csv"),
                                         device="cpu", **kw)
    header, labels, values = _read(ours[0])
    assert header == ["label"] + [str(j) for j in range(6 * 296)]
    assert set(labels) <= set(CLASSES) and values.shape == (60, 6 * 296)
    _assert_same_csvs(ours, ref)


def test_tabel_encoder_binary_matches_jax(table, tmp_path):
    kw = dict(start_col=14, class0="AD", class1="CN", n_fold=2, test_size=0.3,
              random_state=3)
    ref = jpipe.tabel_encoder(table, train_out=str(tmp_path / "j_tr.csv"),
                              test_out=str(tmp_path / "j_te.csv"),
                              embedder=JaxClassifier(preprocess="quantile",
                                                     n_estimators=2), **kw)
    ours = tpipe.tabel_encoder(table, train_out=str(tmp_path / "t_tr.csv"),
                               test_out=str(tmp_path / "t_te.csv"),
                               embedder=ICLClassifier(preprocess="quantile", n_estimators=2,
                                                      device="cpu"), **kw)
    _assert_same_csvs(ours, ref)
    assert set(_read(ours[0])[1]) <= {"0", "1"}  # integer labels
    ja = jpipe.embedding_downstream_eval(*ref)
    ta = tpipe.embedding_downstream_eval(*ours)
    assert set(ta) == {"ACC", "AUC"} and 0.0 <= ta["ACC"] <= 1.0
    assert abs(ta["ACC"] - ja["ACC"]) <= 0.1


def test_cli_tabular_embed_matches_jax(table, tmp_path, capsys):
    args = ["--table", table, "--label-col", "Group", "--n-fold", "2", "--test-size",
            "0.25"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        acc_j = jcli.main(args + ["--train-out", str(tmp_path / "j_tr.csv"),
                                  "--test-out", str(tmp_path / "j_te.csv")])
        acc_t = tcli.main(args + ["--train-out", str(tmp_path / "t_tr.csv"),
                                  "--test-out", str(tmp_path / "t_te.csv"),
                                  "--device", "cpu"])
    _assert_same_csvs([str(tmp_path / "t_tr.csv"), str(tmp_path / "t_te.csv")],
                      [str(tmp_path / "j_tr.csv"), str(tmp_path / "j_te.csv")])
    assert 0.0 <= acc_t <= 1.0 and abs(acc_t - acc_j) <= 0.1
    assert "[quick eval - SVM-linear]" in capsys.readouterr().out


def test_select_embedder_params_rejects_duplicate_names():
    X = np.zeros((10, 3), np.float32)
    y = np.arange(10) % 2
    with pytest.raises(ValueError, match="duplicate candidate names"):
        temb.select_embedder_params(X, y, [("a", None), ("b", None), ("a", None)],
                                    device="cpu")
    with pytest.raises(ValueError, match="n_fold"):
        temb.select_embedder_params(X, y, [("a", None)], n_fold=1, device="cpu")


def test_select_embedder_params_scores_candidates():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(40, 5)).astype(np.float32)
    y = (X[:, 0] > 0).astype(int)
    spec = [{"preprocess": None, "seed": 0, "n_estimators": 2}]
    best, params, scores = temb.select_embedder_params(
        X, y, [("emb", temb.load_embedder_params())], n_fold=2, cv=2,
        make_embedder=lambda p: temb.EnsembleICLEmbedder(specs=spec, params=p,
                                                         device="cpu"))
    assert best == "emb" and set(scores) == {"emb"} and 0.0 <= scores["emb"] <= 1.0
