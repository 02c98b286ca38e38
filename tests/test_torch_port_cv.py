"""Port parity on the CPU: the CV harness of the training slice.

- the seven metrics against the JAX package's train/metrics.py (sklearn):
  ties, one class, 3 and 4 classes, an absent class; 1e-12;
- `DeviceEpochIterator` batches, masks and names against the JAX
  iterator for the same plan (a ragged last batch, a reshuffle per epoch):
  images 1e-6 (K1's plain version against XLA's scale_intensity, which
  divides where K1 multiplies by the reciprocal); labels, masks and names
  equal; `VolumeBatcher`'s shuffled order equal to the JAX batcher's;
- checkpoints: a TrainState saved and restored resumes bit for bit;
  `latest_epoch_checkpoint`;
- a 2-fold, 2-epoch `train_cv` at 16x20x16 through `cli.train_resnet3d
  --device cpu` (resident with augmentation and precise-BN, and
  streaming): the 19-column cv_results.csv, best/final checkpoints that
  `EnsemblePredictor` loads, finite test metrics, `cli.evaluate`, resume;
- the flagship learning proof (slow, as in tests/test_learning.py).
"""

import csv
import os

import numpy as np
import pytest
import torch

from multimodal_ad_tpu.data import device_cache as jdc
from multimodal_ad_tpu.data import pipeline as jpipe
from multimodal_ad_tpu.train import metrics as jmetrics
from multimodal_ad_tpu.utils.logging import CV_CSV_HEADER as JAX_HEADER
from multimodal_ad_tpu_torch.data import device_cache as tdc
from multimodal_ad_tpu_torch.data import pipeline as tpipe
from multimodal_ad_tpu_torch.data.synthetic import make_adni_dir
from multimodal_ad_tpu_torch.models.resnet3d import generate_model
from multimodal_ad_tpu_torch.train import checkpoint as ckpt
from multimodal_ad_tpu_torch.train import loop as tloop
from multimodal_ad_tpu_torch.train import metrics as tmetrics
from multimodal_ad_tpu_torch.utils.logging import CV_CSV_HEADER

BINARY = {
    "ties": ([0, 0, 1, 1, 1, 0, 1, 0], [0, 1, 1, 1, 0, 0, 1, 0],
             [0.2, 0.5, 0.5, 0.9, 0.5, 0.2, 0.9, 0.5]),
    "one_class": ([1, 1, 1, 1], [1, 0, 1, 1], [0.9, 0.4, 0.8, 0.7]),
    "all_wrong": ([0, 1, 0, 1], [1, 0, 1, 0], [0.9, 0.1, 0.8, 0.2]),
    "no_positive_prediction": ([0, 1, 1, 0, 1], [0, 0, 0, 0, 0],
                               [0.1, 0.4, 0.3, 0.2, 0.45]),
}


def _multiclass(n_cls, absent=None, seed=0, n=24):
    rng = np.random.default_rng(seed)
    y_true = rng.integers(0, n_cls, n)
    y_pred = np.where(rng.random(n) < 0.6, y_true, rng.integers(0, n_cls, n))
    if absent is not None:
        y_true[y_true == absent] = (absent + 1) % n_cls
        y_pred[y_pred == absent] = (absent + 1) % n_cls
    prob = np.round(rng.random((n, n_cls)), 1) + 0.05  # ties in the scores
    return y_true, y_pred, prob / prob.sum(1, keepdims=True)


MULTICLASS = {
    "three": _multiclass(3),
    "four": _multiclass(4, seed=1),
    "absent_class": _multiclass(4, absent=2, seed=2),
    "rows_not_probabilities": (np.array([0, 1, 2, 1]), np.array([0, 1, 1, 1]),
                               np.full((4, 3), 0.5)),
}


def _assert_metrics_equal(ours, ref):
    for k in jmetrics.METRIC_KEYS:
        if np.isnan(ref[k]):
            assert np.isnan(ours[k]), k
        else:
            assert ours[k] == pytest.approx(float(ref[k]), rel=1e-12, abs=1e-12), k
    np.testing.assert_array_equal(ours["cm"], ref["cm"])


@pytest.mark.filterwarnings("ignore")
@pytest.mark.parametrize("case", sorted(BINARY))
def test_binary_metrics_match_sklearn(case):
    y_true, y_pred, score = BINARY[case]
    _assert_metrics_equal(tmetrics.calculate_metrics(y_true, y_pred, score),
                          jmetrics.calculate_metrics(y_true, y_pred, score))


@pytest.mark.filterwarnings("ignore")
@pytest.mark.parametrize("case", sorted(MULTICLASS))
def test_multiclass_metrics_match_sklearn(case):
    y_true, y_pred, prob = MULTICLASS[case]
    ours = tmetrics.calculate_metrics_multiclass(y_true, y_pred, prob)
    _assert_metrics_equal(ours, jmetrics.calculate_metrics_multiclass(y_true, y_pred, prob))
    assert ours["cm"].shape == (prob.shape[1],) * 2


def test_selection_score_and_roc_curve():
    m = {"AUC": float("nan"), "ACC": 0.75}
    assert tmetrics.model_selection_score(m) == jmetrics.model_selection_score(m) == 0.75
    m = {"AUC": 0.9, "ACC": 0.5}
    assert tmetrics.model_selection_score(m) == pytest.approx(
        jmetrics.model_selection_score(m))
    from sklearn.metrics import auc, roc_curve

    y, s = BINARY["ties"][0], BINARY["ties"][2]
    fpr, tpr = tmetrics.roc_curve(y, s)
    ref_fpr, ref_tpr, _ = roc_curve(y, s, drop_intermediate=False)
    np.testing.assert_allclose(fpr, ref_fpr)
    np.testing.assert_allclose(tpr, ref_tpr)
    assert auc(fpr, tpr) == pytest.approx(tmetrics.binary_auc(y, s))


# ---- input iterators ---------------------------------------------------------

def _corpus(n=11, shape=(6, 7, 5)):
    rng = np.random.default_rng(5)
    vols = (rng.normal(size=(n, *shape, 1)) * 40 + 100).astype(np.float32)
    vols[3] = 17.0  # a constant volume normalizes to 0
    return vols, (np.arange(n) % 2).astype(np.int32)


@pytest.mark.parametrize("normalizer", ["scale_intensity", "adaptive_normal"])
def test_epoch_iterator_matches_jax(normalizer):
    vols, labels = _corpus()
    subjects = [f"S{i:02d}" for i in range(len(vols))]
    plan = [9, 3, 0, 4, 7, 1, 10]  # 7 rows in batches of 3: the last is ragged
    jds = jdc.DeviceDataset(vols, labels)
    tds = tdc.DeviceDataset(vols, labels, device="cpu")
    kw = dict(batch_size=3, shuffle=True, seed=4, subjects=subjects,
              normalizer=normalizer)
    jit = jdc.DeviceEpochIterator(jds, plan, **kw)
    tit = tdc.DeviceEpochIterator(tds, plan, **kw)
    assert tit.device_resident and len(tit) == len(jit) == 3
    orders = []
    for _ in range(2):  # two epochs: each reshuffles
        jb, tb = list(jit), list(tit)
        assert len(jb) == len(tb) == 3
        for a, b in zip(jb, tb):
            np.testing.assert_allclose(b["image"].numpy(), np.asarray(a["image"]),
                                       rtol=0, atol=1e-6)
            np.testing.assert_array_equal(b["label"].numpy(), np.asarray(a["label"]))
            np.testing.assert_array_equal(b["mask"].numpy(), np.asarray(a["mask"]))
            assert b["subject"] == a["subject"]
        assert tb[-1]["mask"].tolist() == [1.0, 0.0, 0.0]
        orders.append([s for b in tb for s in b["subject"]])
    assert orders[0] != orders[1]
    assert sorted(orders[0]) == sorted(orders[1]) == sorted(subjects[i] for i in plan)


def test_epoch_iterator_augments_on_the_same_draws():
    """Augmented batches differ from plain ones, and are the same for the
    same seed (the draws come from a host generator); labels unaffected."""
    vols, labels = _corpus(8)
    tds = tdc.DeviceDataset(vols, labels, device="cpu")
    make = lambda **kw: tdc.DeviceEpochIterator(tds, np.arange(8), 8, seed=1, **kw)  # noqa: E731
    a, b = next(iter(make(augment=True, flip_prob=1.0))), next(iter(make(augment=True, flip_prob=1.0)))
    p = next(iter(make()))
    assert torch.equal(a["image"], b["image"])
    assert not torch.equal(a["image"], p["image"])
    assert torch.equal(a["label"], p["label"])
    with pytest.raises(IndexError):
        tdc.DeviceEpochIterator(tds, [0, 8], 2)
    with pytest.raises(ValueError):
        tdc.DeviceEpochIterator(tds, [0], 2, normalizer="zscore")


def test_volume_batcher_shuffle_matches_jax(tmp_path):
    csv_path, mri = make_adni_dir(str(tmp_path), n_per_class=5, shape=(4, 5, 4))
    from multimodal_ad_tpu_torch.data.adni import ADNIManifest

    recs = ADNIManifest(csv_path, mri, verbose=False).data_dict
    jb = jpipe.VolumeBatcher(recs, lambda v, **_: v[..., None], batch_size=4,
                             shuffle=True, seed=6, num_threads=2)
    tb = tpipe.VolumeBatcher(recs, batch_size=4, shuffle=True, seed=6, num_threads=2)
    for _ in range(2):
        for a, b in zip(jb, tb, strict=True):
            assert b["subject"] == a["subject"]
            np.testing.assert_array_equal(b["image"], a["image"])
            np.testing.assert_array_equal(b["mask"], a["mask"])


# ---- checkpoints ------------------------------------------------------------

def _state(seed=0):
    model = generate_model(model_depth=10, compute_dtype=torch.float32,
                           generator=torch.Generator().manual_seed(seed))
    return tloop.create_train_state(model, tloop.make_epoch_schedule(1e-3, 4),
                                    dropout_seed=seed)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"image": torch.from_numpy(rng.random((2, 8, 8, 8, 1)).astype(np.float32)),
            "label": torch.tensor([0, 1]), "mask": torch.ones(2)}


def test_checkpoint_resumes_bit_for_bit(tmp_path):
    cw = torch.tensor([0.5, 0.5])
    a = _state()
    tloop.train_step(a, _batch(1), cw)
    tloop.next_epoch(a)
    ckpt.save_checkpoint(str(tmp_path / "last_fold1"), a, metrics={"epoch": 1},
                         config={"model_depth": 10})
    b, meta = ckpt.restore_state(str(tmp_path / "last_fold1"), _state(seed=3))
    assert (b.epoch, b.step) == (1, 1) and meta["metrics"] == {"epoch": 1.0}
    la, _ = tloop.train_step(a, _batch(2), cw)
    lb, _ = tloop.train_step(b, _batch(2), cw)  # dropout stream restored too
    assert float(la) == float(lb)
    for (n, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), n
    # serving reads the plain state_dict; the weights-only form drops the
    # train state
    sd, _ = ckpt.restore_state(str(tmp_path / "last_fold1"))
    assert set(sd) == set(a.model.state_dict())
    ckpt.save_checkpoint(str(tmp_path / "last_fold1"), a.model.state_dict())
    assert not os.path.exists(tmp_path / "last_fold1" / ckpt.TRAIN_STATE_FILE)


def test_latest_epoch_checkpoint(tmp_path):
    assert ckpt.latest_epoch_checkpoint(str(tmp_path / "none"), "ep") is None
    assert ckpt.latest_epoch_checkpoint(str(tmp_path), "ep") is None
    for name in ("ep_002", "ep_010", "ep_009", "other"):
        os.makedirs(tmp_path / name)
    assert ckpt.latest_epoch_checkpoint(str(tmp_path), "ep") == str(tmp_path / "ep_010")


# ---- the CV harness end to end ---------------------------------------------

@pytest.fixture(scope="module")
def adni(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_cv")
    return make_adni_dir(str(root), n_per_class=6, shape=(16, 20, 16), seed=3,
                         extent_jitter=0.3, center_jitter=0.04)


def _train_cli(adni, out, *extra):
    from multimodal_ad_tpu_torch.cli.train_resnet3d import main

    csv_path, mri = adni
    return main(["--device", "cpu", f"label_file={csv_path}", f"mri_dir={mri}",
                 "num_epochs=2", "batch_size=4", "lr=1e-3", "n_splits=2",
                 "model_depth=10", f"checkpoint_dir={out}", "compute_dtype=float32",
                 "loader_threads=2", *extra])


RESIDENT = ["hbm_cache=true", "augment=true", "precise_bn=true", "resume=true"]


@pytest.fixture(scope="module")
def resident_run(adni, tmp_path_factory):
    """The resident path (device corpus, augmentation, precise-BN, rolling
    resume points), trained once for the tests below."""
    out = tmp_path_factory.mktemp("resident") / "ckpt"
    return out, _train_cli(adni, out, *RESIDENT)


def _check_run(out, results, resident):
    with open(out / "cv_results.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == CV_CSV_HEADER == JAX_HEADER and len(rows[0]) == 19
    assert [(r[0], r[1]) for r in rows[1:]] == [("1", "1"), ("1", "2"), ("2", "1"), ("2", "2")]
    assert all(np.isfinite(float(v)) for r in rows[1:] for v in r[2:] if v != "nan")
    lr = [float(r[-1]) for r in rows[1:]]
    assert lr == [1e-4, 1e-3, 1e-4, 1e-3]  # schedule(epoch) logged, as JAX logs
    for k in (1, 2):
        for name in (f"best_fold{k}", f"model_fold{k}_final"):
            assert os.path.isfile(out / name / "model.pt")
            assert os.path.isfile(out / name / ckpt.TRAIN_STATE_FILE)
    assert os.path.isdir(out / "last_fold1") == resident
    assert len(results["per_fold"]) == 2
    for k in ("ACC", "AUC", "MCC"):
        assert np.isfinite(results["avg"][k])


def test_train_cli_resident(resident_run):
    _check_run(*resident_run, resident=True)


def test_train_cli_streaming(adni, tmp_path, resident_run, capsys):
    """The streaming path, starting each fold from a MedicalNet-style
    checkpoint (a trained fold's state_dict, merged by key)."""
    out = tmp_path / "ckpt"
    pretrain = resident_run[0] / "best_fold1" / "model.pt"
    _check_run(out, _train_cli(adni, out, f"pretrain_path={pretrain}"), resident=False)
    assert capsys.readouterr().out.count("Loaded pretrained weights.") == 2


def test_trained_folds_serve(resident_run):
    from multimodal_ad_tpu_torch.serve import EnsemblePredictor

    pred = EnsemblePredictor.from_checkpoint_dir(str(resident_run[0]), device="cpu")
    assert pred.n_folds == 2
    vol = np.random.default_rng(0).random((3, 16, 20, 16)).astype(np.float32)
    proba = pred.predict_proba(vol)
    assert proba.shape == (3, 2) and np.allclose(proba.sum(1), 1.0, atol=1e-5)


def test_evaluate_cli_reproduces_the_test_metrics(adni, resident_run):
    from multimodal_ad_tpu_torch.cli.evaluate import main as evaluate

    out, results = resident_run
    csv_path, mri = adni
    again = evaluate(["--device", "cpu", f"label_file={csv_path}", f"mri_dir={mri}",
                      "batch_size=4", "n_splits=2", "model_depth=10",
                      f"checkpoint_dir={out}", "compute_dtype=float32",
                      "loader_threads=2"])
    for k in tmetrics.METRIC_KEYS:
        assert again["avg"][k] == pytest.approx(results["avg"][k], nan_ok=True)


def test_resume_continues_from_the_last_epoch(adni, resident_run, tmp_path):
    """A third epoch starts from last_fold{k}'s epoch 2 (a copy of the run)."""
    import shutil

    out = tmp_path / "ckpt"
    shutil.copytree(resident_run[0], out)
    _train_cli(adni, out, *RESIDENT, "num_epochs=3")
    with open(out / "cv_results.csv") as f:
        rows = list(csv.reader(f))
    assert [(r[0], r[1]) for r in rows[1:]] == [("1", "3"), ("2", "3")]


def test_host_augmentation_is_not_ported(adni, tmp_path):
    with pytest.raises(NotImplementedError, match="hbm_cache=True"):
        _train_cli(adni, tmp_path, "augment=true")


def test_class_weight_vector():
    from multimodal_ad_tpu.train.cv import class_weight_vector as jcw
    from multimodal_ad_tpu_torch.train.cv import class_weight_vector

    labels = [0, 0, 0, 1, 2, 2]
    np.testing.assert_array_equal(class_weight_vector(labels, 4), jcw(labels, 4))


@pytest.mark.slow
def test_flagship_cv_learns_separable_volumes(tmp_path):
    """tests/test_learning.py's proof on the port (its int8 half waits for
    the int8 slice): falling train loss, final val AUC >= 0.9 per fold,
    test AUC >= 0.85 and ACC >= 0.7."""
    from multimodal_ad_tpu_torch.core.config import Config
    from multimodal_ad_tpu_torch.train.cv import train_cv

    csv_path, mri_dir = make_adni_dir(
        str(tmp_path), n_per_class=24, classes=("AD", "CN"), shape=(16, 20, 16),
        seed=11, extent_jitter=0.3, center_jitter=0.04, noise=0.25)
    cfg = Config(label_file=csv_path, mri_dir=mri_dir, task="ADCN",
                 num_epochs=16, batch_size=4, lr=1e-3, n_splits=2, model_depth=10,
                 checkpoint_dir=str(tmp_path / "ckpt"), compute_dtype="float32",
                 normalizer="adaptive_normal", loader_threads=2)
    results, ckpt_dir = train_cv(cfg, verbose=False, device="cpu")
    with open(os.path.join(ckpt_dir, "cv_results.csv")) as f:
        rows = list(csv.reader(f))
    il, ia = rows[0].index("tr_loss"), rows[0].index("vl_auc")
    by_fold = {}
    for r in rows[1:]:
        by_fold.setdefault(r[0], []).append(r)
    for fold, frows in by_fold.items():
        assert np.mean([float(r[il]) for r in frows[-3:]]) < float(frows[0][il]), fold
        assert float(frows[-1][ia]) >= 0.9, fold
    assert results["avg"]["AUC"] >= 0.85, results["avg"]
    assert results["avg"]["ACC"] >= 0.7, results["avg"]
