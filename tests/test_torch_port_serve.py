"""Port parity on the CPU for the serving slice as a whole: the JAX
EnsemblePredictor against the port's, on converted fold weights, then the
port's checkpoint save -> from_checkpoint_dir -> cli.predict round trip.

Ensemble probabilities are held to 1e-4 (the JAX predictor normalizes on
the host by division, the port by K1's reciprocal multiply: <= 2 ulp per
voxel), predicted labels exactly."""

import csv
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_ad_tpu.models.resnet3d import generate_model as jax_generate
from multimodal_ad_tpu.serve import EnsemblePredictor as JaxPredictor
from multimodal_ad_tpu_torch.core.config import Config
from multimodal_ad_tpu_torch.data.synthetic import make_volume
from multimodal_ad_tpu_torch.models.resnet3d import generate_model
from multimodal_ad_tpu_torch.serve import EnsemblePredictor, evaluate_records
from multimodal_ad_tpu_torch.train import checkpoint as ckpt
from multimodal_ad_tpu_torch.utils.nifti import save as nifti_save
from multimodal_ad_tpu_torch.utils.torch_weights import state_dict_from_flax

SHAPE = (16, 20, 16)


def random_flax_variables(model, shape, seed):
    """Seeded numpy variables: He-normal kernels, BN scale and var in
    [0.5, 1.5], BN bias and mean ~ N(0, 0.1) (so softmax does not
    saturate)."""
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, *shape), jnp.float32),
        train=False))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return rng.normal(0, 0.1, s.shape).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.normal(size=s.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)

    v = jax.tree_util.tree_map_with_path(fill, shapes)
    return {"params": v["params"], "batch_stats": v["batch_stats"]}


def _volumes(n, seed, channels=None):
    rng = np.random.default_rng(seed)
    if channels is None:
        return np.stack([make_volume(rng, SHAPE, label=i % 2) for i in range(n)])
    return np.stack([np.stack([make_volume(rng, SHAPE, label=i % 2) * (c + 1)
                               for c in range(channels)], axis=-1)
                     for i in range(n)])


@pytest.fixture(scope="module")
def folds():
    """Two depth-10 f32 folds, as JAX variables and converted state dicts."""
    jm = jax_generate(model_depth=10, nb_class=2, compute_dtype=jnp.float32)
    fold_vars = [random_flax_variables(jm, (*SHAPE, 1), seed) for seed in (1, 2)]
    sds = [state_dict_from_flax(jax.tree_util.tree_map(np.asarray, v), 10, "B")
           for v in fold_vars]
    return jm, fold_vars, sds


def _port_predictor(sds, batch_size=4, in_channels=1):
    model = generate_model(model_depth=10, nb_class=2, in_channels=in_channels,
                           compute_dtype=torch.float32)
    return EnsemblePredictor(model, sds, batch_size=batch_size, device="cpu")


def test_ensemble_matches_jax(folds):
    jm, fold_vars, sds = folds
    vols = _volumes(6, seed=0)  # batch 4: one full chunk + a ragged one
    ref = JaxPredictor(jm, fold_vars, batch_size=4)
    port = _port_predictor(sds)
    proba = port.predict_proba(vols)
    assert proba.shape == (6, 2) and proba.dtype == np.float32
    np.testing.assert_allclose(proba, ref.predict_proba(vols), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(port.predict(vols), ref.predict(vols))
    np.testing.assert_allclose(proba.sum(1), 1.0, rtol=1e-5)


def test_chunking_does_not_change_results(folds):
    _, _, sds = folds
    vols = _volumes(7, seed=3)
    a = _port_predictor(sds, batch_size=3).predict_proba(vols)
    b = _port_predictor(sds, batch_size=8).predict_proba(vols)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_multichannel_matches_jax():
    """(n, X, Y, Z, 2) volumes normalize per channel, as the host path."""
    jm = jax_generate(model_depth=10, nb_class=2, in_channels=2,
                      compute_dtype=jnp.float32)
    v = random_flax_variables(jm, (*SHAPE, 2), seed=5)
    vols = _volumes(3, seed=4, channels=2)
    ref = JaxPredictor(jm, [v], batch_size=2).predict_proba(vols)
    sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, v), 10, "B")
    ours = _port_predictor([sd], batch_size=2, in_channels=2).predict_proba(vols)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)


def test_preprocess_false_and_adaptive_normal(folds):
    jm, fold_vars, sds = folds
    vols = _volumes(3, seed=6)
    pre = np.stack([(v - v.min()) / (v.max() - v.min()) for v in vols])
    port = _port_predictor(sds)
    np.testing.assert_allclose(port.predict_proba(pre, preprocess=False),
                               port.predict_proba(vols), rtol=0, atol=1e-4)
    ref = JaxPredictor(jm, fold_vars, batch_size=4, normalizer="adaptive_normal")
    model = generate_model(model_depth=10, compute_dtype=torch.float32)
    ours = EnsemblePredictor(model, sds, batch_size=4,
                             normalizer="adaptive_normal", device="cpu")
    np.testing.assert_allclose(ours.predict_proba(vols), ref.predict_proba(vols),
                               rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def ckpt_dir(folds, tmp_path_factory):
    _, _, sds = folds
    root = tmp_path_factory.mktemp("port_ckpt")
    cfg = Config(model_depth=10, batch_size=4, compute_dtype="float32",
                 input_W=SHAPE[0], input_H=SHAPE[1], input_D=SHAPE[2])
    for k, sd in enumerate(sds, start=1):
        ckpt.save_checkpoint(str(root / f"best_fold{k}"), sd,
                             metrics={"AUC": 0.5}, config=cfg.to_dict())
    return root


def test_checkpoint_round_trip(folds, ckpt_dir):
    _, _, sds = folds
    sd, meta = ckpt.restore_state(str(ckpt_dir / "best_fold2"))
    assert meta["config"]["model_depth"] == 10 and meta["metrics"] == {"AUC": 0.5}
    assert all(torch.equal(sd[k], sds[1][k]) for k in sds[1])
    pred = EnsemblePredictor.from_checkpoint_dir(str(ckpt_dir), device="cpu")
    assert pred.n_folds == 2 and pred.batch_size == 4
    vols = _volumes(5, seed=7)
    np.testing.assert_allclose(pred.predict_proba(vols),
                               _port_predictor(sds).predict_proba(vols),
                               rtol=0, atol=1e-6)


def test_orbax_directory_raises(tmp_path):
    d = tmp_path / "best_fold1"
    d.mkdir()
    (d / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="Orbax"):
        ckpt.restore_state(str(d))
    with pytest.raises(FileNotFoundError):
        ckpt.restore_state(str(tmp_path / "missing"))


def test_predict_cli(folds, ckpt_dir, tmp_path):
    from multimodal_ad_tpu_torch.cli.predict import main
    from multimodal_ad_tpu_torch.data.synthetic import make_adni_dir

    csv_path, mri_dir = make_adni_dir(str(tmp_path / "data"), n_per_class=3,
                                      shape=SHAPE, seed=8)
    out = str(tmp_path / "pred.csv")
    main(["--ckpt-dir", str(ckpt_dir), "--label-file", csv_path,
          "--mri-dir", mri_dir, "--task", "ADCN", "--out", out,
          "--device", "cpu", "--batch-size", "4"])
    with open(out) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["Subject_ID", "pred", "prob_0", "prob_1"]
    assert [r[0] for r in rows[1:]] == [f"{g}_{k:03d}" for g in ("AD", "CN")
                                       for k in range(3)]
    from multimodal_ad_tpu_torch.data.pipeline import load_volume

    vols = np.stack([load_volume(f"{mri_dir}/{r[0]}.nii") for r in rows[1:]])
    proba = _port_predictor(folds[2]).predict_proba(vols)
    got = np.array([[float(r[2]), float(r[3])] for r in rows[1:]])
    np.testing.assert_allclose(got, proba, rtol=0, atol=1e-6)
    assert [int(r[1]) for r in rows[1:]] == (proba[:, 1] > 0.5).astype(int).tolist()


def test_predict_cli_volumes_and_evaluate(folds, ckpt_dir, tmp_path):
    from multimodal_ad_tpu_torch.cli.predict import main

    vols = _volumes(3, seed=9)
    paths = []
    for i, v in enumerate(vols):
        paths.append(str(tmp_path / f"v{i}.nii.gz"))
        nifti_save(paths[-1], v)
    out = str(tmp_path / "pred.csv")
    main(["--ckpt-dir", str(ckpt_dir), "--volumes", *paths, "--out", out,
          "--device", "cpu"])
    with open(out) as f:
        rows = list(csv.reader(f))
    assert [r[0] for r in rows[1:]] == [f"v{i}.nii.gz" for i in range(3)]

    pred = _port_predictor(folds[2])
    res = evaluate_records(pred, [{"MRI": p, "label": i % 2}
                                  for i, p in enumerate(paths)])
    assert set(res) == {"AUC", "ACC"} and 0.0 <= res["ACC"] <= 1.0
    json.dumps(res)
