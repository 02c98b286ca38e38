"""The port's dp x sp training and the entry points on a 'space' axis, on
the CPU (train/loop.py with ``spatial=True``, parallel/mesh.py): ranks are
spawned gloo processes (`run_ranks`), the JAX package runs on the
conftest's 8 fake devices. The spatial layers, the ResNet's forward and
uneven slabs are in test_torch_port_spatial.py, whose helpers this file
shares.

- the {"data": 4, "space": 2} ResNet-10 train step at (8, 16, 20, 16, 1)
  against `make_train_step` on the same 2-D mesh (the bounds of
  test_torch_port_train.py::test_three_train_steps_match_jax) and against
  the port's one-process step (first moments within 1e-5 of their norm,
  every rank's parameters equal); with dropout 0.5 the space ranks of a
  data row draw one mask;
- `train_cv`, `EnsemblePredictor` and the extractors on {"data": 1,
  "space": 2} (the batch replicated over 'space') against one process.
"""

import os

import numpy as np
import pytest
import torch

from multimodal_ad_tpu_torch.parallel import mesh as pmesh
from multimodal_ad_tpu_torch.train import loop as tloop
from multimodal_ad_tpu_torch.utils.torch_weights import state_dict_from_flax
from test_torch_port_spatial import (CW, LR, SHAPE, WD, _jax_resnet_variables, _model,
                                     _ranks_equal, _result, _u_close)
from test_torch_port_support import (cap_torch_threads, default_torch_threads,  # noqa: F401
                                     run_ranks)

cap_torch_threads()


# ---- rank functions (module level: each spawned rank imports this file) ----

def _dropout_masks(state):
    masks = []
    state.model.conv_seg[2].register_forward_hook(lambda m, i, o: masks.append(o == 0))
    return masks


def _two_d_step(sd, batch):
    """One step on {"data": 4, "space": 2}, the ResNet spatially sharded;
    then one with dropout 0.5, whose masks it returns."""
    mesh = pmesh.make_mesh({"data": 4, "space": 2})
    local = pmesh.shard_batch({k: torch.from_numpy(v) for k, v in batch.items()}, mesh,
                              spatial=1)
    state = tloop.create_train_state(_model(sd), tloop.make_epoch_schedule(LR, 20), WD, 1.0,
                                     mesh=mesh, spatial=True)
    loss, probs = tloop.train_step(state, local, torch.from_numpy(CW))
    out = _result(state, loss, pmesh.gather_rows(probs, mesh),
                  whole=torch.distributed.get_rank() == 0)
    out["local_shape"] = tuple(local["image"].shape)
    drop = tloop.create_train_state(_model(sd, dropout=0.5), tloop.make_epoch_schedule(LR, 20),
                                    WD, 1.0, dropout_seed=5, mesh=mesh, spatial=True)
    masks = _dropout_masks(drop)
    with torch.no_grad():  # the masks are drawn in the train-mode forward
        drop.model.train()(local["image"])
    out["mask"] = masks[0]
    out["coords"] = (pmesh.data_rank(mesh), pmesh.space_rank(mesh))
    return out


def _entry_points(cfg_dict, vols, records, out_dir):
    """train_cv, EnsemblePredictor and the extractors on {"data": 1,
    "space": 2}: the batch replicated over 'space'."""
    from test_torch_port_parallel_train import _extract, _predict, _train_cv_rank

    mesh = pmesh.make_mesh({"data": 1, "space": 2})
    out = {"train_cv": _train_cv_rank(cfg_dict)}
    out["predict"] = {str(dt): _predict(vols, dt, mesh) for dt in (torch.float32,
                                                                   torch.bfloat16)}
    _extract(records, out_dir, mesh)
    return out


# ---- the tests ------------------------------------------------------------

@pytest.mark.usefixtures("default_torch_threads")
def test_two_d_mesh_train_step_matches_jax_and_one_process(tmp_path):
    """One ResNet-10 step on {"data": 4, "space": 2} at (8, 16, 20, 16, 1),
    each rank 2 rows x 8 planes, the last row padding, against
    `make_train_step` on the same 2-D mesh of the 8 fake devices with the
    batch on P("data") (replicated over 'space', equal to the unsharded
    step): test_three_train_steps_match_jax's bounds (the loss and
    probabilities rel 1e-4, the BN statistics 1e-5, every parameter within
    6 lr and 99.9 % within 1e-5). Against the JAX step with the batch on
    P("data", "space") too: the loss and probabilities rel 1e-4, the BN
    statistics 1e-5, the parameters within 6 lr (that step is itself 2 %
    of the elements more than 1e-5 from the unsharded one: Adam's first
    update moves an element whose gradient is near zero by up to lr either
    way). Against the port's one-process step: the loss rel 1e-6, first
    moments within 1e-5 of their norm; all eight ranks' parameters and
    buffers equal. With dropout 0.5 the two space ranks of a data row draw
    the same mask (a mask drawn by the flat rank would differ between them
    and mix two masks' gradients), and the data rows draw different
    ones."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from multimodal_ad_tpu.parallel.mesh import make_mesh as jmake_mesh
    from test_torch_port_train import _assert_weights_close, _jax_model, _variables

    jstate, v = _jax_resnet_variables(seed=81)
    sd = state_dict_from_flax(v, 10, "B")
    rng = np.random.default_rng(82)
    batch = {"image": (rng.normal(size=(8, *SHAPE)) * 2 + 1).astype(np.float32),
             "label": np.array([0, 1, 1, 0, 1, 0, 0, 1], np.int32),
             "mask": np.array([1, 1, 1, 1, 1, 1, 1, 0], np.float32)}
    ref_state = tloop.create_train_state(_model(sd), tloop.make_epoch_schedule(LR, 20), WD, 1.0)
    ref = _result(ref_state, *tloop.train_step(
        ref_state, {k: torch.from_numpy(a) for k, a in batch.items()}, torch.from_numpy(CW)))

    mesh2 = jmake_mesh({"data": 4, "space": 2})
    rep = NamedSharding(mesh2, P())
    jax_steps = {}
    for name, spec in (("data", P("data")), ("data_space", P("data", "space"))):
        js = jstate if name == "data" else _jax_resnet_variables(seed=81)[0]
        js = jax.tree_util.tree_map(
            lambda a: jax.device_put(a, rep) if hasattr(a, "shape") else a, js)
        jb = {"image": jax.device_put(batch["image"], NamedSharding(mesh2, spec)),
              "label": jax.device_put(batch["label"], NamedSharding(mesh2, P("data"))),
              "mask": jax.device_put(batch["mask"], NamedSharding(mesh2, P("data")))}
        jax_steps[name] = _jax_model("B")[1](js, jb, jax.device_put(jnp.asarray(CW), rep),
                                             jax.random.PRNGKey(0))
    res = run_ranks(_two_d_step, 8, tmp_path, sd, batch)
    _ranks_equal(res)
    for out in res:
        assert out["local_shape"] == (2, 8, 20, 16, 1)
        for _, jl, jp in jax_steps.values():
            assert out["loss"] == pytest.approx(float(jl), rel=1e-4)
            np.testing.assert_allclose(out["probs"].numpy(), np.asarray(jp), rtol=1e-4,
                                       atol=1e-6)
        assert out["loss"] == pytest.approx(ref["loss"], rel=1e-6)
    _u_close(res[0], ref)
    sd_out = res[0]["sd"]

    class _Tstate:  # what _assert_weights_close reads
        class model:
            state_dict = staticmethod(lambda: sd_out)
    _assert_weights_close(_Tstate, jax_steps["data"][0], "B")
    jsd = state_dict_from_flax(_variables(jax_steps["data_space"][0]), 10, "B")
    for k, want in jsd.items():
        if "num_batches" in k:
            continue
        bound = 1e-5 if ".running_" in k else 6 * LR
        assert float((sd_out[k] - want).abs().max()) <= bound, k
    masks = {out["coords"]: out["mask"] for out in res}
    for d in range(4):
        assert torch.equal(masks[(d, 0)], masks[(d, 1)]), d
        assert masks[(d, 0)].any() and not masks[(d, 0)].all()
    assert not all(torch.equal(masks[(0, 0)], masks[(d, 0)]) for d in range(1, 4))


def test_entry_points_on_a_space_axis(tmp_path):
    """On {"data": 1, "space": 2} the entry points split the batch over the
    data axis and replicate it over 'space', as the TPU package's
    `data_sharding` does: `train_cv` (resident, augmented, precise-BN) gives
    one process's test metrics (rel 1e-6) and CSV (1e-5) and rank 1 writes
    nothing; `EnsemblePredictor` fp32, bf16 and int8 probabilities within
    1e-6 of one process's; the U-Net ROI and encoder extraction CSVs equal
    one process's rows within 1e-6."""
    from multimodal_ad_tpu_torch.data.adni import ADNIManifest
    from multimodal_ad_tpu_torch.data.synthetic import make_adni_dir, make_volume
    from multimodal_ad_tpu_torch.train.cv import train_cv
    from test_torch_port_parallel_train import SHAPE as VSHAPE
    from test_torch_port_parallel_train import _cfg, _extract, _predict, _read_csv

    adni = make_adni_dir(str(tmp_path / "adni"), n_per_class=8, shape=VSHAPE, seed=3)
    one = _cfg(adni, str(tmp_path / "one"))
    results, _ = train_cv(one, device="cpu", verbose=False)
    rng = np.random.default_rng(0)
    vols = np.stack([make_volume(rng, VSHAPE, label=i % 2) for i in range(7)])
    records = ADNIManifest(adni[0], adni[1], verbose=False).data_dict[:6]
    _extract(records, str(tmp_path / "x1"))
    two = _cfg(adni, str(tmp_path / "two"), mesh_shape={"data": 1, "space": 2})
    res = run_ranks(_entry_points, 2, tmp_path, two.to_dict(), vols, records,
                    str(tmp_path / "x2"))
    assert res[0]["train_cv"]["counts"]["saves"] > 0
    assert res[1]["train_cv"]["counts"] == {"saves": 0, "loggers": 0}
    for r in res:
        assert r["train_cv"]["avg"] == pytest.approx(results["avg"], rel=1e-6, abs=1e-6)
        for dt in (torch.float32, torch.bfloat16):
            for k, want in _predict(vols, dt).items():
                np.testing.assert_allclose(r["predict"][str(dt)][k], want, rtol=0, atol=1e-6,
                                           err_msg=f"{dt} {k}")
    rows1, rows2 = (_read_csv(os.path.join(c, "cv_results.csv"))
                    for c in (one.checkpoint_dir, two.checkpoint_dir))
    assert rows1[0] == rows2[0] and len(rows1) == len(rows2) == 3
    for a, b in zip(rows1[1:], rows2[1:]):
        for name, p, q in zip(rows1[0], a, b):
            assert float(p) == pytest.approx(float(q), abs=1e-5), name
    for sub, name in (("unet", "roi_features.csv"), ("enc", "adni_features.csv")):
        a = _read_csv(tmp_path / "x1" / sub / name)
        b = _read_csv(tmp_path / "x2" / sub / name)
        assert len(a) == len(b) and a[0] == b[0], name
        for ra, rb in zip(a[1:], b[1:]):
            assert ra[0] == rb[0], name
            np.testing.assert_allclose(np.float64(rb[1:]), np.float64(ra[1:]), rtol=0,
                                       atol=1e-6, err_msg=name)
