"""The port's data-parallel layer on the CPU (parallel/mesh.py,
train/loop.py under a mesh): ranks are spawned processes in one gloo group
(`run_ranks`), the JAX package runs on the conftest's 8 fake devices.

- the mesh semantics of tests/test_sharding.py::TestMeshBasics at 4 ranks
  (wildcard, the subset warning, the over-size and divisibility errors),
  the multislice layout, `shard_batch`, `replicate`, `gather_rows`;
  `pad_to_multiple` equal to the JAX package's;
- against JAX, on converted weights: ResNet-10's train-mode forward with
  global BatchNorm at W = 2 matches the JAX model on a batch sharded over 2
  fake devices (logits rel 1e-4 of their spread, running statistics
  1e-5); one DP train step at W = 2 matches `make_train_step` on a
  2-device mesh within the bounds of
  test_torch_port_train.py::test_three_train_steps_match_jax;
- the port at W = 2 against the port at one process on the same global
  batch: a full step and a ragged one (5 real rows of 8), Adam's first
  moment within 1e-5 of its norm, the parameters within the Adam-aware
  bounds of test_torch_port_fusion.py::test_one_train_step_matches_jax,
  the BatchNorm buffers and parameters equal on both ranks; a (2, 2)
  multislice step at 4 ranks against flat data parallelism;
- augmentation drawn for the global batch and sliced equals one process's.
"""

import warnings

import numpy as np
import pytest
import torch

from multimodal_ad_tpu_torch.models.resnet3d import generate_model
from multimodal_ad_tpu_torch.ops.augment import augment_batch
from multimodal_ad_tpu_torch.parallel import mesh as pmesh
from multimodal_ad_tpu_torch.train import loop as tloop
from test_torch_port_support import (cap_torch_threads, default_torch_threads,  # noqa: F401
                                     run_ranks)

cap_torch_threads()

SHAPE = (16, 20, 16, 1)
LR = 1e-3
WD = 1e-4
CW = np.array([0.3, 0.7], np.float32)


def _batch(seed, b=8, n_real=None):
    rng = np.random.default_rng(seed)
    n_real = b if n_real is None else n_real
    return {"image": (rng.normal(size=(b, *SHAPE)) * 2 + 1).astype(np.float32),
            "label": (np.arange(b) % 2).astype(np.int32),
            "mask": (np.arange(b) < n_real).astype(np.float32)}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _model(sd=None):
    m = generate_model(model_depth=10, resnet_shortcut="B", dropout_rate=0.0,
                       compute_dtype=torch.float32,
                       generator=torch.Generator().manual_seed(3))
    if sd is not None:
        m.load_state_dict(sd)
    return m


def _state(sd, mesh=None):
    return tloop.create_train_state(_model(sd), tloop.make_epoch_schedule(LR, 20), WD, 1.0,
                                    mesh=mesh)


def _result(state, loss, probs):
    params = dict(state.model.named_parameters())
    return {"loss": float(loss), "probs": probs.detach(),
            "sd": {k: v.detach().clone() for k, v in state.model.state_dict().items()},
            "u": {k: state.optimizer.state[p]["exp_avg"] / 0.1 for k, p in params.items()}}


# ---- rank functions (module level: each spawned rank imports this file) ----

def _mesh_semantics():
    rank = torch.distributed.get_rank()
    out = {}
    m = pmesh.make_mesh()
    out["wild"] = (m.mesh.tolist(), m.mesh_dim_names, pmesh.data_size(m), pmesh.data_rank(m))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sub = pmesh.make_mesh({"data": 2})
    out["sub_warnings"] = [str(w.message) for w in caught]
    out["sub"] = (sub.mesh.tolist(), pmesh.data_rank(sub), pmesh.is_main(sub))
    for shape in ({"data": 16}, {"a": -1, "b": -1}, {"a": 3, "b": -1}):
        try:
            pmesh.make_mesh(shape)
            out[str(shape)] = None
        except ValueError as e:
            out[str(shape)] = str(e)
    ms = pmesh.make_multislice_mesh(2)
    out["multi"] = (ms.mesh.tolist(), ms.mesh_dim_names, pmesh.data_rank(ms),
                    pmesh.data_size(ms))
    try:
        pmesh.make_multislice_mesh(3)
    except ValueError as e:
        out["multi3"] = str(e)
    x = torch.arange(8)
    out["shard"] = pmesh.shard_batch({"x": x, "y": x.numpy(), "s": ["a", "b"]}, m)
    out["shard_both"] = pmesh.shard_batch(x, ms, ("replica", "data"))
    out["shard_data"] = pmesh.shard_batch(x, ms, "data")
    try:
        pmesh.shard_batch(torch.arange(6), m)
    except ValueError as e:
        out["shard6"] = str(e)
    try:
        pmesh.local_rows(6, m)
    except ValueError as e:
        out["rows6"] = str(e)
    t = torch.full((3,), float(rank + 1))
    out["replicated"] = pmesh.replicate({"t": t}, m)["t"].clone()
    out["gathered"] = pmesh.gather_rows(torch.full((2, 1), rank), m)
    out["gathered_multi"] = pmesh.gather_rows(torch.full((1,), rank), ms)
    g = torch.ones(2, requires_grad=True)
    (pmesh.all_reduce_sum(g * (rank + 1), m) * torch.tensor([1.0, 2.0])).sum().backward()
    out["grad"] = g.grad.clone()
    return out


def _global_bn_forward(sd, image):
    """Train-mode forward of the rank's rows with global BatchNorm."""
    mesh = pmesh.make_mesh()
    model = pmesh.convert_sync_batchnorm(_model(sd), mesh).train()
    x = pmesh.shard_batch(torch.from_numpy(image), mesh)
    logits = model(x)
    return {"logits": pmesh.gather_rows(logits.detach(), mesh),
            "sd": {k: v.clone() for k, v in model.state_dict().items()},
            "cls": type(model.bn1).__name__}


def _dp_step(sd, batch, local_mean_too=False):
    """One DP train step on the rank's rows; with `local_mean_too`, also the
    first moment a step whose loss is each rank's local mean would leave."""
    mesh = pmesh.make_mesh()
    local = pmesh.shard_batch(_t(batch), mesh)
    state = _state(sd, mesh)
    loss, probs = tloop.train_step(state, local, torch.from_numpy(CW))
    out = _result(state, loss, pmesh.gather_rows(probs, mesh))
    if local_mean_too:
        other = _state(sd, mesh)
        other.model.train()
        other.optimizer.zero_grad(set_to_none=True)
        logits = other.ddp(local["image"]).float()
        tloop.weighted_ce(logits, local["label"], torch.from_numpy(CW),
                          local["mask"]).backward()  # the rank's own mean
        tloop.apply_gradients(other)
        out["u_local_mean"] = _result(other, 0.0, probs)["u"]
    return out


def _multislice_and_flat(sd, batch):
    out = {}
    for name, mesh in (("flat", pmesh.make_mesh()),
                       ("multislice", pmesh.make_multislice_mesh(2))):
        state = _state(sd, mesh)
        loss, probs = tloop.train_step(state, pmesh.shard_batch(_t(batch), mesh),
                                       torch.from_numpy(CW))
        out[name] = _result(state, loss, pmesh.gather_rows(probs, mesh))
    return out


# ---- the checks -----------------------------------------------------------

def _assert_u_and_params(a, b, lr0):
    """Adam's first update moves an element by lr u / (|u| + eps), u the
    clipped gradient plus wd p: the first moments / (1 - b1) within 1e-5 of
    u's global norm; where |u| exceeds ten times both the elements'
    disagreement and eps the parameters within lr / 50, elsewhere within
    2 lr (Adam's step is at most lr), at most 10 % of the elements."""
    u_norm = float(torch.sqrt(sum((v.double() ** 2).sum() for v in b["u"].values())))
    du = max(float((a["u"][k] - b["u"][k]).abs().max()) for k in b["u"])
    assert du <= 1e-5 * u_norm, (du, u_norm)
    n_loose = n_all = 0
    for k, ref in b["sd"].items():
        if "num_batches" in k:
            assert torch.equal(a["sd"][k], ref), k
            continue
        d = (a["sd"][k] - ref).abs()
        if k not in b["u"]:  # BN statistics
            assert float(d.max()) <= 1e-5, k
            continue
        big = b["u"][k].abs() > 10 * torch.clamp((a["u"][k] - b["u"][k]).abs(), min=1e-8)
        if big.any():
            assert float(d[big].max()) <= lr0 / 50, k
        if (~big).any():
            assert float(d[~big].max()) <= 2 * lr0, k
        n_loose += int((~big).sum())
        n_all += d.numel()
    assert n_loose <= 0.1 * n_all, (n_loose, n_all)
    return du, u_norm


def _ranks_equal(results):
    for r in results[1:]:
        for k, v in results[0]["sd"].items():
            assert torch.equal(r["sd"][k], v), k


def test_mesh_semantics_at_four_ranks(tmp_path):
    """TestMeshBasics at 4 ranks: the wildcard takes every rank; a subset
    takes the first ranks and warns, the rest are outside it; an over-size
    shape raises "needs"; the JAX texts for the wildcard errors. The
    multislice mesh is (2, 2), replica outermost; `shard_batch` splits over
    the named axes and replicates over the others; `replicate` broadcasts
    rank 0's values; `gather_rows` concatenates in mesh order; the
    differentiable all-reduce sums its gradient over the ranks."""
    res = run_ranks(_mesh_semantics, 4, tmp_path)
    for rank, out in enumerate(res):
        assert out["wild"] == ([0, 1, 2, 3], ("data",), 4, rank)
        assert any("uses 2 of 4 available devices" in w for w in out["sub_warnings"])
        assert out["sub"] == ([0, 1], rank if rank < 2 else None, rank == 0)
        assert "needs 16 devices, only 4 available" in out["{'data': 16}"]
        assert out["{'a': -1, 'b': -1}"] == "at most one mesh axis may be -1"
        assert out["{'a': 3, 'b': -1}"] == "4 devices not divisible by fixed axes 3"
        assert out["multi"] == ([[0, 1], [2, 3]], ("replica", "data"), rank, 4)
        assert out["multi3"] == "4 devices not divisible into 3 slices"
        assert out["shard"]["x"].tolist() == [2 * rank, 2 * rank + 1]
        assert out["shard"]["y"].tolist() == [2 * rank, 2 * rank + 1]
        assert out["shard"]["s"] == ["a", "b"]
        assert out["shard_both"].tolist() == [2 * rank, 2 * rank + 1]
        assert out["shard_data"].tolist() == list(range(4 * (rank % 2), 4 * (rank % 2) + 4))
        assert "not divisible" in out["shard6"]
        assert out["rows6"] == "batch_size=6 not divisible by the mesh data axis (4)"
        assert out["replicated"].tolist() == [1.0, 1.0, 1.0]
        assert out["gathered"][:, 0].tolist() == [0, 0, 1, 1, 2, 2, 3, 3]
        assert out["gathered_multi"].tolist() == [0, 1, 2, 3]
        # each of the 4 ranks' losses is (sum_r (r + 1) g_r) . [1, 2]: this
        # rank's g gets 4 (rank + 1) [1, 2]
        assert out["grad"].tolist() == [4.0 * (rank + 1), 8.0 * (rank + 1)]


def test_pad_to_multiple_equals_jax():
    from multimodal_ad_tpu.parallel.mesh import pad_to_multiple as jpad

    rng = np.random.default_rng(0)
    for n, mult in ((5, 8), (8, 4), (1, 3), (7, 7)):
        batch = {"image": rng.normal(size=(n, 3, 2)).astype(np.float32),
                 "label": np.arange(n, dtype=np.int32)}
        ours, mask = pmesh.pad_to_multiple(batch, mult)
        ref, jmask = jpad(batch, mult)
        np.testing.assert_array_equal(mask, jmask)
        for k in batch:
            np.testing.assert_array_equal(ours[k], ref[k])


def _jax_variables(seed):
    from test_torch_port_train import _jax_state, _variables

    jstate = _jax_state("B", seed=seed)
    return jstate, _variables(jstate)


@pytest.mark.usefixtures("default_torch_threads")
def test_global_batchnorm_matches_jax_on_two_devices(tmp_path):
    """TestDataParallelNumerics' recipe on the model: the JAX ResNet-10 in
    train mode on a batch of 8 sharded over 2 of the 8 fake devices (GSPMD
    makes its BatchNorm statistics global), the port's at W = 2 with each
    rank's 4 rows and `convert_sync_batchnorm`: logits within 1e-4 of their
    spread, every running statistic within 1e-5, the state_dict keys
    unchanged."""
    import jax
    import jax.numpy as jnp

    from multimodal_ad_tpu.parallel.mesh import data_sharding
    from multimodal_ad_tpu.parallel.mesh import make_mesh as jmake_mesh
    from multimodal_ad_tpu.parallel.mesh import replicate as jreplicate
    from multimodal_ad_tpu_torch.utils.torch_weights import state_dict_from_flax
    from test_torch_port_train import _jax_model

    jstate, v = _jax_variables(seed=21)
    image = _batch(22)["image"]
    with pytest.warns(UserWarning, match="2 of 8"):
        mesh2 = jmake_mesh({"data": 2})
    jm = _jax_model("B")[0]
    fwd = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))
    logits_j, upd = fwd(jreplicate(jax.tree_util.tree_map(jnp.asarray, v), mesh2),
                        jax.device_put(image, data_sharding(mesh2)))
    sd = state_dict_from_flax(v, 10, "B")
    res = run_ranks(_global_bn_forward, 2, tmp_path, sd, image)
    assert res[0]["cls"] == "GlobalFlaxBatchNorm3d"
    ref = np.asarray(logits_j)
    spread = float(ref.max() - ref.min())
    for out in res:
        np.testing.assert_allclose(out["logits"].numpy(), ref, rtol=0, atol=1e-4 * spread)
    ref_sd = state_dict_from_flax({"params": v["params"],
                                   "batch_stats": jax.device_get(upd["batch_stats"])}, 10, "B")
    assert set(res[0]["sd"]) == set(ref_sd)
    for k, want in ref_sd.items():
        if ".running_" in k:
            for out in res:
                torch.testing.assert_close(out["sd"][k], want, rtol=0, atol=1e-5, msg=k)


@pytest.mark.usefixtures("default_torch_threads")
def test_dp_train_step_matches_jax_on_two_devices(tmp_path):
    """One train step at W = 2 (each rank 2 rows of test_torch_port_train's
    batch of 4, the last one padding, so rank 1 holds 1 real row) against
    `make_train_step` on a 2-device mesh: the loss and the probabilities
    rel 1e-4, the BN statistics 1e-5, every parameter within 6 lr and 99.9 %
    within 1e-5 (test_three_train_steps_match_jax's bounds)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from multimodal_ad_tpu.parallel.mesh import make_mesh as jmake_mesh
    from multimodal_ad_tpu_torch.utils.torch_weights import state_dict_from_flax
    from test_torch_port_train import _assert_weights_close, _batches, _jax_model

    jstate, v = _jax_variables(seed=31)
    batch = _batches(seed=32, n=1)[0]
    with pytest.warns(UserWarning, match="2 of 8"):
        mesh2 = jmake_mesh({"data": 2})
    rep = NamedSharding(mesh2, P())
    jstate_m = jax.tree_util.tree_map(
        lambda a: jax.device_put(a, rep) if hasattr(a, "shape") else a, jstate)
    jb = {k: jax.device_put(a, NamedSharding(mesh2, P("data"))) for k, a in batch.items()}
    step = _jax_model("B")[1]
    jstate2, jl, jp = step(jstate_m, jb, jax.device_put(jnp.asarray(CW), rep),
                           jax.random.PRNGKey(0))
    res = run_ranks(_dp_step, 2, tmp_path, state_dict_from_flax(v, 10, "B"), batch)
    _ranks_equal(res)
    for out in res:
        assert out["loss"] == pytest.approx(float(jl), rel=1e-4)
        np.testing.assert_allclose(out["probs"].numpy(), np.asarray(jp), rtol=1e-4, atol=1e-6)
    sd = res[0]["sd"]

    class _Tstate:  # what _assert_weights_close reads
        class model:
            state_dict = staticmethod(lambda: sd)
    _assert_weights_close(_Tstate, jstate2, "B")


@pytest.mark.parametrize("n_real", [8, 5], ids=["full", "ragged-5-of-8"])
def test_two_ranks_match_one_process(tmp_path, n_real):
    """A step at W = 2 (4 rows a rank) against one process at the same
    global batch of 8: the loss rel 1e-6, the probabilities 1e-6, Adam's
    first moment and the parameters as `_assert_u_and_params`; the
    parameters and BN buffers of both ranks equal.

    The ragged batch (5 real rows: rank 0 holds 4, rank 1 one) is what a
    local-mean loss gets wrong: each rank would divide by its own weight
    sum, so rank 1's single row would weigh as much as rank 0's four. The
    test also takes that step (`weighted_ce` without the mesh on each
    rank, DDP's average) and shows its first moment misses the bound; on
    the full batch both ranks' weight sums are equal and the two agree."""
    sd = _model().state_dict()
    batch = _batch(41, n_real=n_real)
    ref_state = _state(sd)
    loss, probs = tloop.train_step(ref_state, _t(batch), torch.from_numpy(CW))
    ref = _result(ref_state, loss, probs)
    res = run_ranks(_dp_step, 2, tmp_path, sd, batch, True)
    _ranks_equal(res)
    lr0 = tloop.make_epoch_schedule(LR, 20)(0)
    for out in res:
        assert out["loss"] == pytest.approx(ref["loss"], rel=1e-6)
        torch.testing.assert_close(out["probs"], ref["probs"], rtol=0, atol=1e-6)
        du, u_norm = _assert_u_and_params(out, ref, lr0)
        du_local = max(float((out["u_local_mean"][k] - ref["u"][k]).abs().max())
                       for k in ref["u"])
        if n_real < 8:
            assert du_local > 100 * 1e-5 * u_norm, (du_local, u_norm)
        else:
            assert du_local <= 1e-5 * u_norm


def test_multislice_step_matches_flat_data_parallel(tmp_path):
    """TestMultisliceMesh: one step on the (2, 2) ('replica', 'data') mesh
    over 4 ranks equals the flat 4-rank step (both shard the batch over
    every rank), and each equals on all four ranks. The two meshes' groups
    sum in different orders (the first moments differ by 4e-8 against a
    norm of about 1), so where a gradient is near zero Adam's first update
    may take either sign: the parameters are held by `_assert_u_and_params`
    (JAX's test holds them to rtol 1e-4, atol 1e-5; here an element's
    sign flip reaches 1.6e-5)."""
    sd = _model().state_dict()
    batch = _batch(51)
    res = run_ranks(_multislice_and_flat, 4, tmp_path, sd, batch)
    lr0 = tloop.make_epoch_schedule(LR, 20)(0)
    for out in res:
        assert out["multislice"]["loss"] == pytest.approx(out["flat"]["loss"], rel=1e-5)
        _assert_u_and_params(out["multislice"], out["flat"], lr0)
    for name in ("flat", "multislice"):
        _ranks_equal([out[name] for out in res])


def test_augmentation_drawn_for_the_global_batch():
    """`augment_batch` on rows [lo, hi) of a global batch, with the draws
    made for the global batch: every rank's rows equal one process's
    augmentation of the whole batch, and the generator ends where one
    process's does."""
    x = torch.from_numpy(_batch(61)["image"])
    kw = dict(flip_prob=0.5, rotate_prob=0.5, zoom_prob=0.5, scale_prob=0.5, shift_prob=0.5)
    whole = augment_batch(x, torch.Generator().manual_seed(7), **kw)
    for w in (2, 4):
        per = x.shape[0] // w
        for r in range(w):
            g = torch.Generator().manual_seed(7)
            part = augment_batch(x[r * per:(r + 1) * per], g, global_rows=x.shape[0],
                                 row_offset=r * per, **kw)
            torch.testing.assert_close(part, whole[r * per:(r + 1) * per], rtol=0, atol=0)
            g_ref = torch.Generator().manual_seed(7)
            augment_batch(x, g_ref, **kw)
            assert torch.equal(g.get_state(), g_ref.get_state())
