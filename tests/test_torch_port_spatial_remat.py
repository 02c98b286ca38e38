"""The spatial ResNet at parity with the one-process one on the CPU: the
space-to-depth stem on slabs and block rematerialization on a 'space' axis
(parallel/spatial.py, parallel/mesh.py's `grad_group`, train/loop.py with
``spatial=True``). Ranks are spawned gloo processes (`run_ranks`); the JAX
package runs on the conftest's 8 fake devices (imported inside the tests:
the spawned ranks import this file).

- `SpatialStemConv` with ``s2d`` against the one-process `StemConv`: the
  forward and the 7^3 kernel's gradient (the ranks' partial gradients
  summed) on {"space": 2} and {"space": 3}, at X = 16 and 17 (odd and
  uneven slabs), C = 1 and 2, rtol = atol = 1e-5 in float32 (the
  gradient's atol scaled by its largest element); and at X = 3 over three
  ranks, where one rank's output slab is empty; ``s2d=False`` is the
  plain halo convolution on the same weight;
- the {"data": 4, "space": 2} ResNet-10 ``remat=True`` step at (8, 16, 20,
  16, 1) against `make_train_step` on the same 2-D mesh with the JAX
  `ResNet3D(depth=10, remat=True)` built directly, and against the port's
  one-process step (the bounds of test_torch_port_spatial_train.py::
  test_two_d_mesh_train_step_matches_jax_and_one_process);
- the spatial ``remat=True`` step against the ``remat=False`` step from the
  same weights, bit for bit in float32 (loss, probabilities, clipped
  gradients, parameters, running statistics, ``num_batches_tracked`` 1),
  where a rank's layer-4 slab is empty ({"data": 1, "space": 3}, X = 16)
  and at an uneven split ({"data": 2, "space": 2}, X = 23); an eval and a
  no-grad train forward of the remat model equal the plain model's;
- the exchanges a remat step counts: the plain step's plus its blocks'
  forward exchanges (the recomputation replays them), in number and bytes;
- DDP sums the gradients over `grad_group`, every rank of the mesh on a
  communicator apart from the global BatchNorm's `mesh_group`.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from multimodal_ad_tpu_torch.models.resnet3d import StemConv
from multimodal_ad_tpu_torch.parallel import mesh as pmesh
from multimodal_ad_tpu_torch.parallel import spatial as psp
from multimodal_ad_tpu_torch.train import loop as tloop
from multimodal_ad_tpu_torch.utils.torch_weights import state_dict_from_flax
from test_torch_port_spatial import (CW, LR, SHAPE, WD, _jax_resnet_variables, _model,
                                     _ranks_equal, _result, _u_close)
from test_torch_port_support import (cap_torch_threads, default_torch_threads,  # noqa: F401
                                     run_ranks)

cap_torch_threads()

STEM_YZ = (11, 10)
STEM_CASES = [(parts, x, c) for parts in (2, 3) for x in (16, 17) for c in (1, 2)]
STEM_EMPTY_CASE = (3, 3, 1)  # output slabs (1, 1, 0)
# mesh, volume shape, global batch
REMAT_CASES = {"empty_l4_slab": ({"data": 1, "space": 3}, SHAPE, 2),
               "uneven": ({"data": 2, "space": 2}, (23, 20, 16, 1), 4)}


def _stem_inputs(x_extent, c):
    """A (2, X, 11, 10, C) volume, a (64, C, 7, 7, 7) kernel and a
    cotangent of the stem's output (2, 64, X', 6, 5), seeded by the case."""
    rng = np.random.default_rng(1000 * x_extent + c)
    x = rng.normal(size=(2, x_extent, *STEM_YZ, c)).astype(np.float32)
    w = (rng.normal(size=(64, c, 7, 7, 7)) * np.sqrt(2.0 / (343 * c))).astype(np.float32)
    out = [psp.out_extent(n, 7, 2, 3, 1) for n in (x_extent, *STEM_YZ)]
    g = rng.normal(size=(2, 64, *out)).astype(np.float32)
    return x, w, g


def _stem(c, s2d, w):
    m = StemConv(c, 64, s2d=s2d)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(w))
    return m


def _remat_batch(shape, b, seed=90):
    rng = np.random.default_rng(seed)
    return {"image": (rng.normal(size=(b, *shape)) * 2 + 1).astype(np.float32),
            "label": (np.arange(b) % 2).astype(np.int32),
            "mask": np.ones(b, np.float32)}


# ---- rank functions (module level: each spawned rank imports this file) ----

def _slab_stems(parts, cases):
    """Each (X, C) case's stem on {"space": parts}, both forms: the output
    gathered whole, this rank's partial kernel gradient of sum(y * g)."""
    mesh = pmesh.make_mesh({"space": parts})
    sh = pmesh.spatial_sharding(mesh)
    me = pmesh.space_rank(mesh)
    out = {}
    for x_extent, c in cases:
        x, w, g = _stem_inputs(x_extent, c)
        for s2d in (True, False):
            stem = psp.convert_spatial(_stem(c, s2d, w), mesh)
            xs = sh.slab(torch.from_numpy(x)).permute(0, 4, 1, 2, 3)
            y, lay = stem(xs, psp.Slabs.split(x_extent, parts))
            lo, hi = lay.ranges[me]
            (y * torch.from_numpy(g)[:, :, lo:hi]).sum().backward()
            out[(x_extent, c, s2d)] = {
                "y": sh.gather(y.detach().permute(0, 2, 3, 4, 1).contiguous(), lay.extent),
                "grad": stem.weight.grad.clone(), "cls": type(stem).__name__,
                "planes": hi - lo}
    return out


def _remat_pair(mesh_shape, sd, batch):
    """The spatial step with remat=False, then with remat=True, from `sd`:
    results, exchange counts (and the plain forward's within its blocks),
    each rank's layer-4 planes, the eval / no-grad forwards of both."""
    mesh = pmesh.make_mesh(mesh_shape)
    local = pmesh.shard_batch({k: torch.from_numpy(v) for k, v in batch.items()}, mesh,
                              spatial=1)
    out = {"groups": {"grad": dist.get_process_group_ranks(pmesh.grad_group(mesh)),
                      "mesh": dist.get_process_group_ranks(pmesh.mesh_group(mesh)),
                      "apart": pmesh.grad_group(mesh) is not pmesh.mesh_group(mesh)}}
    models = {remat: psp.convert_spatial(_model(sd, remat=remat), mesh)
              for remat in (False, True)}
    with torch.no_grad():
        for name, train in (("eval", False), ("no_grad_train", True)):
            ys = [m.train(train)(local["image"]) for m in models.values()]
            out[name] = torch.equal(ys[0], ys[1])
    for m in models.values():  # the no-grad train forwards moved the statistics
        m.load_state_dict(sd)
    marks = {}

    def mark(name, planes=None):
        marks.setdefault(name, (psp.HaloExchange.exchanges, psp.HaloExchange.bytes, planes))

    models[False].layer1.register_forward_pre_hook(lambda mod, args: mark("in"))
    models[False].layer4.register_forward_hook(lambda mod, args, y: mark("out", y[0].shape[2]))
    for remat, model in models.items():
        state = tloop.create_train_state(model, tloop.make_epoch_schedule(LR, 20), WD, 1.0,
                                         mesh=mesh, spatial=True)
        if remat:
            out["ddp_on_grad_group"] = state.ddp.process_group is pmesh.grad_group(mesh)
        psp.HaloExchange.exchanges = psp.HaloExchange.bytes = 0
        loss, probs = tloop.train_step(state, local, torch.from_numpy(CW))
        out[remat] = {"loss": float(loss), "probs": probs,
                      "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
                      "sd": {k: v.clone() for k, v in model.state_dict().items()},
                      "exchanges": psp.HaloExchange.exchanges, "bytes": psp.HaloExchange.bytes}
    out["blocks_fwd"] = tuple(b - a for a, b in zip(marks["in"][:2], marks["out"][:2]))
    out["l4_planes"] = marks["out"][2]
    return out


def _two_d_remat_step(sd, batch):
    """One remat step on {"data": 4, "space": 2}, the ResNet spatially
    sharded."""
    mesh = pmesh.make_mesh({"data": 4, "space": 2})
    local = pmesh.shard_batch({k: torch.from_numpy(v) for k, v in batch.items()}, mesh,
                              spatial=1)
    state = tloop.create_train_state(_model(sd, remat=True), tloop.make_epoch_schedule(LR, 20),
                                     WD, 1.0, mesh=mesh, spatial=True)
    loss, probs = tloop.train_step(state, local, torch.from_numpy(CW))
    out = _result(state, loss, pmesh.gather_rows(probs, mesh), whole=dist.get_rank() == 0)
    out["local_shape"] = tuple(local["image"].shape)
    out["tracked"] = {int(v) for k, v in state.model.state_dict().items()
                      if k.endswith("num_batches_tracked")}
    return out


# ---- the tests ------------------------------------------------------------

@pytest.fixture(scope="module")
def slab_stems(tmp_path_factory):
    """The stem cases' rank results by space-axis size, spawned once each."""
    runs = {}

    def get(parts):
        if parts not in runs:
            cases = [(x, c) for p, x, c in STEM_CASES + [STEM_EMPTY_CASE] if p == parts]
            runs[parts] = run_ranks(_slab_stems, parts, tmp_path_factory.mktemp("stem"),
                                    parts, cases)
        return runs[parts]
    return get


@pytest.mark.parametrize("parts,x_extent,c", STEM_CASES + [STEM_EMPTY_CASE],
                         ids=[f"space{p}-x{x}-c{c}" for p, x, c in STEM_CASES]
                         + ["space3-x3-empty"])
def test_slab_stem_matches_one_process(slab_stems, parts, x_extent, c):
    """Both stem forms on slabs: the gathered output within rtol = atol =
    1e-5 of the one-process `StemConv`'s of the same form, the summed kernel
    gradient within rtol 1e-5 and 1e-5 of its largest element (each element
    sums 2 * X' * 30 products, ~20 in size here, in float32 and in another
    order: an absolute 1e-5 is below that rounding, for the plain halo conv
    as for the s2d one); the layer is `SpatialStemConv` either way."""
    res = slab_stems(parts)
    x, w, g = _stem_inputs(x_extent, c)
    planes = [r[(x_extent, c, True)]["planes"] for r in res]
    assert sum(planes) == g.shape[2]
    if (parts, x_extent, c) == STEM_EMPTY_CASE:
        assert planes == [1, 1, 0]
    for s2d in (True, False):
        ref = _stem(c, s2d, w)
        y = ref(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
        (y * torch.from_numpy(g)).sum().backward()
        want_y = y.detach().permute(0, 2, 3, 4, 1).numpy()
        grad = sum(r[(x_extent, c, s2d)]["grad"] for r in res)
        for r in res:
            got = r[(x_extent, c, s2d)]
            assert got["cls"] == "SpatialStemConv"
            np.testing.assert_allclose(got["y"].numpy(), want_y, rtol=1e-5, atol=1e-5,
                                       err_msg=f"s2d={s2d}")
        want_g = ref.weight.grad.numpy()
        np.testing.assert_allclose(grad.numpy(), want_g, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want_g).max()), err_msg=f"s2d={s2d}")


@pytest.fixture(scope="module")
def remat_pairs(tmp_path_factory):
    """Each REMAT_CASES entry's `_remat_pair` results, spawned once, one
    intra-op thread a rank: with two or more, DDP over gloo on CPU ranks
    leaves one rank's first-layer update a few 1e-8 off the others' in
    one step in six to twenty, in the plain step as in the remat one (the
    same Adam step on copies of its inputs gives the other ranks' value),
    which a bit-for-bit comparison cannot tell from remat."""
    runs = {}

    def get(case):
        if case not in runs:
            mesh_shape, shape, b = REMAT_CASES[case]
            world = int(np.prod(list(mesh_shape.values())))
            sd = _model().state_dict()
            runs[case] = run_ranks(_remat_pair, world, tmp_path_factory.mktemp("remat"),
                                   mesh_shape, sd, _remat_batch(shape, b), threads=1)
        return runs[case]
    return get


@pytest.mark.parametrize("case", list(REMAT_CASES))
def test_spatial_remat_step_equals_plain_step(remat_pairs, case):
    """On every rank the remat step's loss, probabilities, clipped
    gradients, parameters and running statistics equal the plain step's bit
    for bit, every BatchNorm counts the step once, and the ranks hold one
    model; an eval and a no-grad train forward of the two models agree."""
    res = remat_pairs(case)
    if case == "empty_l4_slab":
        assert [r["l4_planes"] for r in res] == [1, 1, 0]
    else:
        assert sorted({r["l4_planes"] for r in res}) == [1, 2]
    for r in res:
        assert r["eval"] and r["no_grad_train"]
        plain, remat = r[False], r[True]
        assert remat["loss"] == plain["loss"]
        assert torch.equal(remat["probs"], plain["probs"])
        for k, g in plain["grads"].items():
            assert torch.equal(remat["grads"][k], g), k
        for k, v in plain["sd"].items():
            assert torch.equal(remat["sd"][k], v), k
            if k.endswith("num_batches_tracked"):
                assert int(v) == 1, k
    for k, v in res[0][True]["sd"].items():
        for r in res[1:]:
            assert torch.equal(r[True]["sd"][k], v), k


@pytest.mark.parametrize("case", list(REMAT_CASES))
def test_remat_step_replays_the_blocks_exchanges(remat_pairs, case):
    """A remat step counts the plain step's exchanges and bytes plus those
    of its blocks' forward (the recomputation replays each), on every
    rank."""
    for r in remat_pairs(case):
        n_blocks, bytes_blocks = r["blocks_fwd"]
        assert n_blocks > 0 and bytes_blocks > 0
        assert r[True]["exchanges"] == r[False]["exchanges"] + n_blocks
        assert r[True]["bytes"] == r[False]["bytes"] + bytes_blocks


def test_ddp_runs_on_a_group_of_its_own(remat_pairs):
    """DDP sums the gradients over `grad_group`: the mesh's ranks, not the
    process group object the global BatchNorm's sums run on."""
    for r in remat_pairs("uneven"):
        assert r["groups"]["grad"] == r["groups"]["mesh"] == [0, 1, 2, 3]
        assert r["groups"]["apart"] and r["ddp_on_grad_group"]


def _remat_names(tree, back=False):
    """flax's auto names of the blocks under `nn.remat`: BasicBlock_i <->
    CheckpointBasicBlock_i."""
    a, b = ("CheckpointBasicBlock_", "BasicBlock_") if back else ("BasicBlock_",
                                                                   "CheckpointBasicBlock_")
    return {(b + k[len(a):] if k.startswith(a) else k): v for k, v in tree.items()}


@pytest.mark.usefixtures("default_torch_threads")
def test_two_d_remat_step_matches_jax_and_one_process(tmp_path):
    """One ResNet-10 ``remat=True`` step on {"data": 4, "space": 2} at (8,
    16, 20, 16, 1), each rank 2 rows x 8 planes, the last row padding,
    against `make_train_step` with the JAX ``ResNet3D(depth=10,
    remat=True)`` on the same 2-D mesh: with the batch on P("data") the
    loss and probabilities rel 1e-4, the BN statistics 1e-5, every
    parameter within 6 lr and 99.9 % within 1e-5; with the batch on
    P("data", "space") (remat composed with spatial sharding under GSPMD)
    the loss and probabilities rel 1e-4, the BN statistics 1e-5, the
    parameters within 6 lr. Against the port's one-process step: the loss
    rel 1e-6, first moments within 1e-5 of their norm; the eight ranks'
    parameters and buffers equal, every BatchNorm counted once."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from multimodal_ad_tpu.models.resnet3d import ResNet3D as JaxResNet3D
    from multimodal_ad_tpu.parallel.mesh import make_mesh as jmake_mesh
    from test_torch_port_train import _assert_weights_close, _jax_model, _variables

    jm = JaxResNet3D(depth=10, remat=True, dropout_rate=0.0, dtype=jnp.float32)

    def remat_state(seed):
        js = _jax_resnet_variables(seed)[0]
        params, stats = _remat_names(js.params), _remat_names(js.batch_stats)
        return js.replace(params=params, batch_stats=stats, opt_state=js.tx.init(params),
                          apply_fn=jm.apply)

    _, v = _jax_resnet_variables(seed=81)
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
        js = jax.tree_util.tree_map(
            lambda a: jax.device_put(a, rep) if hasattr(a, "shape") else a, remat_state(81))
        jb = {"image": jax.device_put(batch["image"], NamedSharding(mesh2, spec)),
              "label": jax.device_put(batch["label"], NamedSharding(mesh2, P("data"))),
              "mask": jax.device_put(batch["mask"], NamedSharding(mesh2, P("data")))}
        js, jl, jp = _jax_model("B")[1](js, jb, jax.device_put(jnp.asarray(CW), rep),
                                        jax.random.PRNGKey(0))
        jax_steps[name] = (js.replace(params=_remat_names(js.params, back=True),
                                      batch_stats=_remat_names(js.batch_stats, back=True)),
                           jl, jp)
    res = run_ranks(_two_d_remat_step, 8, tmp_path, sd, batch)
    _ranks_equal(res)
    for out in res:
        assert out["local_shape"] == (2, 8, 20, 16, 1)
        assert out["tracked"] == {1}
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
