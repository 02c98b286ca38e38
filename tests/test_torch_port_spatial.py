"""The port's spatial sharding on the CPU (parallel/spatial.py, the 'space'
axis of parallel/mesh.py, train/loop.py with ``spatial=True``): ranks are
spawned gloo processes (`run_ranks`), the JAX package runs on the
conftest's 8 fake devices, the weights carried across by the converters
(JAX is imported inside the tests: the spawned ranks import this file).

- the 2-D mesh: axis names, coordinates, the data / space / whole-mesh
  groups, `data_size`, `is_main`, an unknown axis; `spatial_sharding`'s
  ranges equal the JAX NamedSharding's `devices_indices_map` where the
  extent divides, `torch.tensor_split`'s where it does not;
- tests/test_sharding.py::TestSpatialSharding and Test2DMesh's layers
  against the JAX package sharded the same way: the 3^3/p1 conv over 8
  ranks, the 7^3/s2 stem + 3^3/s2 max pool over 8, the two-conv model on
  {"data": 4, "space": 2} (rtol = atol = 1e-5, JAX's bound);
- ResNet-10 over 8 space ranks at (2, 16, 20, 16, 1), where halos are
  wider than slabs and six ranks' slabs are empty from layer 2 on: the
  logits against the JAX forward sharded over 8 devices, both stems (1e-4,
  JAX's bound), and within 1e-5 of the port's unsharded forward; the
  'pool', 'none' and 'seg' heads against the unsharded model; one train
  step over the 8 ranks against one process;
- X = 23 over 2 and 3 space ranks (uneven slabs): the train-mode forward,
  the BatchNorm statistics and the input gradients against one process,
  where the equal-count BatchNorm (each rank's count times the ranks)
  misses;
- `dryrun_multichip(4, device="cpu")`'s spatial and 2-D parts.

The dp x sp train step and the entry points on a 'space' axis are in
test_torch_port_spatial_train.py.
"""

import hashlib

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch import nn

from multimodal_ad_tpu_torch.models.resnet3d import ResNet3D, generate_model
from multimodal_ad_tpu_torch.parallel import mesh as pmesh
from multimodal_ad_tpu_torch.parallel import spatial as psp
from multimodal_ad_tpu_torch.train import loop as tloop
from multimodal_ad_tpu_torch.utils.torch_weights import state_dict_from_flax
from test_torch_port_support import (cap_torch_threads, default_torch_threads,  # noqa: F401
                                     run_ranks, torch_threads)

cap_torch_threads()

SHAPE = (16, 20, 16, 1)
LR = 1e-3
WD = 1e-4
CW = np.array([0.3, 0.7], np.float32)


def _cl(x: torch.Tensor) -> torch.Tensor:
    """NCDHW -> channels-last (B, X, Y, Z, C)."""
    return x.permute(0, 2, 3, 4, 1).contiguous()


def _cf(x: torch.Tensor) -> torch.Tensor:
    """Channels-last -> NCDHW."""
    return x.permute(0, 4, 1, 2, 3)


def _conv_from_flax(kernel, bias=None, **kw) -> nn.Conv3d:
    k = torch.from_numpy(np.transpose(np.asarray(kernel), (4, 3, 0, 1, 2)).copy())
    conv = nn.Conv3d(k.shape[1], k.shape[0], tuple(k.shape[2:]), bias=bias is not None, **kw)
    with torch.no_grad():
        conv.weight.copy_(k)
        if bias is not None:
            conv.bias.copy_(torch.from_numpy(np.asarray(bias)))
    return conv


def _model(sd=None, head="classifier", dropout=0.0, **kw):
    m = ResNet3D(depth=10, head=head, dropout_rate=dropout, compute_dtype=torch.float32,
                 generator=torch.Generator().manual_seed(3), **kw)
    if sd is not None:
        m.load_state_dict(sd)
    return m


def _digest(tensors: dict) -> dict:
    """sha256 of each tensor's bytes: equal digests, equal tensors."""
    return {k: hashlib.sha256(v.detach().contiguous().numpy().tobytes()).hexdigest()
            for k, v in tensors.items()}


def _result(state, loss, probs, whole=True):
    """A step's loss, probabilities, digests of the state_dict and of Adam's
    first moments / (1 - b1), and with `whole` both in full (rank 0 alone
    sends them: eight ranks' copies would be ~1 GB to save and load)."""
    params = dict(state.model.named_parameters())
    sd = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    u = {k: state.optimizer.state[p]["exp_avg"] / 0.1 for k, p in params.items()}
    out = {"loss": float(loss), "probs": probs.detach(), "digest": (_digest(sd), _digest(u))}
    if whole:
        out.update(sd=sd, u=u)
    return out


def _ranks_equal(results):
    """Every rank's parameters, buffers and first moments bit-equal to rank
    0's."""
    for r in results[1:]:
        assert r["digest"] == results[0]["digest"]


def _u_close(a, b, bound=1e-5):
    """Adam's first moments / (1 - b1) of `a` within `bound` of their global
    norm in `b`; returns the share."""
    u_norm = float(torch.sqrt(sum((v.double() ** 2).sum() for v in b["u"].values())))
    du = max(float((a["u"][k] - b["u"][k]).abs().max()) for k in b["u"])
    assert du <= bound * u_norm, (du, u_norm)
    return du / u_norm


# ---- rank functions (module level: each spawned rank imports this file) ----

def _mesh_and_layers(conv_kb, x1, stem_k, x2, two_conv, x3):
    """The 2-D mesh's semantics, then TestSpatialSharding's and Test2DMesh's
    layers on their slabs, gathered whole."""
    rank = dist.get_rank()
    out = {}
    mesh = pmesh.make_mesh({"data": 4, "space": 2})
    groups = {name: dist.get_process_group_ranks(g(mesh)) for name, g in (
        ("data", pmesh.data_group), ("space", pmesh.space_group), ("mesh", pmesh.mesh_group))}
    out["mesh"] = (mesh.mesh.tolist(), mesh.mesh_dim_names, pmesh.data_rank(mesh),
                   pmesh.space_rank(mesh), pmesh.data_size(mesh), pmesh.space_size(mesh),
                   pmesh.mesh_size(mesh), pmesh.is_main(mesh), groups)
    try:
        pmesh.make_mesh({"data": 4, "model": 2})
    except ValueError as e:
        out["unknown"] = str(e)
    b = pmesh.shard_batch({"image": torch.arange(4 * 23).reshape(4, 23, 1, 1, 1),
                           "label": torch.arange(4)}, mesh, spatial=1)
    out["shard"] = (b["image"][:, :, 0, 0, 0].tolist(), b["label"].tolist())
    mesh8 = pmesh.make_mesh({"space": 8})
    sh8 = pmesh.spatial_sharding(mesh8)
    out["mesh8"] = (pmesh.data_size(mesh8), pmesh.data_rank(mesh8), pmesh.space_rank(mesh8),
                    pmesh.is_main(mesh8), sh8.ranges(16), sh8.ranges(23), sh8.bounds(16))

    with torch.no_grad():
        conv = psp.convert_spatial(_conv_from_flax(*conv_kb, padding=1), mesh8)
        y, lay = conv(_cf(sh8.slab(torch.from_numpy(x1))), psp.Slabs.split(16, 8))
        out["conv"] = sh8.gather(_cl(y), lay.extent)

        stem = psp.convert_spatial(nn.Sequential(_conv_from_flax(stem_k, stride=2, padding=3),
                                                 nn.MaxPool3d(3, 2, 1)), mesh8)
        y, lay = stem[0](_cf(sh8.slab(torch.from_numpy(x2))), psp.Slabs.split(32, 8))
        y, lay = stem[1](y, lay)
        out["stem"] = sh8.gather(_cl(y), lay.extent)

        c1, c2 = (psp.convert_spatial(_conv_from_flax(*kb, padding=1), mesh) for kb in two_conv)
        x = pmesh.shard_batch(torch.from_numpy(x3), mesh, spatial=1)
        y, lay = c1(_cf(x), psp.Slabs.split(16, 2))
        y, lay = c2(torch.relu(y), lay)
        out["two_conv"] = pmesh.gather_rows(pmesh.spatial_sharding(mesh).gather(_cl(y), 16), mesh)
    out["rank"] = rank
    return out


def _resnet_eight_way(sd, x, head_sds, batch):
    """ResNet-10 over {"space": 8}: the classifier with both stems, the other
    heads, one train step."""
    mesh = pmesh.make_mesh({"space": 8})
    sh = pmesh.spatial_sharding(mesh)
    xs = sh.slab(torch.from_numpy(x))
    out = {}
    with torch.no_grad():
        for s2d in (True, False):
            m = generate_model(model_depth=10, compute_dtype=torch.float32, dropout_rate=0.0,
                               s2d_stem=s2d)
            m.load_state_dict(sd)
            out[f"s2d={s2d}"] = psp.convert_spatial(m.eval(), mesh)(xs)
        for head, hsd in head_sds.items():
            r = psp.convert_spatial(_model(hsd, head, num_seg_classes=3).eval(), mesh)(xs)
            if head in ("none", "seg"):
                slab, (lo, hi) = r
                assert slab.shape[1] == hi - lo
                r = sh.gather(slab)
            out[head] = r
    state = tloop.create_train_state(_model(sd), tloop.make_epoch_schedule(LR, 20), WD, 1.0,
                                     mesh=mesh, spatial=True)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    b["image"] = sh.slab(b["image"])
    psp.HaloExchange.exchanges = 0
    loss, probs = tloop.train_step(state, b, torch.from_numpy(CW))
    out["step"] = _result(state, loss, probs, whole=dist.get_rank() == 0)
    out["exchanges"] = psp.HaloExchange.exchanges
    return out


def _equal_count_forward(self, x):
    """The BatchNorm of the data-parallel slice: n = local count x ranks."""
    if not (self.training and self.track_running_stats) or self.mesh_group is None:
        return super(pmesh.GlobalBatchNormMixin, self).forward(x)
    c = x.shape[1]
    dims = [0] + list(range(2, x.dim()))
    view = (1, c) + (1,) * (x.dim() - 2)
    n = (x.numel() // c) * dist.get_world_size(self.mesh_group)
    xf = x.float()
    mean = pmesh.group_sum(xf.sum(dims), self.mesh_group) / n
    d = xf - mean.view(view)
    var = pmesh.group_sum((d * d).sum(dims), self.mesh_group) / n
    with torch.no_grad():
        self.num_batches_tracked.add_(1)
        self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
        self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
    y = d * torch.rsqrt(var + self.eps).view(view)
    return (y * self.weight.view(view) + self.bias.view(view)).to(x.dtype)


def _uneven(sd, x, w, bn_x):
    """Train-mode forward and backward of the ResNet on this rank's slab of
    X = 23, and a BatchNorm on a 23-plane slab; then both again with the
    equal-count BatchNorm."""
    n = dist.get_world_size()
    mesh = pmesh.make_mesh({"space": n})
    sh = pmesh.spatial_sharding(mesh)
    bn_sh = pmesh.spatial_sharding(mesh, spatial_dim=2)
    out = {}
    for name in ("counted", "equal_count"):
        if name == "equal_count":
            pmesh.GlobalBatchNormMixin.forward = _equal_count_forward
        model = psp.convert_spatial(_model(sd).train(), mesh)
        xs = sh.slab(torch.from_numpy(x)).requires_grad_(True)
        logits = model(xs)
        # each rank takes 1 / n of the loss (as a train step's share does);
        # the sums over the ranks in the pool and BatchNorm add the rest
        ((logits * torch.from_numpy(w)).sum() / n).backward()
        bn = pmesh.convert_sync_batchnorm(nn.BatchNorm3d(3, momentum=1.0).train(), mesh)
        bn(bn_sh.slab(torch.from_numpy(bn_x)))
        out[name] = {"logits": logits.detach(), "grad": sh.gather(xs.grad, 23),
                     "stats": {k: v.clone() for k, v in model.state_dict().items()
                               if ".running_" in k},
                     "bn": (bn.running_mean.clone(), bn.running_var.clone()),
                     "slabs": tuple(xs.shape)}
    return out


# ---- the JAX side ---------------------------------------------------------

def _jax_resnet_variables(seed):
    from test_torch_port_train import _jax_state, _variables

    jstate = _jax_state("B", seed=seed)
    return jstate, _variables(jstate)


# ---- the tests ------------------------------------------------------------

def test_split_ranges_are_tensor_splits():
    """`split_ranges` is `torch.tensor_split`'s partition, empty slabs and
    all."""
    for extent in range(0, 30):
        for parts in (1, 2, 3, 5, 8):
            sizes = [len(c) for c in torch.tensor_split(torch.arange(extent), parts)]
            ranges = pmesh.split_ranges(extent, parts)
            assert [hi - lo for lo, hi in ranges] == sizes
            assert ranges[0][0] == 0 and ranges[-1][1] == extent
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


def test_plan_finds_every_owner():
    """`plan_window` against brute force: each rank's window holds exactly
    the planes its outputs read (a borrowed one from its owner), for the
    ResNet's windows on uneven, empty and halo-wider-than-slab layouts;
    every slot is lent by one rank."""
    for extent, parts in ((16, 8), (23, 2), (23, 3), (2, 8), (91, 2), (12, 5)):
        src = psp.Slabs.split(extent, parts)
        for k, s, p, d in ((3, 1, 1, 1), (7, 2, 3, 1), (3, 2, 1, 1), (1, 2, 0, 1),
                           (3, 1, 2, 2), (3, 1, 4, 4)):
            dst = psp.Slabs.split(psp.out_extent(extent, k, s, p, d), parts)
            owner = src.owners()
            sent = []
            for me in range(parts):
                plan = psp.plan_window(src, dst, k, s, p, d, me)
                o0, o1 = dst.ranges[me]
                need = {o * s - p + t * d for o in range(o0, o1) for t in range(k)}
                need = {i for i in need if 0 <= i < extent}
                got = {plan.lo + pos for pos, _ in plan.recv}
                got |= {plan.lo + plan.own_dst + j for j in range(plan.own_count)}
                assert need <= got, (extent, parts, k, s, p, d, me)
                assert all(owner[plan.lo + pos] != me for pos, _ in plan.recv)
                sent += [slot for slot, _ in plan.send]
            assert sorted(sent) == list(range(plan.n_slots))


def test_mesh_and_layers_match_jax_on_eight_devices(tmp_path):
    """The 2-D mesh's semantics at 8 ranks, and TestSpatialSharding's and
    Test2DMesh's layers against the JAX package sharded the same way on the
    8 fake devices: the 3^3/p1 conv at (1, 16, 8, 8, 2) over 8 ranks, the
    7^3/s2 stem + 3^3/s2 max pool at (1, 32, 16, 16, 1) over 8, the two
    3^3 convs at (4, 16, 8, 8, 2) on {"data": 4, "space": 2}; rtol = atol
    = 1e-5."""
    import jax
    import jax.numpy as jnp
    from flax import linen as fnn
    from jax.sharding import NamedSharding, PartitionSpec as P

    from multimodal_ad_tpu.models.resnet3d import max_pool_3d
    from multimodal_ad_tpu.parallel.mesh import make_mesh as jmake_mesh

    rng = np.random.default_rng(0)
    x1 = rng.normal(size=(1, 16, 8, 8, 2)).astype(np.float32)
    x2 = rng.normal(size=(1, 32, 16, 16, 1)).astype(np.float32)
    x3 = rng.normal(size=(4, 16, 8, 8, 2)).astype(np.float32)

    class Stem(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            x = fnn.Conv(8, (7, 7, 7), strides=(2, 2, 2), padding=3, use_bias=False)(x)
            return max_pool_3d(x, 3, 2, 1)

    class TwoConv(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            x = fnn.relu(fnn.Conv(4, (3, 3, 3), padding=1)(x))
            return fnn.Conv(4, (3, 3, 3), padding=1)(x)

    mesh8 = jmake_mesh({"space": 8})
    mesh2 = jmake_mesh({"data": 4, "space": 2})
    rep8, rep2 = NamedSharding(mesh8, P()), NamedSharding(mesh2, P())
    ref = {}
    conv = fnn.Conv(4, (3, 3, 3), padding=1)
    for name, model, x, mesh, spec in (("conv", conv, x1, mesh8, P(None, "space")),
                                       ("stem", Stem(), x2, mesh8, P(None, "space")),
                                       ("two_conv", TwoConv(), x3, mesh2, P("data", "space"))):
        v = model.init(jax.random.PRNGKey(1), jnp.asarray(x))
        rep = rep8 if mesh is mesh8 else rep2
        out = jax.jit(model.apply)(jax.tree_util.tree_map(lambda a: jax.device_put(a, rep), v),
                                   jax.device_put(x, NamedSharding(mesh, spec)))
        assert len(out.sharding.device_set) == 8
        ref[name] = (np.asarray(out), jax.tree_util.tree_map(np.asarray, v["params"]))
    p = ref["conv"][1]["kernel"], ref["conv"][1]["bias"]
    stem_k = ref["stem"][1]["Conv_0"]["kernel"]
    two = [(ref["two_conv"][1][f"Conv_{i}"]["kernel"], ref["two_conv"][1][f"Conv_{i}"]["bias"])
           for i in (0, 1)]
    res = run_ranks(_mesh_and_layers, 8, tmp_path, p, x1, stem_k, x2, two, x3)

    idx8 = NamedSharding(mesh8, P(None, "space")).devices_indices_map((1, 16, 8, 8, 2))
    jax_ranges = tuple((idx8[d][1].start, idx8[d][1].stop) for d in mesh8.devices.ravel())
    idx2 = NamedSharding(mesh2, P("data", "space")).devices_indices_map((4, 16, 8, 8, 2))
    for rank, out in enumerate(res):
        d, s = divmod(rank, 2)
        grid, names, dr, sr, dsize, ssize, msize, main, groups = out["mesh"]
        assert grid == [[0, 1], [2, 3], [4, 5], [6, 7]] and names == ("data", "space")
        assert (dr, sr, dsize, ssize, msize, main) == (d, s, 4, 2, 8, rank == 0)
        assert groups == {"data": [s, s + 2, s + 4, s + 6], "space": [2 * d, 2 * d + 1],
                          "mesh": list(range(8))}
        assert "unknown mesh axes ['model']" in out["unknown"]
        jdev = mesh2.devices[d, s]
        assert (idx2[jdev][0].start, idx2[jdev][0].stop) == (d, d + 1)
        assert (idx2[jdev][1].start, idx2[jdev][1].stop) == (8 * s, 8 * s + 8)
        lo, hi = ((0, 12), (12, 23))[s]
        assert out["shard"] == ([[d * 23 + i for i in range(lo, hi)]], [d])
        assert out["mesh8"] == (1, 0, rank, rank == 0, jax_ranges, pmesh.split_ranges(23, 8),
                                jax_ranges[rank])
        for name in ("conv", "stem", "two_conv"):
            np.testing.assert_allclose(out[name].numpy(), ref[name][0], rtol=1e-5, atol=1e-5,
                                       err_msg=name)


@pytest.mark.usefixtures("default_torch_threads")
def test_resnet10_over_eight_space_ranks(tmp_path):
    """Full-width ResNet-10 over {"space": 8} at (2, 16, 20, 16, 1): the
    stem's 8 output planes, one a rank; from layer 2 on two planes for 8
    ranks, so six slabs are empty and the dilated halos (2 and 4 planes)
    are wider than a slab. The logits against the JAX forward sharded over
    the 8 fake devices with ``s2d_stem`` True and False, rtol = atol = 1e-4
    (test_sharding.py's bound), and within 1e-5 of the port's unsharded
    forward; the 'pool', 'none' and 'seg' heads within 1e-5 of the spread
    of the unsharded model's outputs; one train step (batch 2, 1 padding row) against one
    process: the loss rel 1e-6, first moments within 1e-5 of their norm,
    all 8 ranks' parameters and buffers equal. The one-process step runs on
    one thread, as each rank does: the float32 loss of that step moves by
    1.3e-6 relative between one thread's split and eight threads', more
    than the bound."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from multimodal_ad_tpu.models.resnet3d import generate_model as jgen
    from multimodal_ad_tpu.parallel.mesh import make_mesh as jmake_mesh

    jstate, v = _jax_resnet_variables(seed=71)
    sd = state_dict_from_flax(v, 10, "B")
    x = np.random.default_rng(72).normal(size=(2, *SHAPE)).astype(np.float32)
    mesh8 = jmake_mesh({"space": 8})
    rep = NamedSharding(mesh8, P())
    vs = jax.tree_util.tree_map(lambda a: jax.device_put(jnp.asarray(a), rep), v)
    jref = {}
    for s2d in (True, False):
        jm = jgen(model_depth=10, dropout_rate=0.0, compute_dtype=jnp.float32, s2d_stem=s2d)
        out = jax.jit(lambda v, x, m=jm: m.apply(v, x, train=False))(
            vs, jax.device_put(x, NamedSharding(mesh8, P(None, "space"))))
        assert len(out.sharding.device_set) == 8
        jref[s2d] = np.asarray(out)
    head_sds = {}
    plain = {}
    with torch.no_grad():
        for head in ("pool", "none", "seg"):
            m = _model(head=head, num_seg_classes=3).eval()
            if head != "seg":
                m.load_state_dict({k: t for k, t in sd.items() if not k.startswith("conv_seg")})
            head_sds[head] = m.state_dict()
            plain[head] = m(torch.from_numpy(x))
        plain["logits"] = _model(sd).eval()(torch.from_numpy(x))
    rng = np.random.default_rng(73)
    batch = {"image": (rng.normal(size=(2, *SHAPE)) * 2 + 1).astype(np.float32),
             "label": np.array([0, 1], np.int32), "mask": np.array([1, 0], np.float32)}
    with torch_threads(1):
        ref_state = tloop.create_train_state(_model(sd), tloop.make_epoch_schedule(LR, 20), WD,
                                             1.0)
        ref_step = _result(ref_state, *tloop.train_step(
            ref_state, {k: torch.from_numpy(a) for k, a in batch.items()}, torch.from_numpy(CW)))
    res = run_ranks(_resnet_eight_way, 8, tmp_path, sd, x, head_sds, batch)
    for out in res:
        for s2d in (True, False):
            logits = out[f"s2d={s2d}"].numpy()
            np.testing.assert_allclose(logits, jref[s2d], rtol=1e-4, atol=1e-4,
                                       err_msg=f"s2d={s2d}")
            np.testing.assert_allclose(logits, plain["logits"].numpy(), rtol=0, atol=1e-5)
        for head in ("pool", "none", "seg"):
            ref = plain[head].numpy()
            np.testing.assert_allclose(out[head].numpy(), ref, rtol=0,
                                       atol=1e-5 * float(ref.max() - ref.min()), err_msg=head)
        assert out["step"]["loss"] == pytest.approx(ref_step["loss"], rel=1e-6)
        torch.testing.assert_close(out["step"]["probs"], ref_step["probs"], rtol=0, atol=1e-6)
        assert out["exchanges"] > 0
    _u_close(res[0]["step"], ref_step)
    _ranks_equal([out["step"] for out in res])


@pytest.mark.parametrize("ranks", [2, 3])
def test_uneven_extent_matches_one_process(tmp_path, ranks):
    """X = 23 over 2 (12 + 11 planes) and 3 (8 + 8 + 7) space ranks: the
    ResNet-10's train-mode logits within 1e-5, every BatchNorm's running
    statistics within 1e-6 and the input gradients within 1e-5 of their
    largest of one process's (global BatchNorm: each rank's element count
    all-reduced); a BatchNorm on the 23-plane slabs themselves too. The
    BatchNorm that takes each rank's count times the ranks misses there by
    far more (and at 2 ranks in the ResNet too, where layer 2's 3 planes
    split 2 + 1)."""
    # seed 92 puts one layer-3 ReLU input of the one-process model at 1e-7,
    # where fp32 kernels disagree on its sign: its two memory layouts give
    # input gradients 0.14 apart there (BatchNorm spreads one flip to every
    # element), so no sharded run can match both
    rng = np.random.default_rng(100 + ranks)
    sd = _model().state_dict()
    x = rng.normal(size=(2, 23, 20, 16, 1)).astype(np.float32)
    w = rng.normal(size=(2, 2)).astype(np.float32)
    bn_x = (rng.normal(size=(2, 3, 23, 4, 4)) + np.arange(23)[None, None, :, None, None]
            ).astype(np.float32)
    model = _model(sd).train()
    xt = torch.from_numpy(x).requires_grad_(True)
    logits = model(xt)
    (logits * torch.from_numpy(w)).sum().backward()
    stats = {k: v for k, v in model.state_dict().items() if ".running_" in k}
    bn = nn.BatchNorm3d(3, momentum=1.0).train()
    bn(torch.from_numpy(bn_x))
    n = torch.tensor(bn_x.size // 3, dtype=torch.float32)
    bn_ref = (bn.running_mean, bn.running_var * (n - 1) / n)  # the biased variance
    res = run_ranks(_uneven, ranks, tmp_path, sd, x, w, bn_x)
    g_scale = float(xt.grad.abs().max())
    for out in res:
        ok = out["counted"]
        torch.testing.assert_close(ok["logits"], logits.detach(), rtol=0, atol=1e-5)
        torch.testing.assert_close(ok["grad"], xt.grad, rtol=0, atol=1e-5 * g_scale)
        for k, v in stats.items():
            torch.testing.assert_close(ok["stats"][k], v, rtol=0, atol=1e-6, msg=k)
        for got, want in zip(ok["bn"], bn_ref):
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        eq = out["equal_count"]
        assert max(float((g - r).abs().max()) for g, r in zip(eq["bn"], bn_ref)) > 1e-2
        worst = max(float((eq["stats"][k] - v).abs().max()) for k, v in stats.items())
        assert worst > 1e-3 if ranks == 2 else worst <= 1e-6, worst
    assert [out["counted"]["slabs"][1] for out in res] == [
        hi - lo for lo, hi in pmesh.split_ranges(23, ranks)]


def test_dryrun_multichip_four_ranks_on_the_cpu(monkeypatch, capsys):
    """`dryrun_multichip(4)`: the data-parallel step, the 4-way spatial
    forward of both stems and the {"data": 2, "space": 2} step, each held
    by rank 0 against the unsharded run, and the line naming them."""
    from multimodal_ad_tpu_torch.entry import dryrun_multichip

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    loss = dryrun_multichip(4, device="cpu")
    assert np.isfinite(loss)
    line = capsys.readouterr().out
    assert "dryrun_multichip(4): dp train step over 4 gloo processes on the CPU OK" in line
    assert "4-way spatially-sharded forward (s2d + naive stems" in line
    assert "2-D {'data': 2, 'space': 2} dp x sp train step" in line
