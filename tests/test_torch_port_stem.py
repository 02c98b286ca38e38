"""The ResNet's space-to-depth stem (`StemConv`) and block rematerialization
(`remat`) against the JAX package, on the CPU.

- `StemConv` with ``s2d`` True and False against the JAX `StemConv` on the
  same kernel (DHWIO there, OIDHW here), at (2, 19, 22, 21) with C = 1
  and 2 (odd extents), float32, rtol = atol = 1e-4 (the JAX package's own
  bound for its two stems); the 7^3 kernel's gradient against `jax.grad`'s
  within 1e-4 of its largest element; bf16 under autocast against the JAX
  module at dtype bfloat16;
- the table and the packing against a direct numpy derivation (the 4^3
  kernel bit-equal to the one the int8 model built before it shared them);
- a depth-10 `ResNet3D` with ``s2d_stem`` True and False against the JAX
  model on converted weights; one `conv1.weight` (64, C, 7, 7, 7) for
  both stems, and a checkpoint of either loads into the other;
- ``remat=True`` against ``remat=False``: one train step's loss, gradients,
  parameters and BatchNorm statistics equal, ``num_batches_tracked``
  advanced once, in one process (float32 and bf16, a basic and a
  bottleneck depth) and under DDP over gloo at W = 1 and 2 (the global
  BatchNorm at 2);
- the stem on slabs and ``remat`` on a 'space' axis are in
  test_torch_port_spatial_remat.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_ad_tpu.models.resnet3d import ResNet3D as JaxResNet3D
from multimodal_ad_tpu.models.resnet3d import StemConv as JaxStemConv
from multimodal_ad_tpu.models.resnet3d import generate_model as jax_generate_model
from multimodal_ad_tpu_torch.models import resnet3d as tresnet
from multimodal_ad_tpu_torch.models.resnet3d import (STEM_S2D_IDX, ResNet3D, StemConv,
                                                     generate_model, image_encoder,
                                                     stem_s2d_pack, stem_s2d_weight)
from multimodal_ad_tpu_torch.parallel import mesh as pmesh
from multimodal_ad_tpu_torch.train import checkpoint as ckpt
from multimodal_ad_tpu_torch.train import loop as tloop
from multimodal_ad_tpu_torch.utils.torch_weights import state_dict_from_flax
from test_torch_port_models import random_flax_variables
from test_torch_port_support import cap_torch_threads, run_ranks

cap_torch_threads()

STEM_SHAPE = (2, 19, 22, 21)
SHAPE = (16, 20, 16, 1)
LR = 1e-3
WD = 1e-4
CW = np.array([0.3, 0.7], np.float32)


def _stem_case(c, seed=0):
    rng = np.random.default_rng(seed + c)
    x = rng.normal(size=(*STEM_SHAPE, c)).astype(np.float32)
    kernel = (rng.normal(size=(7, 7, 7, c, 64)) * np.sqrt(2.0 / (343 * c))).astype(np.float32)
    return x, kernel


def _port_stem(kernel, s2d):
    m = StemConv(kernel.shape[3], 64, s2d=s2d)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(kernel).permute(4, 3, 0, 1, 2))
    return m


def _port_stem_apply(m, x):
    """(B, D, H, W, C) numpy -> the stem's (B, D', H', W', 64) output."""
    return m(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)


@pytest.mark.parametrize("c", [1, 2])
@pytest.mark.parametrize("s2d", [True, False])
def test_stem_matches_jax_float32(s2d, c):
    x, kernel = _stem_case(c)
    jm = JaxStemConv(64, s2d=s2d, dtype=jnp.float32)
    ref = np.asarray(jm.apply({"params": {"kernel": kernel}}, x))
    with torch.no_grad():
        ours = _port_stem_apply(_port_stem(kernel, s2d), x).numpy()
    assert ours.shape == ref.shape == (2, 10, 11, 11, 64)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("c", [1, 2])
@pytest.mark.parametrize("s2d", [True, False])
def test_stem_kernel_gradient_matches_jax(s2d, c):
    """d sum(y * g) / d kernel, g a fixed random cotangent: within 1e-4 of
    the gradient's largest element, elementwise rtol 1e-4."""
    x, kernel = _stem_case(c, seed=10)
    g = np.random.default_rng(20 + c).normal(size=(2, 10, 11, 11, 64)).astype(np.float32)
    jm = JaxStemConv(64, s2d=s2d, dtype=jnp.float32)
    ref = np.asarray(jax.grad(
        lambda k: jnp.sum(jm.apply({"params": {"kernel": k}}, x) * g))(kernel))
    m = _port_stem(kernel, s2d)
    (_port_stem_apply(m, x) * torch.from_numpy(g)).sum().backward()
    ours = m.weight.grad.permute(2, 3, 4, 1, 0).numpy()  # OIDHW -> DHWIO
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4 * scale)


def test_stem_bf16_matches_jax_bf16():
    """Under bf16 autocast the s2d stem casts the input and the 7^3 kernel
    to bf16 before packing and gathering, as the JAX model at dtype
    bfloat16 does (its ResNet3D casts the input): the outputs within 1e-2
    of their spread."""
    x, kernel = _stem_case(1, seed=30)
    ref = np.asarray(JaxStemConv(64, s2d=True, dtype=jnp.bfloat16).apply(
        {"params": {"kernel": kernel}}, jnp.asarray(x, jnp.bfloat16))).astype(np.float32)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        out = _port_stem_apply(_port_stem(kernel, True), x)
    assert out.dtype == torch.bfloat16
    spread = float(ref.max() - ref.min())
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=1e-2 * spread)


def test_s2d_table_and_packing():
    """STEM_S2D_IDX is the tap map (k = 2t + p - 1 per axis), each of the
    343 taps once; the 4^3 kernel equals the int8 model's former
    construction (a where over the (343, C, F) kernel) bit for bit in bf16;
    the packing puts x[2m + p] at block m + 2, channel ((pd * 2 + ph) * 2 +
    pw) * C + c, zeros around."""
    # per axis, tap t of phase p is kernel index k = 2t + p - 1 (none at -1 or 7)
    for t in range(4):
        for p in range(2):
            k = 2 * t + p - 1
            want = (k * 7 + 2) * 7 + 4 if 0 <= k <= 6 else -1  # kh = 2, kw = 4
            assert STEM_S2D_IDX[t, 1, 2, p * 4 + 1 * 2 + 1] == want
    assert sorted(STEM_S2D_IDX[STEM_S2D_IDX >= 0].tolist()) == list(range(343))

    c = 2
    _, kernel = _stem_case(c, seed=40)
    k = torch.from_numpy(kernel).to(torch.bfloat16).reshape(343, c, 64)
    idx = torch.from_numpy(STEM_S2D_IDX.reshape(-1))
    former = torch.where((idx >= 0)[:, None, None], k[idx.clamp(min=0)],
                         torch.zeros((), dtype=torch.bfloat16))
    former = former.reshape(4, 4, 4, 8 * c, 64).permute(4, 3, 0, 1, 2)
    ours = stem_s2d_weight(torch.from_numpy(kernel).to(torch.bfloat16).permute(4, 3, 0, 1, 2))
    assert ours.shape == (64, 8 * c, 4, 4, 4)
    assert torch.equal(ours, former)

    x = torch.from_numpy(np.random.default_rng(41).normal(size=(1, 5, 6, 7, c))
                         .astype(np.float32))
    packed = stem_s2d_pack(x)
    assert packed.shape == (1, 8 * c, 3 + 3, 3 + 3, 4 + 3)
    assert packed.permute(0, 2, 3, 4, 1).is_contiguous()  # channels-last
    xp = np.pad(x.numpy(), ((0, 0), (0, 1), (0, 0), (0, 1), (0, 0)))
    for pd in range(2):
        for ph in range(2):
            for pw in range(2):
                for ci in range(c):
                    ch = ((pd * 2 + ph) * 2 + pw) * c + ci
                    want = xp[0, pd::2, ph::2, pw::2, ci]
                    got = packed[0, ch, 2:-1, 2:-1, 2:-1].numpy()
                    np.testing.assert_array_equal(got, want)
    border = packed.clone()
    border[:, :, 2:-1, 2:-1, 2:-1] = 0
    assert not border.any()


@pytest.mark.parametrize("s2d", [True, False])
def test_resnet10_matches_jax(s2d):
    """Depth 10, classifier, odd extents, float32, eval: the converted JAX
    variables give the JAX model's logits with the same stem form."""
    shape = (15, 17, 15, 1)
    jm = JaxResNet3D(depth=10, s2d_stem=s2d, dtype=jnp.float32)
    v = random_flax_variables(jm, shape, seed=50)
    x = np.random.default_rng(51).normal(size=(2, *shape)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, jnp.asarray(x)))
    tm = ResNet3D(depth=10, s2d_stem=s2d, compute_dtype=torch.float32).eval()
    assert tm.conv1.s2d is s2d
    tm.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, v), 10, "B"))
    with torch.no_grad():
        ours = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)


def test_defaults_and_one_parameter_layout(tmp_path):
    """Both factories and the encoder default to the s2d stem; the stems'
    state_dicts have the same keys and shapes; a checkpoint written by a
    plain-stem model loads into an s2d one (and back) and gives its logits
    within 1e-4."""
    assert generate_model().conv1.s2d and ResNet3D().conv1.s2d
    assert image_encoder(depth=10).conv1.s2d
    assert not image_encoder(depth=10, s2d_stem=False).conv1.s2d
    assert not generate_model(model_depth=10, s2d_stem=False).conv1.s2d
    gen = torch.Generator().manual_seed(5)
    plain = generate_model(model_depth=10, s2d_stem=False, compute_dtype=torch.float32,
                           generator=gen).eval()
    s2d = generate_model(model_depth=10, compute_dtype=torch.float32).eval()
    a, b = plain.state_dict(), s2d.state_dict()
    assert list(a) == list(b)
    assert all(a[k].shape == b[k].shape for k in a)
    assert a["conv1.weight"].shape == (64, 1, 7, 7, 7)
    ckpt.save_checkpoint(str(tmp_path / "plain"), plain.state_dict())
    s2d.load_state_dict(ckpt.restore_state(str(tmp_path / "plain"))[0])
    x = torch.from_numpy(np.random.default_rng(60).normal(size=(2, *SHAPE))
                         .astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(s2d(x), plain(x), rtol=1e-4, atol=1e-4)
    ckpt.save_checkpoint(str(tmp_path / "s2d"), s2d.state_dict())
    back = generate_model(model_depth=10, s2d_stem=False)
    back.load_state_dict(ckpt.restore_state(str(tmp_path / "s2d"))[0])


def test_s2d_stem_trains_after_an_inference_mode_forward():
    """The gather's index, cached per device, is made outside inference
    mode even when a serving forward under `torch.inference_mode` asks for
    it first, so a later train step can save it for the backward."""
    tresnet._stem_gather.cache_clear()
    m = ResNet3D(depth=10, compute_dtype=torch.float32)
    x = _batch(74, b=2)["image"]
    with torch.inference_mode():
        m.eval()(x)
    m.train()(x).sum().backward()
    assert m.conv1.weight.grad.abs().sum() > 0


def test_generate_model_drops_remat_as_jax_does():
    """`remat` falls into both factories' ``**_ignored``: it is a
    `ResNet3D` argument only."""
    assert jax_generate_model(model_depth=10, remat=True).remat is False
    assert generate_model(model_depth=10, remat=True).remat is False
    assert ResNet3D(depth=10, remat=True).remat is True


def _batch(seed, b=4):
    rng = np.random.default_rng(seed)
    return {"image": torch.from_numpy((rng.normal(size=(b, *SHAPE)) * 2 + 1)
                                      .astype(np.float32)),
            "label": torch.from_numpy((np.arange(b) % 2).astype(np.int32)),
            "mask": torch.ones(b)}


def _model(depth, dtype, remat, sd=None):
    m = ResNet3D(depth=depth, dropout_rate=0.0, compute_dtype=dtype, remat=remat,
                 generator=torch.Generator().manual_seed(7))
    if sd is not None:
        m.load_state_dict(sd)
    return m


def _step(model, batch, mesh=None):
    """One train step: the loss, the clipped gradients, the state_dict."""
    state = tloop.create_train_state(model, tloop.make_epoch_schedule(LR, 20), WD, 1.0,
                                     mesh=mesh)
    if mesh is not None:
        batch = pmesh.shard_batch(batch, mesh)
    loss, _ = tloop.train_step(state, batch, torch.from_numpy(CW))
    return {"loss": float(loss),
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
            "sd": {k: v.clone() for k, v in model.state_dict().items()}}


def _assert_same_step(a, b):
    assert a["loss"] == b["loss"]
    for k, g in b["grads"].items():
        assert torch.equal(a["grads"][k], g), k
    for k, v in b["sd"].items():
        assert torch.equal(a["sd"][k], v), k


@pytest.mark.parametrize("depth,dtype", [(10, torch.float32), (10, torch.bfloat16),
                                         (50, torch.float32)],
                         ids=["r10-f32", "r10-bf16", "r50-f32"])
def test_remat_step_equals_plain_step(depth, dtype):
    """Recomputing the blocks in the backward gives the same loss,
    gradients, parameters and running statistics as keeping their
    activations, bit for bit on the CPU, and every BatchNorm counts the
    step once."""
    batch = _batch(70, b=2 if depth == 50 else 4)
    sd = _model(depth, dtype, False).state_dict()
    plain = _step(_model(depth, dtype, False, sd), batch)
    remat = _step(_model(depth, dtype, True, sd), batch)
    _assert_same_step(remat, plain)
    tracked = [v for k, v in remat["sd"].items() if k.endswith("num_batches_tracked")]
    assert len(tracked) > 10 and all(int(t) == 1 for t in tracked)
    moved = remat["sd"]["layer1.0.bn1.running_mean"] - sd["layer1.0.bn1.running_mean"]
    assert moved.abs().max() > 0


def test_remat_leaves_eval_and_no_grad_alone():
    """Outside training with gradients the blocks run as they are: an eval
    forward and a no-grad train forward (precise-BN) equal the plain model's."""
    sd = _model(10, torch.float32, False).state_dict()
    x = _batch(71)["image"]
    plain, remat = _model(10, torch.float32, False, sd), _model(10, torch.float32, True, sd)
    with torch.no_grad():
        torch.testing.assert_close(remat.eval()(x), plain.eval()(x), rtol=0, atol=0)
        torch.testing.assert_close(remat.train()(x), plain.train()(x), rtol=0, atol=0)
    for k, v in plain.state_dict().items():
        assert torch.equal(remat.state_dict()[k], v), k


# ---- rank functions (module level: each spawned rank imports this file) ----

def _remat_steps(sd, batch):
    mesh = pmesh.make_mesh()
    return {"plain": _step(_model(10, torch.float32, False, sd), batch, mesh),
            "remat": _step(_model(10, torch.float32, True, sd), batch, mesh)}


@pytest.mark.parametrize("world", [1, 2])
def test_remat_step_under_ddp(tmp_path, world):
    """Under DDP over gloo, at one rank (the stock BatchNorm) and at two
    (the global BatchNorm): the remat step equals the plain step on each
    rank, and the ranks hold the same model; the statistics are counted
    once."""
    sd = _model(10, torch.float32, False).state_dict()
    res = run_ranks(_remat_steps, world, tmp_path, sd, _batch(73))
    for out in res:
        _assert_same_step(out["remat"], out["plain"])
        assert int(out["remat"]["sd"]["layer2.0.bn2.num_batches_tracked"]) == 1
    for k, v in res[0]["remat"]["sd"].items():
        assert torch.equal(res[-1]["remat"]["sd"][k], v), k
