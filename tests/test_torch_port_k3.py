"""K3's block-output epilogue and tile plan on the CPU, against the JAX
package's expressions on the same numpy-seeded inputs:

- `epilogue_plain(..., "block_out")` against the TPU package's
  ``relu(o + r).astype(bf16)`` and its `_quantize` of that output (the next
  block's input quant point): bit-equal with bf16 and float32 residuals,
  on sums that land on bf16 rounding ties and on quant-point ties;
- `conv_i8`'s CPU path with that epilogue, and what it refuses;
- `tile_plan`'s closed-form count of the taps the kernel executes against
  a brute-force count over its tiles, and its boxes within 128 rows.

The kernel itself runs on the card only: its `cuda` tests are in
tests/test_torch_port_guards.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_ad_tpu.models import resnet3d_int8 as jq8
from multimodal_ad_tpu_torch.ops import int8_conv as k3
from test_torch_port_support import cap_torch_threads

cap_torch_threads()


def _jax_block_out(acc, k, b, r, s_next):
    """The TPU package's block output from int32 sums: dequant, residual
    add, ReLU, bf16 cast; then the next block's input quant point."""
    o = jnp.asarray(acc).astype(jnp.float32) * k + b
    h = jax.nn.relu(o + jnp.asarray(r).astype(jnp.float32)).astype(jnp.bfloat16)
    return h, jq8._quantize(h, s_next)


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _assert_block_out_matches(acc, k, b, r, s_next):
    jh, jq = _jax_block_out(acc, k, b, r, s_next)
    h, q = k3.epilogue_plain(torch.from_numpy(acc), "block_out", torch.from_numpy(k),
                             torch.from_numpy(b), s_next, _to_torch(r))
    assert h.dtype == torch.bfloat16 and q.dtype == torch.int8
    ref_h = _to_torch(jh)
    assert torch.equal(h.view(torch.int16), ref_h.view(torch.int16))  # bit for bit
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    return h, q


@pytest.mark.parametrize("residual", ["bfloat16", "float32"])
def test_block_out_matches_the_tpu_expression(residual):
    """Calibration-sized dequant factors, full-range sums, and a residual
    of either type (the identity's bf16 input, the shortcut's float32)."""
    rng = np.random.default_rng(7)
    acc = rng.integers(-3_000_000, 3_000_000, (2, 5, 4, 6, 24)).astype(np.int32)
    s_act = 0.0123456789
    k = (np.float32(s_act) * rng.uniform(1e-4, 1e-2, 24).astype(np.float32))
    b = rng.normal(0, 0.5, 24).astype(np.float32)
    r = rng.normal(0, 3, acc.shape).astype(np.float32)
    if residual == "bfloat16":
        r = np.asarray(jnp.asarray(r, jnp.bfloat16))
    h, q = _assert_block_out_matches(acc, k, b, r, 0.0713)
    assert (h.float() == 0).any() and (h.float() > 0).any()  # the ReLU bites somewhere
    assert int(q.max()) == 127  # and the quant point saturates


def test_block_out_rounds_ties_to_even():
    """Sums on bf16 rounding ties (o + r odd in [256, 512), where bf16
    steps by 2) and on quant-point ties (h / 2 = n + 0.5): half to even
    in both roundings, as the TPU package does."""
    ones, zeros = np.ones(8, np.float32), np.zeros(8, np.float32)
    acc = np.arange(256, 512, dtype=np.int32).reshape(32, 8)
    h, _ = _assert_block_out_matches(acc, ones, zeros, np.ones_like(acc, np.float32), 1.0)
    odd = (acc + 1) % 2 == 1
    assert (h.float().numpy()[odd] % 4 == 0).all()  # every tie went to the even neighbour
    small = np.arange(-8, 120, dtype=np.int32).reshape(16, 8)
    r = np.asarray(jnp.zeros(small.shape, jnp.bfloat16))
    _, q = _assert_block_out_matches(small, ones, zeros, r, 2.0)
    ties = q.numpy()[(small > 0) & (small % 2 == 1)]
    assert (ties % 2 == 0).all() and q.numpy()[small < 0].max() == 0


def test_conv_i8_block_out_on_the_cpu():
    """The CPU path: conv_i8_plain, then the block-output epilogue; hq is
    None without the next quant point; a residual of the wrong shape or
    type, or given to another epilogue, is refused."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.integers(-127, 128, (2, 5, 6, 4, 32), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (16, 3, 3, 3, 32), dtype=np.int8))
    k = torch.from_numpy(rng.uniform(1e-6, 2e-5, 16).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.5, 16).astype(np.float32))
    r = torch.from_numpy(rng.normal(0, 1, (2, 5, 6, 4, 16)).astype(np.float32))
    h, q = k3.conv_i8(x, w, 1, 2, "block_out", k, b, 0.01, r)
    ref = k3.epilogue_plain(k3.conv_i8_plain(x, w, 1, 2), "block_out", k, b, 0.01, r)
    assert torch.equal(h, ref[0]) and torch.equal(q, ref[1])
    h2, q2 = k3.conv_i8(x, w, 1, 2, "block_out", k, b, None, r.to(torch.bfloat16))
    assert q2 is None and h2.dtype == torch.bfloat16 and h2.shape == r.shape
    with pytest.raises(ValueError):  # no residual
        k3.conv_i8(x, w, 1, 2, "block_out", k, b, 0.01)
    with pytest.raises(ValueError):  # a residual of another grid
        k3.conv_i8(x, w, 2, 2, "block_out", k, b, 0.01, r)
    with pytest.raises(ValueError):  # an int8 residual
        k3.conv_i8(x, w, 1, 2, "block_out", k, b, 0.01, r.to(torch.int8))
    with pytest.raises(ValueError):  # a residual for the float32 epilogue
        k3.conv_i8(x, w, 1, 2, "float32", k, b, None, r)


def _brute_executed_taps(x_shape, w_shape, stride, dil, plan):
    """(the (row, tap) pairs the kernel multiplies under `plan`, counted
    tile by tile from every row's taps inside the volume; the pairs inside
    the volume), both over the dense pairs."""
    batch, *grid, _ = x_shape
    ksize = w_shape[1]
    pad = dil * (ksize - 1) // 2
    outs = [(s + 2 * pad - dil * (ksize - 1) - 1) // stride + 1 for s in grid]
    taps = np.array([(a, b, c) for a in range(ksize) for b in range(ksize)
                     for c in range(ksize)])
    o = np.stack(np.meshgrid(*[np.arange(n) for n in outs], indexing="ij"), -1)
    q = o[..., None, :] * stride - pad + taps * dil
    live = ((q >= 0) & (q < np.array(grid))).all(-1)  # (D', H', W', taps)
    inside = live.sum() / live.size
    td, th, tw = plan.box
    executed = 0
    for d0 in range(0, outs[0], td):
        for h0 in range(0, outs[1], th):
            for w0 in range(0, outs[2], tw):
                box = live[d0:d0 + td, h0:h0 + th, w0:w0 + tw]
                executed += int(box.reshape(-1, taps.shape[0]).any(0).sum())
    return executed * k3.TILE_ROWS / (np.prod(outs) * ksize ** 3), inside


@pytest.mark.parametrize("x_shape,w_shape,stride,dil", [
    ((8, 12, 14, 12, 512), (512, 3, 3, 3, 512), 1, 4),   # stage 4
    ((8, 12, 14, 12, 256), (256, 3, 3, 3, 256), 1, 2),   # stage 3
    ((8, 23, 28, 23, 64), (64, 3, 3, 3, 64), 1, 1),      # stage 1
    ((8, 23, 28, 23, 64), (128, 3, 3, 3, 64), 2, 1),     # stage 2 b0 conv1
    ((2, 2, 3, 2, 64), (64, 3, 3, 3, 64), 1, 4),         # tiles that lose most taps
    ((2, 5, 14, 3, 128), (256, 3, 3, 3, 128), 1, 4),
    ((3, 13, 15, 11, 96), (40, 3, 3, 3, 96), 1, 2),
])
def test_tile_plan_counts_the_taps_it_executes(x_shape, w_shape, stride, dil):
    plan = k3.tile_plan(x_shape, w_shape, stride, dil)
    assert plan.box is not None and np.prod(plan.box) <= k3.TILE_ROWS
    assert plan.bn in k3.TILE_CHANNELS and plan.n_tiles * plan.bn >= w_shape[0]
    brute, inside = _brute_executed_taps(x_shape, w_shape, stride, dil, plan)
    assert plan.executed_taps == pytest.approx(brute, rel=1e-12)
    assert plan.executed_taps >= inside  # never fewer pairs than those inside the volume


def test_tile_plan_skips_whole_taps_at_stage_4():
    """Stage 4's dilation-4 convs keep 49 % of their dense taps inside the
    12 x 14 x 12 grid; the boxes let the kernel drop a third of the dense
    pairs (flat 128-row tiles would drop about a fifth)."""
    x, w = (8, 12, 14, 12, 512), (512, 3, 3, 3, 512)
    plan = k3.tile_plan(x, w, 1, 4)
    executed, inside = _brute_executed_taps(x, w, 1, 4, plan)
    assert inside == pytest.approx(0.4897, abs=1e-4) and executed == plan.executed_taps
    assert plan.executed_taps < 0.75 and plan.bn == 256 and plan.n_tiles == 2
    one = k3.tile_plan((8, 12, 14, 12, 256), (512, 1, 1, 1, 256))
    assert one.box is None and one.m_tiles == 126 and one.executed_taps == 1.0
