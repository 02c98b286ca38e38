"""Port parity on the CPU: ops/pool.py::max_pool_3d_fast (K4's plain
version on CPU tensors) against the JAX package's custom-VJP function, run
as tests/test_pool.py runs it, and the channels-last functional pools of
models/resnet3d.py against the JAX package's.

- the forward bit-equal at the five shapes of tests/test_pool.py;
- the backward on tie-free inputs within 1e-6 of the JAX gradient (the
  same dense per-offset form in the same order: float32 sums in one order);
- the all-zero input, every window tied: within 1e-6 of JAX's split, each
  window's mass kept, and at 2^3 / s2 exactly g / 8 repeated;
- bfloat16 in and out, the gradient within 1e-2 * max|g| of JAX's (each
  rounds its partial sums to bfloat16 where its compiler puts them);
- a backward at stride 3 raises NotImplementedError, as in JAX;
- on a tied input the split differs from ATen's max-pool backward, which
  gives a window's whole cotangent to one maximum: why the function exists.

K4 against this plain version on a card is in test_torch_port_guards.py
(`cuda` marker; this file imports JAX).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from multimodal_ad_tpu.models import resnet3d as jresnet
from multimodal_ad_tpu.ops.pool import max_pool_3d_fast as jax_pool
from multimodal_ad_tpu_torch.models import resnet3d as tresnet
from multimodal_ad_tpu_torch.ops import pool as tpool
from test_torch_port_support import cap_torch_threads

cap_torch_threads()

CASES = [  # tests/test_pool.py's
    (3, 2, 1, (2, 9, 9, 9, 4)),     # ResNet/DAFT stem pool, odd extents
    (3, 2, 1, (1, 16, 16, 16, 3)),  # even extents
    (2, 2, 0, (2, 8, 8, 8, 4)),     # U-Net / sNet encoder pool
    (2, 2, 0, (1, 10, 10, 10, 2)),
    (3, 2, 1, (2, 8, 7, 9, 5)),     # mixed-parity spatial dims
]
IDS = [f"{w}^3p{p}-{'x'.join(map(str, s))}" for w, _, p, s in CASES]


def _ref_pool(x, w, s, p):
    return nn.max_pool(x, (w,) * 3, strides=(s,) * 3, padding=((p, p),) * 3)


def jax_grad(x, g, w, s, p):
    """The JAX function's gradient of sum(pool(x) * g), as float32 numpy."""
    xj = jnp.asarray(x)
    gj = jnp.asarray(g)
    gx = jax.grad(lambda v: jnp.sum((jax_pool(v, w, s, p) * gj).astype(jnp.float32)))(xj)
    return np.asarray(gx.astype(jnp.float32))


def port_grad(x, g, w, s, p, dtype=torch.float32):
    """The port's gradient of sum(pool(x) * g) and its output."""
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    y = tpool.max_pool_3d_fast(xt, w, s, p)
    y.backward(torch.from_numpy(g).to(dtype))
    return xt.grad, y


@pytest.mark.parametrize("w,s,p,shape", CASES, ids=IDS)
def test_forward_bit_equal(w, s, p, shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    y = tpool.max_pool_3d_fast(torch.from_numpy(x), w, s, p)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jax_pool(jnp.asarray(x), w, s, p)))
    np.testing.assert_array_equal(y.numpy(), np.asarray(_ref_pool(jnp.asarray(x), w, s, p)))


@pytest.mark.parametrize("w,s,p,shape", CASES, ids=IDS)
def test_backward_tie_free_matches_jax(w, s, p, shape):
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32)  # continuous: no ties
    y_shape = _ref_pool(jnp.asarray(x), w, s, p).shape
    g = rng.normal(size=y_shape).astype(np.float32)
    gx, y = port_grad(x, g, w, s, p)
    assert gx.dtype == torch.float32 and gx.shape == x.shape
    np.testing.assert_allclose(gx.numpy(), jax_grad(x, g, w, s, p), rtol=0, atol=1e-6)
    # tie-free, the split is ATen's own backward
    xa = torch.from_numpy(x).requires_grad_(True)
    tresnet.max_pool_3d(xa, w, s, p).backward(torch.from_numpy(g))
    np.testing.assert_allclose(gx.numpy(), xa.grad.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("w,s,p,shape", CASES, ids=IDS)
def test_all_zero_input_splits_like_jax(w, s, p, shape):
    x = np.zeros(shape, np.float32)  # the post-ReLU plateau: every window tied
    y_shape = _ref_pool(jnp.asarray(x), w, s, p).shape
    g = np.random.default_rng(2).normal(size=y_shape).astype(np.float32)
    gx, _ = port_grad(x, g, w, s, p)
    np.testing.assert_allclose(gx.numpy(), jax_grad(x, g, w, s, p), rtol=0, atol=1e-6)
    assert abs(float(gx.double().sum()) - float(g.astype(np.float64).sum())) < 1e-5
    if w == 2:  # non-overlapping windows: each element gets g / 8
        rep = np.repeat(np.repeat(np.repeat(g, 2, 1), 2, 2), 2, 3) / 8
        np.testing.assert_array_equal(gx.numpy(), rep)


@pytest.mark.parametrize("w,s,p,shape", CASES, ids=IDS)
def test_bf16_in_and_out_within_jax(w, s, p, shape):
    rng = np.random.default_rng(4)
    # ReLU of a normal rounded to bf16: zero plateaus, ties, and ties
    # between rounded values
    x = np.maximum(rng.normal(size=shape), 0).astype(jnp.bfloat16)
    y_shape = _ref_pool(jnp.asarray(x), w, s, p).shape
    g = rng.normal(size=y_shape).astype(jnp.bfloat16)
    gx, y = port_grad(x.astype(np.float32), g.astype(np.float32), w, s, p, torch.bfloat16)
    assert y.dtype == torch.bfloat16 and gx.dtype == torch.bfloat16
    ref = jax_grad(x, g, w, s, p)
    bound = 1e-2 * float(np.abs(g.astype(np.float32)).max())
    np.testing.assert_allclose(gx.float().numpy(), ref, rtol=0, atol=bound)


def test_backward_at_stride_3_raises():
    x = torch.randn((1, 9, 9, 9, 2), generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    y = tpool.max_pool_3d_fast(x, 3, 3, 1)  # the forward takes any stride
    with pytest.raises(NotImplementedError, match="stride 2 only"):
        y.sum().backward()
    with pytest.raises(NotImplementedError, match="stride 2 only"):
        jax.grad(lambda v: jnp.sum(jax_pool(v, 3, 3, 1)))(jnp.asarray(x.detach().numpy()))


def test_tied_split_differs_from_aten():
    x = np.zeros((1, 8, 8, 8, 2), np.float32)
    g = np.random.default_rng(5).normal(size=(1, 4, 4, 4, 2)).astype(np.float32)
    gx, _ = port_grad(x, g, 3, 2, 1)
    xa = torch.from_numpy(x).requires_grad_(True)
    tresnet.max_pool_3d(xa, 3, 2, 1).backward(torch.from_numpy(g))
    # both keep the mass; ATen puts it on one element a window
    assert abs(float(xa.grad.double().sum()) - float(gx.double().sum())) < 1e-5
    assert float((gx - xa.grad).abs().max()) > 0.1
    assert int((xa.grad != 0).sum()) <= g.size < int((gx != 0).sum())


def test_plain_backward_is_the_wrapper_on_the_cpu():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(np.maximum(rng.normal(size=(2, 9, 7, 8, 3)), 0).astype(np.float32))
    y = tpool.max_pool_3d_fast(x)
    g = torch.from_numpy(rng.normal(size=tuple(y.shape)).astype(np.float32))
    before = tpool.max_pool_3d_fast_backward.launches
    dx = tpool.max_pool_3d_fast_backward(x, y, g, 3, 1)
    assert tpool.max_pool_3d_fast_backward.launches == before  # no kernel on the CPU
    assert torch.equal(dx, tpool.max_pool_3d_fast_plain(x, y, g, 3, 1))


@pytest.mark.parametrize("window,stride,padding", [(3, 2, 1), (2, 2, 0), (3, 1, 1)])
def test_functional_max_pool_matches_jax(window, stride, padding):
    x = np.random.default_rng(7).normal(size=(2, 9, 8, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tresnet.max_pool_3d(torch.from_numpy(x), window, stride, padding).numpy(),
        np.asarray(jresnet.max_pool_3d(jnp.asarray(x), window, stride, padding)))


@pytest.mark.parametrize("window,stride,padding", [(1, 2, 0), (2, 2, 0), (3, 2, 1)])
def test_functional_avg_pool_matches_jax(window, stride, padding):
    x = np.random.default_rng(8).normal(size=(2, 9, 8, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tresnet.avg_pool_3d(torch.from_numpy(x), window, stride, padding).numpy(),
        np.asarray(jresnet.avg_pool_3d(jnp.asarray(x), window, stride, padding)),
        rtol=0, atol=1e-6)


def test_global_avg_pool_matches_jax():
    x = np.random.default_rng(9).normal(size=(3, 5, 6, 4, 7)).astype(np.float32)
    out = tresnet.global_avg_pool(torch.from_numpy(x))
    assert out.shape == (3, 7)
    np.testing.assert_allclose(out.numpy(), np.asarray(jresnet.global_avg_pool(jnp.asarray(x))),
                               rtol=0, atol=1e-6)
