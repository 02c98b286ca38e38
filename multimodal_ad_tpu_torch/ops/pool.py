"""3-D max pooling whose backward splits each window's cotangent among its
tied maxima (K4; port of the TPU package's ops/pool.py).

`max_pool_3d_fast(x, window, stride, padding)` takes a channels-last
(B, D, H, W, C) input. Its forward is the ordinary max pool (-inf padding):
stock `F.max_pool3d` on the channels-last NCDHW view. Its backward follows
the TPU package's rule: for each output m,

    count[m] = number of window elements equal to y[m] (padding never counts)
    inv[m]   = g[m] / count[m]

and each input element gets the sum of inv[m] over the windows m that hold
it and whose maximum it equals, cast to x's type. A stock max-pool backward
(ATen's, XLA's select-and-scatter) gives a window's whole cotangent to one
of its maxima instead; the two agree where no window is tied and both keep
each window's gradient mass. Ties are common after a ReLU (zero plateaus).
Only stride 2 has a backward (NotImplementedError otherwise), as in the TPU
package; the forward takes any stride.

- On a CUDA tensor the backward is `max_pool_3d_fast_backward`, which
  launches the hand-written kernel in csrc/max_pool.cu and raises on
  anything it does not take.
- On a CPU tensor it runs `max_pool_3d_fast_plain`, the TPU package's dense
  per-offset form in plain PyTorch: strided slices of the padded input, the
  equality indicator, the g / count split, and the stride-phase assembly by
  pad / stack / reshape, with its offset order and its arithmetic in g's
  type, so the CPU rounds as the TPU package does.

No model routes this function (the ResNet's pool is `nn.MaxPool3d`, as the
TPU package's is `nn.max_pool`): it is an operator of the port's API.
"""

from __future__ import annotations

import ctypes
from itertools import product

import torch
import torch.nn.functional as F

from . import _build

_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_ELEMS = 2 ** 31  # the kernel indexes in int32


def _out_extent(n: int, window: int, stride: int, padding: int) -> int:
    return (n + 2 * padding - window) // stride + 1


def _check_input(x: torch.Tensor) -> None:
    if x.dim() != 5:
        raise ValueError(f"max_pool_3d_fast takes (B, D, H, W, C), got {tuple(x.shape)}")


def max_pool_3d_fast_plain(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
                           window: int = 3, padding: int = 1) -> torch.Tensor:
    """Plain PyTorch version of `max_pool_3d_fast_backward` (stride 2):
    the TPU package's dense per-offset form, step for step."""
    b, d_in, h_in, w_in, c = x.shape
    out_sp = tuple(y.shape[1:4])
    spatial = (d_in, h_in, w_in)
    neg = (torch.finfo(x.dtype).min if x.is_floating_point()
           else torch.iinfo(x.dtype).min)
    # pad so every (offset, output-position) slice is in range:
    # input index i = 2m + o - p, m in [0, out), o in [0, window)
    hi = [max(0, 2 * (no - 1) + (window - 1) - padding - (n - 1))
          for n, no in zip(spatial, out_sp)]
    xpad = F.pad(x, (0, 0, padding, hi[2], padding, hi[1], padding, hi[0]), value=neg)

    def offset_slice(o):
        """x values each window reads at offset o, on the output grid."""
        return xpad[:, o[0]:o[0] + 2 * (out_sp[0] - 1) + 1:2,
                    o[1]:o[1] + 2 * (out_sp[1] - 1) + 1:2,
                    o[2]:o[2] + 2 * (out_sp[2] - 1) + 1:2, :]

    offsets = list(product(range(window), repeat=3))
    inds = {o: offset_slice(o) == y for o in offsets}
    count = sum(ind.to(g.dtype) for ind in inds.values())
    inv = g / count  # every window has >= 1 real max, so count >= 1

    # phase grids: i = 2q + r, r in {0, 1}; phase r covers q in [0, Qr)
    q_max = [(n + 1) // 2 for n in spatial]  # r = 0

    def q_len(ax, r):
        return (spatial[ax] - r + 1) // 2

    phases = {}
    for o in offsets:
        p_o = inds[o].to(g.dtype) * inv
        r = tuple((oa - padding) % 2 for oa in o)
        s = tuple((oa - padding - ra) // 2 for oa, ra in zip(o, r))
        # the contribution lands at q = m + s; clip to the phase's valid range
        lo = [max(0, -sa) for sa in s]
        hi_m = [min(out_sp[ax], q_len(ax, r[ax]) - s[ax]) for ax in range(3)]
        if any(lo[ax] >= hi_m[ax] for ax in range(3)):
            continue
        sl = p_o[:, lo[0]:hi_m[0], lo[1]:hi_m[1], lo[2]:hi_m[2], :]
        pads = [(lo[ax] + s[ax], q_max[ax] - (hi_m[ax] + s[ax])) for ax in range(3)]
        contrib = F.pad(sl, (0, 0, *pads[2], *pads[1], *pads[0]))
        phases[r] = contrib if r not in phases else phases[r] + contrib

    zeros = torch.zeros((b, *q_max, c), dtype=g.dtype, device=g.device)
    stacked = torch.stack([phases.get((rd, rh, rw), zeros)
                           for rd in (0, 1) for rh in (0, 1) for rw in (0, 1)])
    stacked = stacked.reshape(2, 2, 2, b, *q_max, c)
    # (rd, rh, rw, B, Qd, Qh, Qw, C) -> (B, Qd, rd, Qh, rh, Qw, rw, C) -> interleave
    grad = stacked.permute(3, 4, 0, 5, 1, 6, 2, 7).reshape(
        b, 2 * q_max[0], 2 * q_max[1], 2 * q_max[2], c)
    return grad[:, :d_in, :h_in, :w_in, :].to(x.dtype)


def _lib():
    lib = _build.load("max_pool")
    fn = lib.mad_max_pool_backward
    if fn.argtypes is None:  # first use: declare the C signature
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i, i, i, p, p, i, p]
        fn.restype = ctypes.c_int
        lib.mad_max_pool_error_string.argtypes = [ctypes.c_int]
        lib.mad_max_pool_error_string.restype = ctypes.c_char_p
    return lib


def max_pool_3d_fast_backward(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
                              window: int = 3, padding: int = 1) -> torch.Tensor:
    """The input's gradient (B, D, H, W, C) in x's type, at stride 2, from
    x, its pooled max y and y's cotangent g (both (B, OD, OH, OW, C)).

    On CUDA, x, y and g share one type (float32, bfloat16 or float16) and
    one device, and 0 <= padding < window."""
    if x.device.type == "cpu":
        return max_pool_3d_fast_plain(x, y, g, window, padding)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_input(x)
    if x.dtype not in _CODES:
        raise TypeError(f"K4 takes float32, bfloat16 or float16, got {x.dtype}")
    if y.dtype != x.dtype or g.dtype != x.dtype:
        raise TypeError(f"K4 takes one type: x {x.dtype}, y {y.dtype}, g {g.dtype}")
    if y.device != x.device or g.device != x.device:
        raise ValueError(f"x on {x.device}, y on {y.device}, g on {g.device}")
    if not 0 <= padding < window:
        raise ValueError(f"K4 needs 0 <= padding < window, got {padding}, {window}")
    b, d, h, w, c = x.shape
    out = (b, *(_out_extent(n, window, 2, padding) for n in (d, h, w)), c)
    if tuple(y.shape) != out or tuple(g.shape) != out:
        raise ValueError(f"y {tuple(y.shape)} and g {tuple(g.shape)} must be {out}")
    if x.numel() >= _MAX_ELEMS:
        raise ValueError(f"K4 indexes in int32: {x.numel()} elements")
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    if x.numel() == 0:
        return dx
    x, y, g = x.contiguous(), y.contiguous(), g.contiguous()
    inv = torch.empty(out, dtype=torch.float32, device=x.device)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.mad_max_pool_backward(
        x.data_ptr(), y.data_ptr(), g.data_ptr(), _CODES[x.dtype], b, d, h, w, c,
        *out[1:4], window, padding, inv.data_ptr(), dx.data_ptr(), x.device.index or 0,
        stream)
    if rc != 0:
        raise RuntimeError(
            f"max_pool backward launch failed: {lib.mad_max_pool_error_string(rc).decode()}")
    max_pool_3d_fast_backward.launches += 1
    return dx


max_pool_3d_fast_backward.launches = 0  # K4 launches; chip_smoke.py resets and reads it


def _max_pool(x: torch.Tensor, window: int, stride: int, padding: int) -> torch.Tensor:
    y = F.max_pool3d(x.permute(0, 4, 1, 2, 3), window, stride, padding)
    return y.permute(0, 2, 3, 4, 1).contiguous()


class _MaxPool3dFast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, window, stride, padding):
        y = _max_pool(x, window, stride, padding)
        ctx.save_for_backward(x, y)
        ctx.pool = (window, stride, padding)
        return y

    @staticmethod
    def backward(ctx, g):
        window, stride, padding = ctx.pool
        if stride != 2:
            raise NotImplementedError("max_pool_3d_fast backward: stride 2 only")
        x, y = ctx.saved_tensors
        return max_pool_3d_fast_backward(x, y, g, window, padding), None, None, None


def max_pool_3d_fast(x: torch.Tensor, window: int = 3, stride: int = 2,
                     padding: int = 1) -> torch.Tensor:
    """Max pool of a channels-last (B, D, H, W, C) tensor -> (B, OD, OH,
    OW, C), with the tie-splitting backward (see the module docstring)."""
    _check_input(x)
    return _MaxPool3dFast.apply(x, window, stride, padding)
