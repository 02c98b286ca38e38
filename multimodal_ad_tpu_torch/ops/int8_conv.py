"""int8 x int8 -> int32 3-D convolution with a fused epilogue (K3).

Port of the TPU package's models/resnet3d_int8.py::_conv_i8 (an XLA
conv_general_dilated with int32 accumulation) and of the elementwise work
around it in its _forward. Activations are NDHWC int8; weights are laid
[C_out][kd][kh][kw][C_in] (`relayout_weight` turns the exported DHWIO
array into that layout once). Zero padding is d * (k - 1) / 2 on each side.

Epilogues, chosen per call:

- ``"int32"``: the accumulator;
- ``"int8"``: ``clip(round(relu(o * k[c] + b[c]) / s_next), -127, 127)``,
  the dequant, ReLU and next quant point of a block's inner conv;
- ``"float32"``: ``o * k[c] + b[c]``, a block's shortcut conv;
- ``"block_out"``: a block's last conv with its output, ``h =
  bf16(relu(o * k[c] + b[c] + r))`` for the `residual` r (the identity's
  bf16 input or the shortcut's float32 output), and, given `s_next`, the
  next block's input quant point ``clip(round(float(h) / s_next), -127,
  127)``; returns ``(h, hq)``, hq None without `s_next`.

``k[c] = s_act * s_w[c]`` is the float32 product of the input's activation
scale and the channel's weight scale. The float operations are the TPU
package's, in its order: a multiply, then an add, then a true division,
then a round half to even.

- On a CUDA tensor `conv_i8` launches the hand-written kernel in
  csrc/int8_conv.cu, and raises on anything the kernel does not take.
  `tile_plan` picks its tiles: 64, 128 or 256 output channels, and for a
  3^3 conv a box of output voxels whose taps at the volume's faces fall
  away whole (the kernel skips, per tile, the taps no row of it needs).
- On a CPU tensor it runs `conv_i8_plain` and the plain epilogues. The
  plain convolution is F.conv3d in float64 on the int8 values: every
  product and partial sum is an integer below 2**53 (|sum| <= 127**2 *
  27 * 2048 < 2**31), so it is exact and bit-equal to the kernel's int32;
  float32 would not be exact above 2**24.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

EPILOGUES = {"int32": 0, "int8": 1, "float32": 2, "block_out": 3}
_OUT_DTYPES = {"int32": torch.int32, "int8": torch.int8, "float32": torch.float32,
               "block_out": torch.bfloat16}
TILE_ROWS = 128  # output voxels of a tile (two warpgroups of 64)
TILE_CHANNELS = (256, 128, 64)


def relayout_weight(w_dhwio: torch.Tensor) -> torch.Tensor:
    """(k, k, k, C_in, C_out) -> contiguous (C_out, k, k, k, C_in)."""
    return w_dhwio.permute(4, 0, 1, 2, 3).contiguous()


def _out_shape(x_shape, w_shape, stride: int, dilation: int) -> tuple:
    """(B, D_out, H_out, W_out, C_out) of the convolution."""
    b, *spatial, _ = x_shape
    n, k = w_shape[0], w_shape[1]
    pad = dilation * (k - 1) // 2
    return (b, *[(s + 2 * pad - dilation * (k - 1) - 1) // stride + 1 for s in spatial], n)


def conv_i8_plain(xq: torch.Tensor, wq: torch.Tensor, stride: int = 1,
                  dilation: int = 1) -> torch.Tensor:
    """Plain version: NDHWC int8 `xq`, (C_out, k, k, k, C_in) int8 `wq`
    -> NDHWC int32 sums, exact (float64 convolution of integers)."""
    k = wq.shape[1]
    pad = dilation * (k - 1) // 2
    o = F.conv3d(xq.permute(0, 4, 1, 2, 3).double(), wq.permute(0, 4, 1, 2, 3).double(),
                 stride=stride, padding=pad, dilation=dilation)
    return torch.round(o).to(torch.int32).permute(0, 2, 3, 4, 1).contiguous()


def dequant(acc: torch.Tensor, k: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 ``acc * k + b`` over the last (channel) axis: two roundings."""
    return acc.float() * k + b


def quantize(h: torch.Tensor, scale) -> torch.Tensor:
    """``clip(round(h / scale), -127, 127)`` as int8: a true division, then
    round half to even, as the TPU package's _quantize. `scale` (a float or
    a float32 tensor) is divided by as a tensor on `h`'s device: PyTorch's
    CUDA division by a host scalar multiplies by its reciprocal instead."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=h.device)
    return torch.round(h.float() / s).clamp_(-127, 127).to(torch.int8)


def epilogue_plain(acc: torch.Tensor, epilogue: str, k=None, b=None,
                   s_next: float | None = None, residual: torch.Tensor | None = None):
    """The epilogue of `conv_i8` on an int32 accumulator, in plain torch."""
    if epilogue == "int32":
        return acc
    h = dequant(acc, k, b)
    if epilogue == "float32":
        return h
    if epilogue == "block_out":
        h = torch.relu(h + residual.float()).to(torch.bfloat16)
        return h, (None if s_next is None else quantize(h, s_next))
    return quantize(torch.relu(h), s_next)


class TilePlan(NamedTuple):
    """K3's tiling of one convolution: `bn` output channels a tile, `box`
    (TD, TH, TW) output voxels a tile or None for flat 128-row tiles,
    `m_tiles` x `n_tiles` blocks, and `executed_taps`, the share of the
    dense (row, tap) pairs that the kernel multiplies (rows of a tile past
    the grid and taps that some row of the tile needs included)."""
    bn: int
    box: tuple | None
    m_tiles: int
    n_tiles: int
    executed_taps: float


def _live_taps(n_in: int, ksize: int, stride: int, dilation: int) -> np.ndarray:
    """(n_out, ksize) bool: tap t of output o lands inside [0, n_in)."""
    pad = dilation * (ksize - 1) // 2
    n_out = (n_in + 2 * pad - dilation * (ksize - 1) - 1) // stride + 1
    q = np.arange(n_out)[:, None] * stride - pad + np.arange(ksize)[None] * dilation
    return (q >= 0) & (q < n_in)


def _tap_sums(live: np.ndarray) -> np.ndarray:
    """[t - 1]: the taps some output of each run of t needs, summed over
    the runs that cut the axis into pieces of t."""
    n = live.shape[0]
    return np.array([sum(int(live[s:s + t].any(0).sum()) for s in range(0, n, t))
                     for t in range(1, min(n, TILE_ROWS) + 1)])


@functools.lru_cache(maxsize=512)
def tile_plan(x_shape: tuple, w_shape: tuple, stride: int = 1, dilation: int = 1,
              sms: int = 132) -> TilePlan:
    """K3's tiles for NDHWC `x_shape` and (C_out, k, k, k, C_in) `w_shape`
    on a card of `sms` multiprocessors.

    The channel tile is the one of 256, 128, 64 that pads C_out least (the
    widest of those that tie), so a 512-channel conv gathers its input
    tile twice. A 1^3 conv takes flat 128-row tiles (it has one tap, always
    inside). A 3^3 conv takes boxes of output voxels: the tap sums factor
    over the axes, so each (TD, TH, TW) with TD TH TW <= 128 is scored in
    closed form by the taps its tiles execute, times the grid's waves over
    the blocks' mean (blocks of 64 channels run two to a multiprocessor),
    and the best box wins, fewer tiles breaking ties."""
    batch, *grid, _ = x_shape
    n, ksize = w_shape[0], w_shape[1]
    bn = min(TILE_CHANNELS, key=lambda t: (-(-n // t) * t, -t))
    n_tiles = -(-n // bn)
    lives = [_live_taps(s, ksize, stride, dilation) for s in grid]
    outs = [lv.shape[0] for lv in lives]
    m = batch * outs[0] * outs[1] * outs[2]
    if ksize == 1:
        m_tiles = -(-m // TILE_ROWS)
        return TilePlan(bn, None, m_tiles, n_tiles, float(m_tiles * TILE_ROWS / m))
    slots = sms * (2 if bn == 64 else 1)
    sums = [_tap_sums(lv) for lv in lives]
    best = None
    boxes = ((td, th, tw) for td in range(1, len(sums[0]) + 1)
             for th in range(1, min(len(sums[1]), TILE_ROWS // td) + 1)
             for tw in range(1, min(len(sums[2]), TILE_ROWS // (td * th)) + 1))
    for td, th, tw in boxes:
        tiles = -(-outs[0] // td) * -(-outs[1] // th) * -(-outs[2] // tw)
        executed = sums[0][td - 1] * sums[1][th - 1] * sums[2][tw - 1]  # per sample
        blocks = batch * tiles * n_tiles
        score = executed * (-(-blocks // slots) * slots / blocks)
        key = (score, tiles)
        if best is None or key < best[0]:
            best = (key, (td, th, tw), tiles, executed)
    _, box, tiles, executed = best
    return TilePlan(bn, box, batch * tiles, n_tiles,
                    float(batch * executed * TILE_ROWS / (m * ksize ** 3)))


def _lib():
    lib = _build.load("int8_conv")
    fn = lib.mad_conv_i8
    if fn.argtypes is None:  # first use: declare the C signature
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, p, i, f] + [i] * 17 + [p]
        fn.restype = ctypes.c_int
        lib.mad_conv_i8_error_string.argtypes = [ctypes.c_int]
        lib.mad_conv_i8_error_string.restype = ctypes.c_char_p
    return lib


def _check(xq: torch.Tensor, wq: torch.Tensor, epilogue: str, k, b, s_next, residual,
           stride: int, dilation: int) -> tuple:
    """Raise on what K3 does not take; return the output shape."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; choose from {tuple(EPILOGUES)}")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"K3 takes int8 activations and weights, got {xq.dtype}, {wq.dtype}")
    if xq.dim() != 5 or wq.dim() != 5:
        raise ValueError("K3 takes NDHWC activations and (C_out, k, k, k, C_in) weights")
    ksize = wq.shape[1]
    if ksize not in (1, 3) or tuple(wq.shape[1:4]) != (ksize,) * 3:
        raise ValueError(f"K3 takes cubic kernels of size 1 or 3, got {tuple(wq.shape)}")
    if wq.shape[4] != xq.shape[4]:
        raise ValueError(f"weights take {wq.shape[4]} input channels, input has {xq.shape[4]}")
    out_shape = _out_shape(xq.shape, wq.shape, stride, dilation)
    if epilogue != "int32":
        n = wq.shape[0]
        for name, t in (("k", k), ("b", b)):
            if not (isinstance(t, torch.Tensor) and t.dtype == torch.float32
                    and tuple(t.shape) == (n,)):
                raise ValueError(f"epilogue {epilogue!r} needs {name} as ({n},) float32")
        if epilogue == "int8" and s_next is None:
            raise ValueError("the int8 epilogue needs s_next")
    if epilogue == "block_out":
        if not (isinstance(residual, torch.Tensor)
                and residual.dtype in (torch.bfloat16, torch.float32)
                and tuple(residual.shape) == tuple(out_shape)):
            raise ValueError(f"the block_out epilogue needs a {tuple(out_shape)} bfloat16 or "
                             f"float32 residual")
    elif residual is not None:
        raise ValueError(f"epilogue {epilogue!r} takes no residual")
    return out_shape


def conv_i8(xq: torch.Tensor, wq: torch.Tensor, stride: int = 1, dilation: int = 1,
            epilogue: str = "int32", k: torch.Tensor | None = None,
            b: torch.Tensor | None = None, s_next: float | None = None,
            residual: torch.Tensor | None = None):
    """int8 convolution of NDHWC `xq` with (C_out, k, k, k, C_in) `wq`,
    zero padding dilation * (k - 1) / 2, then `epilogue` ("int32", "int8",
    "float32" or "block_out", with `k`, `b` (C_out,) float32, for "int8"
    the next quant point's `s_next`, for "block_out" the `residual` and
    optionally `s_next`). Returns NDHWC (B, D', H', W', C_out), or for
    "block_out" the pair (bf16 h, int8 hq or None).

    On CUDA every tensor is contiguous and 16-byte aligned, C_in % 32 == 0
    and C_out % 8 == 0, or it raises."""
    shape = _check(xq, wq, epilogue, k, b, s_next, residual, stride, dilation)
    s_next = None if s_next is None else float(s_next)
    if xq.device.type == "cpu" and wq.device.type == "cpu":
        return epilogue_plain(conv_i8_plain(xq, wq, stride, dilation), epilogue, k, b, s_next,
                              residual)
    if xq.device.type != "cuda":
        raise ValueError(f"unsupported device {xq.device}")
    tensors = ([xq, wq] + ([k, b] if epilogue != "int32" else [])
               + ([residual] if residual is not None else []))
    if any(t.device != xq.device for t in tensors):
        raise ValueError("K3's tensors must all be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("K3 needs contiguous tensors")
    c_in, c_out = xq.shape[4], wq.shape[0]
    if c_in % 32 or c_out % 8:
        raise ValueError(f"K3 needs C_in % 32 == 0 and C_out % 8 == 0, got {c_in}, {c_out}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("K3 needs 16-byte aligned tensors")
    if stride < 1 or dilation < 1:
        raise ValueError(f"stride {stride} and dilation {dilation} must be >= 1")
    out = torch.empty(shape, dtype=_OUT_DTYPES[epilogue], device=xq.device)
    out_q = (torch.empty(shape, dtype=torch.int8, device=xq.device)
             if epilogue == "block_out" and s_next is not None else None)
    result = (out, out_q) if epilogue == "block_out" else out
    if out.numel() == 0:
        return result
    plan = tile_plan(tuple(xq.shape), tuple(wq.shape), stride, dilation, _sms(xq.device))
    td, th, tw = plan.box or (0, 0, 0)
    lib = _lib()
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    bsz, d, h, w, _ = xq.shape

    def ptr(t):
        return t.data_ptr() if t is not None else None

    rc = lib.mad_conv_i8(
        xq.data_ptr(), wq.data_ptr(), out.data_ptr(), ptr(out_q), ptr(k), ptr(b),
        ptr(residual), int(residual is not None and residual.dtype == torch.float32),
        s_next if s_next is not None else 1.0, bsz, d, h, w, c_in, c_out, wq.shape[1],
        stride, dilation, shape[1], shape[2], shape[3], plan.bn, td, th, tw,
        EPILOGUES[epilogue], stream)
    if rc != 0:
        raise RuntimeError(
            f"int8_conv launch failed: {lib.mad_conv_i8_error_string(rc).decode()}")
    conv_i8.launches += 1
    return result


@functools.lru_cache(maxsize=8)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


conv_i8.launches = 0  # K3 launches; chip_smoke.py resets and reads it
