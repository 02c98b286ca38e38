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
- ``"float32"``: ``o * k[c] + b[c]``, a block's last conv and shortcut.

``k[c] = s_act * s_w[c]`` is the float32 product of the input's activation
scale and the channel's weight scale. The float operations are the TPU
package's, in its order: a multiply, then an add, then a true division,
then a round half to even.

- On a CUDA tensor `conv_i8` launches the hand-written kernel in
  csrc/int8_conv.cu, and raises on anything the kernel does not take.
- On a CPU tensor it runs `conv_i8_plain` and the plain epilogues. The
  plain convolution is F.conv3d in float64 on the int8 values: every
  product and partial sum is an integer below 2**53 (|sum| <= 127**2 *
  27 * 512 < 2**31), so it is exact and bit-equal to the kernel's int32;
  float32 would not be exact above 2**24.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

EPILOGUES = {"int32": 0, "int8": 1, "float32": 2}
_OUT_DTYPES = {"int32": torch.int32, "int8": torch.int8, "float32": torch.float32}


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
                   s_next: float | None = None) -> torch.Tensor:
    """The epilogue of `conv_i8` on an int32 accumulator, in plain torch."""
    if epilogue == "int32":
        return acc
    h = dequant(acc, k, b)
    if epilogue == "float32":
        return h
    return quantize(torch.relu(h), s_next)


def _lib():
    lib = _build.load("int8_conv")
    fn = lib.mad_conv_i8
    if fn.argtypes is None:  # first use: declare the C signature
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, f, i, i, i, i, i, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.mad_conv_i8_error_string.argtypes = [ctypes.c_int]
        lib.mad_conv_i8_error_string.restype = ctypes.c_char_p
    return lib


def _check(xq: torch.Tensor, wq: torch.Tensor, epilogue: str, k, b, s_next):
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
    if epilogue != "int32":
        n = wq.shape[0]
        for name, t in (("k", k), ("b", b)):
            if not (isinstance(t, torch.Tensor) and t.dtype == torch.float32
                    and tuple(t.shape) == (n,)):
                raise ValueError(f"epilogue {epilogue!r} needs {name} as ({n},) float32")
        if epilogue == "int8" and s_next is None:
            raise ValueError("the int8 epilogue needs s_next")


def conv_i8(xq: torch.Tensor, wq: torch.Tensor, stride: int = 1, dilation: int = 1,
            epilogue: str = "int32", k: torch.Tensor | None = None,
            b: torch.Tensor | None = None, s_next: float | None = None) -> torch.Tensor:
    """int8 convolution of NDHWC `xq` with (C_out, k, k, k, C_in) `wq`,
    zero padding dilation * (k - 1) / 2, then `epilogue` ("int32", "int8"
    or "float32", with `k`, `b` (C_out,) float32 and, for "int8", the next
    quant point's `s_next`). Returns NDHWC (B, D', H', W', C_out).

    On CUDA both tensors are contiguous and 16-byte aligned, C_in % 32 ==
    0 and C_out % 8 == 0, or it raises."""
    _check(xq, wq, epilogue, k, b, s_next)
    s_next = None if s_next is None else float(s_next)
    if xq.device.type == "cpu" and wq.device.type == "cpu":
        return epilogue_plain(conv_i8_plain(xq, wq, stride, dilation), epilogue, k, b, s_next)
    if xq.device.type != "cuda":
        raise ValueError(f"unsupported device {xq.device}")
    tensors = [xq, wq] + ([k, b] if epilogue != "int32" else [])
    if any(t.device != xq.device for t in tensors):
        raise ValueError("K3's tensors must all be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("K3 needs contiguous tensors")
    c_in, c_out = xq.shape[4], wq.shape[0]
    if c_in % 32 or c_out % 8:
        raise ValueError(f"K3 needs C_in % 32 == 0 and C_out % 8 == 0, got {c_in}, {c_out}")
    if xq.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("K3 needs 16-byte aligned activations and weights")
    if stride < 1 or dilation < 1:
        raise ValueError(f"stride {stride} and dilation {dilation} must be >= 1")
    shape = _out_shape(xq.shape, wq.shape, stride, dilation)
    out = torch.empty(shape, dtype=_OUT_DTYPES[epilogue], device=xq.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    bsz, d, h, w, _ = xq.shape
    rc = lib.mad_conv_i8(
        xq.data_ptr(), wq.data_ptr(), out.data_ptr(),
        k.data_ptr() if k is not None else None, b.data_ptr() if b is not None else None,
        s_next if s_next is not None else 1.0, bsz, d, h, w, c_in, c_out, wq.shape[1],
        stride, dilation, shape[1], shape[2], shape[3], EPILOGUES[epilogue], stream)
    if rc != 0:
        raise RuntimeError(
            f"int8_conv launch failed: {lib.mad_conv_i8_error_string(rc).decode()}")
    conv_i8.launches += 1
    return out


conv_i8.launches = 0  # K3 launches; chip_smoke.py resets and reads it
