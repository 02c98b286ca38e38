"""Fused gather + per-volume min-max normalize (K1).

Port of the TPU package's ops/fused_gather.py::gather_normalize_pallas.
For each batch slot i the function takes volume ``src[indices[i]]``, finds
its min and max, and returns ``(x - lo) * (1 / (hi - lo + 1e-30))``, or 0
where ``hi - lo < 1e-12`` (scale_intensity semantics).

- On a CUDA tensor `gather_normalize` launches the hand-written kernel in
  csrc/fused_gather.cu, and raises on anything the kernel does not take.
- On a CPU tensor it runs `gather_normalize_plain`, the plain PyTorch
  version, which performs the same float32 operations in the same order.

Rounding. Both versions multiply by a correctly rounded reciprocal, as the
Pallas kernel does (fused_gather.py:84-86 there). The XLA twin and the
device `scale_intensity` of the TPU package divide by ``hi - lo + 1e-30``,
and the host transform divides by ``hi - lo``; for any range >= 1e-12 the
1e-30 is below half an ulp, so those two divisions are identical. The
reciprocal form differs from the division by at most 2 ulp of the result
(two roundings instead of one: at most 1.2e-7 absolute on [0, 1]).

The TPU layout of a corpus padded to (R, 128) rows is dropped: the kernel
reads a contiguous (N, ...) source, flattening all non-batch axes.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

_SRC_CODES = {torch.uint8: 0, torch.int16: 1, torch.float32: 2}
_IDX_CODES = {torch.int32: 0, torch.int64: 1}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (device index, stream) -> the kernel's scratch of 8 float2 per SM,
# allocated once: launches on one stream run in order, so they share it.
_SCRATCH: dict[tuple[int, int], torch.Tensor] = {}


def gather_normalize_plain(src: torch.Tensor, indices: torch.Tensor,
                           out_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version: (N, ...) source, (B,) indices -> (B, ...)
    normalized per volume, in `out_dtype`."""
    n = src.shape[0]
    idx = indices.to(device=src.device, dtype=torch.long)
    x = src.reshape(n, -1)[idx].to(torch.float32)
    lo = x.amin(dim=1, keepdim=True)
    hi = x.amax(dim=1, keepdim=True)
    rng = hi - lo
    scale = torch.where(rng < 1e-12, torch.zeros_like(rng), 1.0 / (rng + 1e-30))
    out = ((x - lo) * scale).to(out_dtype)
    return out.reshape((idx.shape[0],) + tuple(src.shape[1:]))


def _as_indices(indices, n: int) -> torch.Tensor:
    """Indices as a 1-D tensor; host indices are range-checked here (a
    device tensor is not read back: the kernel writes NaN rows for an
    out-of-range index instead of reading out of bounds)."""
    if not isinstance(indices, torch.Tensor):
        indices = torch.from_numpy(np.asarray(indices))
    if indices.dim() != 1:
        raise ValueError(f"indices must be 1-D, got shape {tuple(indices.shape)}")
    if indices.dtype not in _IDX_CODES:
        raise TypeError(f"indices must be int32 or int64, got {indices.dtype}")
    if indices.device.type == "cpu" and indices.numel():
        lo, hi = int(indices.min()), int(indices.max())
        if lo < 0 or hi >= n:
            raise IndexError(f"indices span [{lo}, {hi}], outside [0, {n})")
    return indices


def _lib():
    lib = _build.load("fused_gather")
    fn = lib.mad_gather_normalize
    if fn.argtypes is None:  # first use: declare the C signature
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, i, ll, ll, p, i, i, p, i, p, i, p, p, p]
        fn.restype = ctypes.c_int
        lib.mad_error_string.argtypes = [ctypes.c_int]
        lib.mad_error_string.restype = ctypes.c_char_p
    return lib


def _scratch(device: torch.device, stream: int) -> torch.Tensor:
    key = (device.index or 0, stream)
    if key not in _SCRATCH:
        n_sm = torch.cuda.get_device_properties(device).multi_processor_count
        _SCRATCH[key] = torch.empty(16 * n_sm, dtype=torch.float32, device=device)
    return _SCRATCH[key]


def gather_normalize(src: torch.Tensor, indices, out_dtype=torch.float32
                     ) -> torch.Tensor:
    """Gather ``src[indices]`` and min-max normalize each volume.

    `src` is (N, ...) and contiguous; on CUDA its dtype is uint8, int16 or
    float32 and `out_dtype` float32 or bfloat16. `indices` is a 1-D int32 or
    int64 tensor (or array) on the host or on `src`'s device. Returns
    (B, ...) in `out_dtype` on `src`'s device."""
    n = src.shape[0]
    idx = _as_indices(indices, n)
    if src.device.type == "cpu":
        return gather_normalize_plain(src, idx, out_dtype)
    if src.device.type != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    if src.dtype not in _SRC_CODES:
        raise TypeError(f"K1 takes uint8, int16 or float32 sources, got {src.dtype}")
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"K1 writes float32 or bfloat16, got {out_dtype}")
    if not src.is_contiguous():
        raise ValueError("K1 needs a contiguous source")
    b = idx.shape[0]
    if idx.device.type == "cpu":
        idx = idx.to(src.device)
    elif idx.device != src.device:
        raise ValueError(f"indices on {idx.device}, source on {src.device}")
    idx = idx.contiguous()
    vox = src[0].numel() if n else 0
    out = torch.empty((b,) + tuple(src.shape[1:]), dtype=out_dtype,
                      device=src.device)
    if b == 0 or vox == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(src.device).cuda_stream
    per_vol, smem = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.mad_gather_normalize(
        src.data_ptr(), _SRC_CODES[src.dtype], n, vox, idx.data_ptr(),
        _IDX_CODES[idx.dtype], b, out.data_ptr(), _OUT_CODES[out_dtype],
        _scratch(src.device, stream).data_ptr(), src.device.index or 0, stream,
        ctypes.byref(per_vol), ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(
            f"fused_gather launch failed: {lib.mad_error_string(rc).decode()}")
    gather_normalize.launches += 1
    gather_normalize.mode = "cluster" if per_vol.value < 0 else "grid"
    gather_normalize.blocks_per_volume = abs(per_vol.value)
    gather_normalize.smem_bytes = smem.value
    return out


gather_normalize.launches = 0  # K1 launches; chip_smoke.py resets and reads it
# the last launch's exchange mode ('cluster' or 'grid', see
# csrc/fused_gather.cu), blocks per volume and shared memory per block
gather_normalize.mode = None
gather_normalize.blocks_per_volume = None
gather_normalize.smem_bytes = None
