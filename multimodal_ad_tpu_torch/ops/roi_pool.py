"""Atlas ROI pooling: per-ROI channel means of a voxel feature map (K2).

Port of the TPU package's ops/roi_pool.py. For ROI ids 1..R (0 is
background)

    out[b, r, c] = sum_n [label[n] == r + 1] * feats[b, n, c] / max(count_r, 1e-6)

with feats (B, X, Y, Z, C) or (B, N, C), f32 or bf16, and out (B, R, C)
float32; the 1e-6 clamp gives an ROI without voxels a mean of 0.

- On a CUDA tensor `roi_pool` launches the hand-written kernel in
  csrc/roi_pool.cu, and raises on anything the kernel does not take.
- On a CPU tensor it runs `roi_pool_plain`, the plain PyTorch version: the
  TPU package's one-hot einsum with the 1e-6 clamp.

The kernel sums each ROI's voxels from a label-sorted voxel order that
depends only on the atlas. `RoiAtlas` prepares it once (counts, the
stably sorted voxel indices of the labelled voxels, the R + 1 segment
offsets); pass one in place of the labels to reuse it across batches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from . import _build

_FEAT_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BATCH = 65535  # CUDA grid.y limit
_ONEHOT_ELEMS = 2 ** 24  # size of one slice of the plain version's one-hot


def _labels_tensor(labels, device=None) -> torch.Tensor:
    if not isinstance(labels, torch.Tensor):
        labels = torch.from_numpy(np.asarray(labels))
    return labels.to(device=device).reshape(-1)


def _flatten(feats: torch.Tensor, labels) -> tuple[torch.Tensor, torch.Tensor]:
    if feats.dim() == 5:
        b, x, y, z, c = feats.shape
        feats = feats.reshape(b, x * y * z, c)
    return feats, _labels_tensor(labels, feats.device)


def roi_counts(labels, num_rois: int) -> torch.Tensor:
    """Voxels per ROI, (R,) float32 (ids outside 1..R are not counted)."""
    lab = _labels_tensor(labels).to(torch.long)
    lab = lab[(lab >= 1) & (lab <= num_rois)]
    return torch.bincount(lab, minlength=num_rois + 1)[1:].to(torch.float32)


def roi_pool_plain(feats: torch.Tensor, labels, num_rois: int) -> torch.Tensor:
    """Plain PyTorch version: one-hot (N, R) einsum, f32 accumulation
    (float64 for float64 features), then division by the clamped counts.
    The one-hot is built for a slice of voxels at a time, so it stays near
    2**24 elements at any grid size."""
    if isinstance(labels, RoiAtlas):
        labels = labels.labels
    feats, labels = _flatten(feats, labels)
    acc = torch.float64 if feats.dtype == torch.float64 else torch.float32
    feats = feats.to(acc)
    b, n, c = feats.shape
    roi_ids = torch.arange(1, num_rois + 1, device=feats.device)
    sums = torch.zeros((b, num_rois, c), dtype=acc, device=feats.device)
    counts = torch.zeros((num_rois,), dtype=acc, device=feats.device)
    step = max(1, _ONEHOT_ELEMS // max(num_rois, 1))
    for s in range(0, n, step):
        onehot = (labels[s:s + step, None] == roi_ids[None, :]).to(acc)
        sums += torch.einsum("bnc,nr->brc", feats[:, s:s + step], onehot)
        counts += onehot.sum(dim=0)
    return sums / counts.clamp(min=1e-6)[None, :, None]


@dataclass(frozen=True)
class RoiAtlas:
    """Label-dependent data of one atlas, prepared once on one device.

    labels: (N,) int32, the flattened label volume;
    counts: (R,) float32 voxels per ROI;
    order: (M,) int32 indices of the M labelled voxels, stably sorted by
        label (so ascending within an ROI);
    offsets: (R + 1,) int32; ROI r + 1 owns order[offsets[r]:offsets[r+1]]."""

    labels: torch.Tensor
    num_rois: int
    counts: torch.Tensor
    order: torch.Tensor
    offsets: torch.Tensor

    @classmethod
    def build(cls, labels, num_rois: int, device=None) -> "RoiAtlas":
        """Raises ValueError unless every label is in 0..num_rois."""
        lab = _labels_tensor(labels, device).to(torch.int32)
        if lab.numel() >= 2 ** 31:
            raise ValueError(f"{lab.numel()} voxels exceed the int32 voxel index")
        lo, hi = (int(v) for v in torch.aminmax(lab))
        if lo < 0 or hi > num_rois:
            raise ValueError(f"labels span [{lo}, {hi}], outside [0, {num_rois}]")
        sorted_lab, idx = torch.sort(lab, stable=True)
        n_bg = int((sorted_lab == 0).sum())
        per_roi = torch.bincount(lab.to(torch.long), minlength=num_rois + 1)
        offsets = torch.zeros(num_rois + 1, dtype=torch.long, device=lab.device)
        offsets[1:] = torch.cumsum(per_roi[1:], 0)
        return cls(labels=lab, num_rois=num_rois,
                   counts=per_roi[1:].to(torch.float32),
                   order=idx[n_bg:].to(torch.int32).contiguous(),
                   offsets=offsets.to(torch.int32))


def _lib():
    lib = _build.load("roi_pool")
    fn = lib.mad_roi_pool
    if fn.argtypes is None:  # first use: declare the C signature
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, i, i, i, i, i, i, ll, ll, ll, ll, ll, p, p, i, p, i, p]
        fn.restype = ctypes.c_int
        lib.mad_roi_error_string.argtypes = [ctypes.c_int]
        lib.mad_roi_error_string.restype = ctypes.c_char_p
    return lib


def roi_pool(feats: torch.Tensor, labels, num_rois: int) -> torch.Tensor:
    """Per-ROI means (B, R, C) float32 of `feats` (B, X, Y, Z, C) or
    (B, N, C).

    `labels` is the (X, Y, Z) or (N,) int label volume, or a `RoiAtlas`
    built for it on `feats`' device. On CUDA, feats is float32 or
    bfloat16 with any strides (a unit channel stride reads coalesced), and
    every label must lie in 0..num_rois."""
    if feats.device.type == "cpu":
        return roi_pool_plain(feats, labels, num_rois)
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    if feats.dtype not in _FEAT_CODES:
        raise TypeError(f"K2 takes float32 or bfloat16 features, got {feats.dtype}")
    if feats.dim() == 5:
        b, x, y, z, c = feats.shape
        s_b, s_x, s_y, s_z, s_c = feats.stride()
    elif feats.dim() == 3:
        b, n, c = feats.shape
        x, y, z = 1, 1, n
        s_b, s_z, s_c = feats.stride()
        s_x = s_y = n * s_z  # one row of n voxels: the dense layout
    else:
        raise ValueError(f"K2 takes (B, X, Y, Z, C) or (B, N, C), got {tuple(feats.shape)}")
    atlas = labels if isinstance(labels, RoiAtlas) else RoiAtlas.build(
        labels, num_rois, feats.device)
    if atlas.num_rois != num_rois:
        raise ValueError(f"atlas has {atlas.num_rois} ROIs, asked for {num_rois}")
    if atlas.labels.numel() != x * y * z:
        raise ValueError(f"atlas has {atlas.labels.numel()} voxels, features "
                         f"{x * y * z}")
    if atlas.order.device != feats.device:
        raise ValueError(f"atlas on {atlas.order.device}, features on {feats.device}")
    if b > _MAX_BATCH:
        raise ValueError(f"batch {b} exceeds K2's grid limit {_MAX_BATCH}")
    out = torch.empty((b, num_rois, c), dtype=torch.float32, device=feats.device)
    if b == 0 or c == 0 or num_rois == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    rc = lib.mad_roi_pool(
        feats.data_ptr(), _FEAT_CODES[feats.dtype], b, x, y, z, c,
        s_b, s_x, s_y, s_z, s_c, atlas.order.data_ptr(), atlas.offsets.data_ptr(),
        num_rois, out.data_ptr(), feats.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(
            f"roi_pool launch failed: {lib.mad_roi_error_string(rc).decode()}")
    roi_pool.launches += 1
    return out


roi_pool.launches = 0  # K2 launches; chip_smoke.py resets and reads it
