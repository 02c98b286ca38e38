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

The kernel follows a plan that depends only on the atlas. `RoiAtlas`
builds it once: the label-sorted voxel order, cut into runs (spans of
consecutive z in one (x, y) row of one ROI, so each run is one contiguous
span of features in the dense map and in a padded crop of it), and the
runs grouped into tiles of at most `tile_size` voxels that never cross an
ROI. Pass an atlas in place of the labels to reuse it across batches.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from . import _build

_FEAT_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BATCH = 65535  # CUDA grid.y limit
_ONEHOT_ELEMS = 2 ** 24  # size of one slice of the plain version's one-hot
# Voxels per tile. 512 gives about 1,230 tiles on the 2-mm 166-ROI atlas
# (9,840 blocks at B = 8) and about 10,000 on the 1-mm 600-ROI grid
# (B = 1): some 25 waves of the bulk kernel's 396 block slots at either.
TILE_VOXELS = 512
PATHS = ("bulk", "simt")  # the kernel's two variants of the tile plan
_BULK_MAX_ROW = 2048  # bytes of one voxel's features the bulk path takes


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


def _cumsum0(counts: torch.Tensor) -> torch.Tensor:
    """(n,) counts -> (n + 1,) int32 offsets starting at 0."""
    out = torch.zeros(counts.numel() + 1, dtype=torch.long, device=counts.device)
    out[1:] = torch.cumsum(counts, 0)
    return out.to(torch.int32)


def _tile_plan(order: torch.Tensor, per_roi: torch.Tensor, shape, tile: int):
    """Runs and tiles of the label-sorted voxel `order` (see RoiAtlas).
    Tile k of an ROI holds its voxels k*tile .. (k+1)*tile - 1 in order;
    a run ends at the end of a row, of a tile or of consecutive voxels."""
    _, y_size, z_size = shape
    n = order.to(torch.long)
    m = n.numel()
    tiles_per_roi = (per_roi + tile - 1) // tile
    roi_tiles = _cumsum0(tiles_per_roi)
    n_tiles = int(roi_tiles[-1])
    roi = torch.repeat_interleave(torch.arange(per_roi.numel(), device=n.device), per_roi)
    first = _cumsum0(per_roi).to(torch.long)[roi]
    tile_of = roi_tiles.to(torch.long)[roi] + (torch.arange(m, device=n.device) - first) // tile
    new = torch.ones(m, dtype=torch.bool, device=n.device)
    new[1:] = ((tile_of[1:] != tile_of[:-1]) | (n[1:] != n[:-1] + 1)
               | (n[1:] % z_size == 0))
    starts = torch.nonzero(new).reshape(-1)
    lengths = torch.diff(starts, append=torch.tensor([m], device=n.device))
    n0 = n[starts]
    runs = torch.stack([n0 // (y_size * z_size), (n0 // z_size) % y_size,
                        n0 % z_size, lengths], 1).to(torch.int32).contiguous()
    tile_runs = _cumsum0(torch.bincount(tile_of[starts], minlength=n_tiles))
    tile_starts = _cumsum0(torch.bincount(tile_of, minlength=n_tiles))
    return runs, tile_runs, tile_starts, roi_tiles


@dataclass(frozen=True)
class RoiAtlas:
    """Label-dependent data of one atlas, prepared once on one device.

    labels: (N,) int32, the flattened label volume;
    counts: (R,) float32 voxels per ROI;
    order: (M,) int32 indices of the M labelled voxels, stably sorted by
        label (so ascending within an ROI);
    offsets: (R + 1,) int32; ROI r + 1 owns order[offsets[r]:offsets[r+1]];
    shape: the label volume's (X, Y, Z), or (1, 1, N) for flat labels;
    tile_size: T, the most voxels a tile holds;
    runs: (P, 4) int32 (x, y, z0, length): order cut at every break of
        consecutive z, every (x, y) row, every ROI and every tile, so run j
        is the voxels (x, y, z0 .. z0 + length - 1), in order;
    tile_runs: (tiles + 1,) int32; tile t owns runs[tile_runs[t]:tile_runs[t+1]];
    tile_starts: (tiles + 1,) int32; tile t holds order[tile_starts[t]:tile_starts[t+1]];
    roi_tiles: (R + 1,) int32; ROI r + 1 owns tiles roi_tiles[r]:roi_tiles[r+1]."""

    labels: torch.Tensor
    num_rois: int
    counts: torch.Tensor
    order: torch.Tensor
    offsets: torch.Tensor
    shape: tuple
    tile_size: int
    runs: torch.Tensor
    tile_runs: torch.Tensor
    tile_starts: torch.Tensor
    roi_tiles: torch.Tensor

    @property
    def num_tiles(self) -> int:
        return self.tile_runs.numel() - 1

    @classmethod
    def build(cls, labels, num_rois: int, device=None,
              tile_size: int = TILE_VOXELS) -> "RoiAtlas":
        """Raises ValueError unless every label is in 0..num_rois."""
        if not isinstance(labels, torch.Tensor):
            labels = torch.from_numpy(np.asarray(labels))
        shape = tuple(labels.shape) if labels.dim() == 3 else (1, 1, labels.numel())
        lab = _labels_tensor(labels, device).to(torch.int32)
        if lab.numel() >= 2 ** 31:
            raise ValueError(f"{lab.numel()} voxels exceed the int32 voxel index")
        if tile_size < 1:
            raise ValueError(f"tile_size must be positive, got {tile_size}")
        lo, hi = (int(v) for v in torch.aminmax(lab))
        if lo < 0 or hi > num_rois:
            raise ValueError(f"labels span [{lo}, {hi}], outside [0, {num_rois}]")
        sorted_lab, idx = torch.sort(lab, stable=True)
        n_bg = int((sorted_lab == 0).sum())
        per_roi = torch.bincount(lab.to(torch.long), minlength=num_rois + 1)
        order = idx[n_bg:].to(torch.int32).contiguous()
        runs, tile_runs, tile_starts, roi_tiles = _tile_plan(
            order, per_roi[1:], shape, tile_size)
        return cls(labels=lab, num_rois=num_rois,
                   counts=per_roi[1:].to(torch.float32), order=order,
                   offsets=_cumsum0(per_roi[1:]), shape=shape, tile_size=tile_size,
                   runs=runs, tile_runs=tile_runs, tile_starts=tile_starts,
                   roi_tiles=roi_tiles)


def _voxel_stride(sizes, strides):
    """Stride of the spatial axes merged into one, or None where they do
    not merge (axes of size 1 place nothing)."""
    dims = [(n, s) for n, s in zip(sizes, strides) if n != 1]
    if not dims:
        return 0
    for (_, s_outer), (n_inner, s_inner) in zip(dims, dims[1:]):
        if s_outer != n_inner * s_inner:
            return None
    return dims[-1][1]


def plan_strides(feats: torch.Tensor, atlas: RoiAtlas) -> tuple:
    """Element strides (s_b, s_x, s_y, s_z, s_c) under which voxel
    (x, y, z) of the atlas's grid, in batch b and channel c, sits at
    b*s_b + x*s_x + y*s_y + z*s_z + c*s_c in `feats`. A stride that places
    nothing (its axis has size 1) is 0. Raises ValueError when the atlas's
    grid does not index the features."""
    xa, ya, za = atlas.shape
    if feats.dim() == 5:
        b, x, y, z, c = feats.shape
        s_b, s_x, s_y, s_z, s_c = feats.stride()
        if (x, y, z) != (xa, ya, za):
            s_v = _voxel_stride((x, y, z), (s_x, s_y, s_z))
            if s_v is None or x * y * z != xa * ya * za:
                raise ValueError(f"features of grid {(x, y, z)} with strides "
                                 f"{feats.stride()} do not match the atlas's grid "
                                 f"{atlas.shape}")
            s_x, s_y, s_z = ya * za * s_v, za * s_v, s_v
    elif feats.dim() == 3:
        b, n, c = feats.shape
        s_b, s_v, s_c = feats.stride()
        s_x, s_y, s_z = ya * za * s_v, za * s_v, s_v
    else:
        raise ValueError(f"K2 takes (B, X, Y, Z, C) or (B, N, C), got {tuple(feats.shape)}")
    return tuple(s if n > 1 else 0 for n, s in
                 zip((b, xa, ya, za, c), (s_b, s_x, s_y, s_z, s_c)))


def k2_path(feats: torch.Tensor, atlas: RoiAtlas, strides=None) -> str:
    """'bulk' where every run is one 16-byte aligned span of whole 16-byte
    vectors (unit channel stride, voxel stride C, aligned base and
    strides), so the kernel moves it with TMA bulk copies; else 'simt'.
    `strides` are `plan_strides(feats, atlas)`, if already at hand."""
    s_b, s_x, s_y, s_z, s_c = strides or plan_strides(feats, atlas)
    c = feats.shape[-1]
    row = c * feats.element_size()
    ok = (s_c in (0, 1) and (s_z == c or atlas.shape[2] == 1) and row % 16 == 0
          and row <= _BULK_MAX_ROW and feats.data_ptr() % 16 == 0
          and all(s * feats.element_size() % 16 == 0 for s in (s_b, s_x, s_y, s_z)))
    return "bulk" if ok else "simt"


def _lib():
    lib = _build.load("roi_pool")
    fn = lib.mad_roi_pool
    if fn.argtypes is None:  # first use: declare the C signature
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, i, i, i, i, ll, ll, ll, ll, ll, p, p, p, i, p, p, i, p, p, i, p]
        fn.restype = ctypes.c_int
        lib.mad_roi_error_string.argtypes = [ctypes.c_int]
        lib.mad_roi_error_string.restype = ctypes.c_char_p
    return lib


def roi_pool(feats: torch.Tensor, labels, num_rois: int) -> torch.Tensor:
    """Per-ROI means (B, R, C) float32 of `feats` (B, X, Y, Z, C) or
    (B, N, C).

    `labels` is the (X, Y, Z) or (N,) int label volume, or a `RoiAtlas`
    built for it on `feats`' device. On CUDA, feats is float32 or
    bfloat16 with any strides (`k2_path` picks the kernel's variant from
    them), and every label must lie in 0..num_rois."""
    if feats.device.type == "cpu":
        return roi_pool_plain(feats, labels, num_rois)
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    if feats.dtype not in _FEAT_CODES:
        raise TypeError(f"K2 takes float32 or bfloat16 features, got {feats.dtype}")
    if feats.dim() not in (3, 5):
        raise ValueError(f"K2 takes (B, X, Y, Z, C) or (B, N, C), got {tuple(feats.shape)}")
    atlas = labels if isinstance(labels, RoiAtlas) else RoiAtlas.build(
        labels, num_rois, feats.device)
    if atlas.num_rois != num_rois:
        raise ValueError(f"atlas has {atlas.num_rois} ROIs, asked for {num_rois}")
    b, c = feats.shape[0], feats.shape[-1]
    n_vox = math.prod(feats.shape[1:-1])
    if atlas.labels.numel() != n_vox:
        raise ValueError(f"atlas has {atlas.labels.numel()} voxels, features {n_vox}")
    if atlas.order.device != feats.device:
        raise ValueError(f"atlas on {atlas.order.device}, features on {feats.device}")
    if b > _MAX_BATCH:
        raise ValueError(f"batch {b} exceeds K2's grid limit {_MAX_BATCH}")
    out = torch.empty((b, num_rois, c), dtype=torch.float32, device=feats.device)
    if b == 0 or c == 0 or num_rois == 0:
        return out
    strides = plan_strides(feats, atlas)
    path = k2_path(feats, atlas, strides)
    partial = torch.empty((b, atlas.num_tiles, c), dtype=torch.float32,
                          device=feats.device)
    lib = _lib()
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    rc = lib.mad_roi_pool(
        feats.data_ptr(), _FEAT_CODES[feats.dtype], int(path == "bulk"), b, c,
        *strides, atlas.runs.data_ptr(), atlas.tile_runs.data_ptr(),
        atlas.tile_starts.data_ptr(), atlas.num_tiles, atlas.roi_tiles.data_ptr(),
        atlas.offsets.data_ptr(), num_rois, partial.data_ptr(), out.data_ptr(),
        feats.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(
            f"roi_pool launch failed: {lib.mad_roi_error_string(rc).decode()}")
    roi_pool.launches += 1
    roi_pool.path_launches[path] += 1
    return out


roi_pool.launches = 0  # K2 launches; chip_smoke.py resets and reads it
roi_pool.path_launches = dict.fromkeys(PATHS, 0)  # the same, by variant
