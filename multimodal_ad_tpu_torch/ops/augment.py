"""Batch augmentation on the device for the resident training path (port of
the TPU package's ops/augment.py, which is plain XLA there: no Pallas
kernel, so plain PyTorch here).

- `random_flip`: per-sample flip of the first spatial axis with
  probability p (MONAI RandFlipd);
- `random_rotate_zoom`: per-sample rotation about the first spatial axis
  (RandRotated range_x) composed with a central zoom (RandZoomd), applied
  as one trilinear resample onto the same grid;
- `random_intensity_scale` / `_shift`: opt-in photometric jitter.

The trilinear sample keeps the TPU package's semantics: corner indices
clipped to [0, d - 2], weights clipped to [0, 1], and the whole sample
zeroed where a coordinate falls outside [0, d - 1]. (`grid_sample` with
zero padding would blend partially within one voxel outside the volume,
so it is not used.) A corner's weight is wx * (wy * wz) where the TPU
package forms (wx * wy) * wz, and the 8 corners are summed by one
reduction: each differs from the TPU package's by a few ulps.

Every random draw comes from a host `torch.Generator` (CPU), a fixed
number of draws per call, so the decisions are known on the host without
reading the card: only the samples drawn for a flip or a resample are
touched, and a batch augments the same on the host and on a card. The
draws differ from the TPU package's PRNG; the geometry is the same for
the same angle, zoom and flip.
"""

from __future__ import annotations

import numpy as np
import torch


def _plan(shape, angles, zooms):
    """Host float32 plan of S volumes' resample (numpy): the inverse zoom
    about the centre, then the inverse rotation about axis 0, as the TPU
    package computes them, cos and sin rounded from float64. The
    coordinates are separable: x depends on the output's x only, y and z on
    its (y, z) only. Returns, per corner (ix, iy, iz), the flat source
    index split as an x part (S, 2, X) plus a (y, z) part (S, 4, Y, Z), and
    the weights split the same way, each clipped to [0, 1] and zero where
    the coordinate falls outside the volume."""
    dx, dy, dz = shape
    f32 = np.float32
    a = np.asarray(angles, np.float64)
    cos = np.cos(a).astype(f32)[:, None, None]
    sin = np.sin(a).astype(f32)[:, None, None]
    zoom = np.asarray(zooms, np.float64).astype(f32)[:, None, None]
    cx, cy, cz = f32((dx - 1) / 2.0), f32((dy - 1) / 2.0), f32((dz - 1) / 2.0)
    xs = (np.arange(dx, dtype=f32) - cx) / zoom[:, :, 0] + cx        # (S, X)
    ys = (np.arange(dy, dtype=f32)[:, None] - cy) / zoom + cy         # (S, Y, 1)
    zs = (np.arange(dz, dtype=f32)[None, :] - cz) / zoom + cz         # (S, 1, Z)
    yr = cos * (ys - cy) + sin * (zs - cz) + cy                       # (S, Y, Z)
    zr = -sin * (ys - cy) + cos * (zs - cz) + cz

    def corner(c, d):
        c0 = np.clip(np.floor(c), 0, d - 2)
        return c0.astype(np.int64), np.clip(c - c0.astype(f32), 0, 1).astype(f32)

    (x0, wx), (y0, wy), (z0, wz) = corner(xs, dx), corner(yr, dy), corner(zr, dz)
    in_x = ((xs >= 0) & (xs <= dx - 1)).astype(f32)
    in_yz = ((yr >= 0) & (yr <= dy - 1) & (zr >= 0) & (zr <= dz - 1)).astype(f32)
    idx_x = np.stack([x0 * (dy * dz), (x0 + 1) * (dy * dz)], 1)
    w_x = np.stack([(1 - wx) * in_x, wx * in_x], 1)
    idx_yz = np.stack([(y0 + iy) * dz + z0 + iz for iy in (0, 1) for iz in (0, 1)], 1)
    w_yz = np.stack([((wy if iy else 1 - wy) * (wz if iz else 1 - wz)) * in_yz
                     for iy in (0, 1) for iz in (0, 1)], 1)
    return idx_x, w_x, idx_yz, w_yz


def rotate_zoom(vols, angles, zooms):
    """Rotate each (X, Y, Z, C) volume of `vols` (S, X, Y, Z, C) by
    `angles[i]` rad about axis 0 and zoom it about the centre by
    `zooms[i]`, resampled onto the original grid in one trilinear pass.
    Angle 0 and zoom 1 give the volume unchanged.

    The coordinates, corner indices and weights are planned on the host
    (`_plan`, a few hundred KB a volume) and copied up; the device then
    gathers the 8 corners of every voxel of all S volumes in one launch and
    sums them weighted, five launches in all. The sample is zero where a
    coordinate falls outside the volume (the masks are in the weights)."""
    s, dx, dy, dz, c = vols.shape
    dev = vols.device
    idx_x, w_x, idx_yz, w_yz = (
        torch.from_numpy(t).to(dev, non_blocking=True)  # staged: no wait for the card
        for t in _plan((dx, dy, dz), angles, zooms))
    idx = idx_x.view(s, 2, 1, dx, 1, 1) + idx_yz.view(s, 1, 4, 1, dy, dz)
    w = w_x.view(s, 2, 1, dx, 1, 1) * w_yz.view(s, 1, 4, 1, dy, dz)   # (S, 2, 4, X, Y, Z)
    v = vols.reshape(s, -1, c).gather(1, idx.reshape(s, -1, 1).expand(-1, -1, c))
    v = v.view(s, 8, dx, dy, dz, c) * w.view(s, 8, dx, dy, dz, 1).to(vols.dtype)
    return v.sum(dim=1)


def rotate_zoom_volume(vol, angle, zoom):
    """One (X, Y, Z, C) volume rotated by `angle` and zoomed by `zoom`."""
    return rotate_zoom(vol[None], [angle], [zoom])[0]


def _apply_to(batch, rows, fn):
    """`batch` with the rows where the host bool mask `rows` is set replaced
    by fn(those rows, their positions); the batch itself when none is."""
    rows = rows.tolist()
    sel = [i for i, r in enumerate(rows) if r]
    if not sel:
        return batch
    new = fn(torch.stack([batch[i] for i in sel]), sel)
    pos = {i: k for k, i in enumerate(sel)}
    return torch.stack([new[pos[i]] if r else batch[i] for i, r in enumerate(rows)])


def _draw(generator, rows: int, batch_images, global_rows, row_offset):
    """(rows, B_global) uniforms for the global batch, then this batch's
    columns: a batch that is rows [row_offset, row_offset + B) of a global
    batch of `global_rows` (one rank's share under a mesh) takes the draws
    the whole batch would give those rows."""
    b = batch_images.shape[0]
    n = b if global_rows is None else int(global_rows)
    u = torch.rand((rows, n), generator=generator, dtype=torch.float64)
    return u[:, row_offset:row_offset + b]


def random_rotate_zoom(batch_images, generator, rotate_prob: float = 0.3,
                       range_x: float = 0.05, zoom_prob: float = 0.3,
                       min_zoom: float = 0.95, max_zoom: float = 1.0,
                       global_rows: int | None = None, row_offset: int = 0):
    """Per-sample random rotation about axis 0 (angle uniform in
    [-range_x, range_x] with probability rotate_prob) and central zoom
    (uniform in [min_zoom, max_zoom] with probability zoom_prob) of a
    (B, X, Y, Z, C) batch, one resample for all the samples drawn.
    `global_rows` / `row_offset`: see `augment_batch`."""
    u = _draw(generator, 4, batch_images, global_rows, row_offset)
    do_r, do_z = u[0] < rotate_prob, u[2] < zoom_prob
    angle = torch.where(do_r, -range_x + 2 * range_x * u[1], 0.0).tolist()
    zoom = torch.where(do_z, min_zoom + (max_zoom - min_zoom) * u[3], 1.0).tolist()
    return _apply_to(batch_images, do_r | do_z,
                     lambda v, sel: rotate_zoom(v, [angle[i] for i in sel],
                                                [zoom[i] for i in sel]))


def random_flip(batch_images, generator, prob: float = 0.3, axis: int = 1,
                global_rows: int | None = None, row_offset: int = 0):
    """Per-sample flip along a spatial axis of (B, X, Y, Z, C)."""
    do = _draw(generator, 1, batch_images, global_rows, row_offset)[0] < prob
    return _apply_to(batch_images, do, lambda v, sel: v.flip(axis))


def _per_sample(v, values):
    """Host float64 values, one a sample of `v`, as a float32 factor
    broadcast over each sample, on `v`'s device."""
    shape = (v.shape[0],) + (1,) * (v.dim() - 1)
    return values.to(torch.float32).reshape(shape).to(v.device, non_blocking=True).to(v.dtype)


def random_intensity_scale(batch_images, generator, prob: float = 0.3,
                           factor: float = 0.1, global_rows: int | None = None,
                           row_offset: int = 0):
    """Multiply each sample, with probability `prob`, by a factor uniform in
    [1 - factor, 1 + factor]."""
    u = _draw(generator, 2, batch_images, global_rows, row_offset)
    scale = torch.where(u[0] < prob, 1.0 + (-factor + 2 * factor * u[1]), 1.0)
    return _apply_to(batch_images, u[0] < prob,
                     lambda v, sel: v * _per_sample(v, scale[sel]))


def random_intensity_shift(batch_images, generator, prob: float = 0.3,
                           offset: float = 0.1, global_rows: int | None = None,
                           row_offset: int = 0):
    """Add to each sample, with probability `prob`, an offset uniform in
    [-offset, offset]."""
    u = _draw(generator, 2, batch_images, global_rows, row_offset)
    shift = torch.where(u[0] < prob, -offset + 2 * offset * u[1], 0.0)
    return _apply_to(batch_images, u[0] < prob,
                     lambda v, sel: v + _per_sample(v, shift[sel]))


def augment_batch(batch_images, generator, flip_prob: float = 0.3,
                  rotate_prob: float = 0.3, zoom_prob: float = 0.3,
                  scale_prob: float = 0.0, shift_prob: float = 0.0,
                  global_rows: int | None = None, row_offset: int = 0):
    """Composite augmentation: flip p=0.3, rotate p=0.3 (range_x 0.05), zoom
    p=0.3 in [0.95, 1.0], as the reference's MONAI training pipeline;
    intensity scale/shift are opt-in extras. `generator` is a host
    torch.Generator. Where `batch_images` is rows [row_offset, row_offset +
    B) of a global batch of `global_rows` (a rank's share under a mesh),
    every draw is made for the global batch and the batch takes its rows'
    draws, so the ranks together augment as one process would."""
    kw = dict(global_rows=global_rows, row_offset=row_offset)
    x = random_flip(batch_images, generator, flip_prob, **kw)
    if rotate_prob > 0 or zoom_prob > 0:
        x = random_rotate_zoom(x, generator, rotate_prob, zoom_prob=zoom_prob, **kw)
    if scale_prob > 0:
        x = random_intensity_scale(x, generator, scale_prob, **kw)
    if shift_prob > 0:
        x = random_intensity_shift(x, generator, shift_prob, **kw)
    return x
