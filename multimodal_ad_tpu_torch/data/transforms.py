"""Host-planned volume augmentation (port of the TPU package's
data/transforms.py: `VolumeTransform`, `make_transforms`).

The TPU package normalizes each volume on the host, then, for training,
flips it (p 0.3, axis 0), rotates it about axis 0 (p 0.3, angle uniform in
[-0.05, 0.05], a bilinear resample of each (y, z) plane) and zooms it
about its centre (p 0.3, zoom uniform in [0.95, 1.0], a trilinear
resample; no change where |zoom - 1| < 1e-6): three separate resamples,
whose draws come from ``np.random.default_rng((seed, epoch, sample_idx))``
in that order. The evaluation transform never augments.

Here the same numpy generator draws the same samples, so a plan
(`AugmentPlan`, from `VolumeTransform.plan`) is exactly the TPU package's
draw. The batch is normalized on the device first (K1 for
scale_intensity, ops/normalize.py), and `apply_plans` then applies each
row's plan there. Min-max does not commute with the zero fill of a
rotation or zoom, so the order stays normalize, flip, rotate, zoom.

Rounding. The coordinates, corner indices and weights are planned on the
host with the TPU package's numpy expressions: the rotation's coordinates
in float64, the zoom's in float32, each weight a float64 difference cast
to float32. The device forms every weighted corner and the sum in the TPU
package's order, one float32 rounding per operation, so a batch equals the
host transform's up to K1's rounding (at most 2 ulp of a normalized
value, ops/fused_gather.py), and is bit-equal on a card and on the CPU.
Corner indices are clipped to [0, d - 2], weights to [0, 1], and a sample
is zero where a coordinate falls outside [0, d - 1].

The TPU package's host call form stays too: `rand_flip`, `rand_rotate` and
`rand_zoom` take a numpy volume and a generator, draw as its functions do
(so a chain of them on one generator draws what `plan_augmentation`
draws) and resample on a CPU tensor with `rotate_x` / `zoom_trilinear`;
`VolumeTransform(augment, normalizer, seed)(vol, sample_idx, epoch)`
normalizes (ops/normalize.py's NORMALIZERS, on the CPU) and augments one
volume into an (X, Y, Z, 1) float32 array.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.augment import _apply_to
from ..ops.normalize import NORMALIZERS

FLIP_PROB = 0.3
ROTATE_PROB = 0.3
RANGE_X = 0.05
ZOOM_PROB = 0.3
MIN_ZOOM, MAX_ZOOM = 0.95, 1.0


@dataclass(frozen=True)
class AugmentPlan:
    """One volume's augmentation: a flip of axis 0, a rotation about axis 0
    by `angle` rad, a zoom by `zoom`; None where the draw skipped it (a zoom
    within 1e-6 of 1 is skipped, as in the TPU package)."""

    flip: bool = False
    angle: float | None = None
    zoom: float | None = None


def plan_augmentation(rng: np.random.Generator) -> AugmentPlan:
    """The TPU package's draws, in its order: flip, rotate (+ angle), zoom
    (+ factor)."""
    flip = bool(rng.random() < FLIP_PROB)
    angle = rng.uniform(-RANGE_X, RANGE_X) if rng.random() < ROTATE_PROB else None
    zoom = rng.uniform(MIN_ZOOM, MAX_ZOOM) if rng.random() < ZOOM_PROB else None
    if zoom is not None and abs(zoom - 1.0) < 1e-6:
        zoom = None
    return AugmentPlan(flip, angle, zoom)


class VolumeTransform:
    """Per-volume augmentation plans. `plan(sample_idx, epoch)` draws from
    ``np.random.default_rng((seed, epoch, sample_idx))``: independent of
    the loader threads' order and fresh every epoch. Without `augment`
    every plan is the identity. Called on a host volume, it normalizes and
    augments it there (the TPU package's call form)."""

    def __init__(self, augment: bool = False, normalizer: str = "scale_intensity",
                 seed: int = 0):
        if normalizer not in NORMALIZERS:
            raise KeyError(f"unknown normalizer {normalizer!r}; choose from {list(NORMALIZERS)}")
        self.augment = augment
        self.normalizer = normalizer
        self.seed = seed

    def plan(self, sample_idx: int = 0, epoch: int = 0) -> AugmentPlan:
        if not self.augment:
            return AugmentPlan()
        return plan_augmentation(np.random.default_rng((self.seed, epoch, sample_idx)))

    def __call__(self, vol: np.ndarray, sample_idx: int = 0, epoch: int = 0) -> np.ndarray:
        """(X, Y, Z) volume -> normalized, augmented (X, Y, Z, 1) float32,
        the draws from the stream `plan` uses."""
        batch = torch.from_numpy(np.ascontiguousarray(vol))[None, ..., None]
        vol = NORMALIZERS[self.normalizer](batch)[0, ..., 0].numpy()
        if self.augment:
            rng = np.random.default_rng((self.seed, epoch, sample_idx))
            vol = rand_flip(vol, rng)
            vol = rand_rotate(vol, rng)
            vol = rand_zoom(vol, rng)
        return vol[..., None]


def make_transforms(augment: bool = False, seed: int = 0,
                    normalizer: str = "scale_intensity"):
    """(train, eval) transforms; the evaluation one never augments. On the
    training path the normalizer runs on the device, before the plans
    (`apply_plans`); `normalizer` is the host call form's."""
    return (VolumeTransform(augment=augment, normalizer=normalizer, seed=seed),
            VolumeTransform(augment=False, normalizer=normalizer))


def rand_flip(vol: np.ndarray, rng: np.random.Generator, prob: float = FLIP_PROB,
              axis: int = 0) -> np.ndarray:
    """Flip `axis` with probability `prob` (one draw)."""
    if rng.random() < prob:
        vol = np.flip(vol, axis=axis).copy()
    return vol


def rand_rotate(vol: np.ndarray, rng: np.random.Generator, prob: float = ROTATE_PROB,
                range_x: float = RANGE_X) -> np.ndarray:
    """Rotate about axis 0 by an angle uniform in [-range_x, range_x] with
    probability `prob` (`rotate_x`)."""
    if rng.random() < prob:
        angle = rng.uniform(-range_x, range_x)
        vol = rotate_x(torch.from_numpy(np.ascontiguousarray(vol))[None], [angle])[0].numpy()
    return vol


def rand_zoom(vol: np.ndarray, rng: np.random.Generator, prob: float = ZOOM_PROB,
              min_zoom: float = MIN_ZOOM, max_zoom: float = MAX_ZOOM) -> np.ndarray:
    """Zoom about the centre by a factor uniform in [min_zoom, max_zoom]
    with probability `prob`, resampled onto the same grid
    (`zoom_trilinear`); a factor within 1e-6 of 1 leaves the volume."""
    if rng.random() >= prob:
        return vol
    zoom = rng.uniform(min_zoom, max_zoom)
    if abs(zoom - 1.0) < 1e-6:
        return vol
    return zoom_trilinear(torch.from_numpy(np.ascontiguousarray(vol))[None], [zoom])[0].numpy()


def _corner(c: np.ndarray, d: int):
    """Lower corner index clipped to [0, d - 2] and its float32 weight."""
    c0 = np.clip(np.floor(c).astype(np.int64), 0, d - 2)
    return c0, np.clip(c - c0, 0.0, 1.0).astype(np.float32)


def _rotate_plan(dy: int, dz: int, angle: float):
    """The TPU package's _rotate_x / _sample_plane plan of one (Y, Z) plane:
    flat corner indices (4, Y, Z) in the order v00, v01, v10, v11, the two
    weight factors of each corner, and the inside mask."""
    c1, c2 = (dy - 1) / 2.0, (dz - 1) / 2.0
    cos, sin = np.cos(angle), np.sin(angle)
    g1, g2 = np.meshgrid(np.arange(dy), np.arange(dz), indexing="ij")
    y = cos * (g1 - c1) + sin * (g2 - c2) + c1
    z = -sin * (g1 - c1) + cos * (g2 - c2) + c2
    (y0, wy), (z0, wz) = _corner(y, dy), _corner(z, dz)
    idx = np.stack([(y0 + a) * dz + z0 + b for a in (0, 1) for b in (0, 1)])
    fy = np.stack([1 - wy, 1 - wy, wy, wy])
    fz = np.stack([1 - wz, wz, 1 - wz, wz])
    inside = ((y >= 0) & (y <= dy - 1) & (z >= 0) & (z <= dz - 1)).astype(np.float32)
    return idx, fy, fz, inside


def _zoom_axis_plan(d: int, zoom: float):
    """One axis of the TPU package's rand_zoom / _trilinear plan (the
    coordinates are separable): corner indices (2, d), weights (2, d) and
    the inside mask (d,)."""
    c = (np.arange(d, dtype=np.float32) - (d - 1) / 2.0) / zoom + (d - 1) / 2.0
    c0, w = _corner(c, d)
    return (np.stack([c0, c0 + 1]), np.stack([1 - w, w]),
            ((c >= 0) & (c <= d - 1)).astype(np.float32))


def _upload(arrays, device):
    # staged copies: no wait for the card
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device, non_blocking=True)
            for a in arrays]


def rotate_x(vols: torch.Tensor, angles) -> torch.Tensor:
    """Rotate each (X, Y, Z) volume of `vols` (S, X, Y, Z) by `angles[i]`
    rad about axis 0: a bilinear resample of every (Y, Z) plane, one gather
    for all S volumes."""
    s, dx, dy, dz = vols.shape
    idx, fy, fz, inside = _upload(
        (np.stack(t) for t in zip(*(_rotate_plan(dy, dz, a) for a in angles))),
        vols.device)
    v = vols.reshape(s, dx, dy * dz).gather(
        2, idx.view(s, 1, 4 * dy * dz).expand(s, dx, 4 * dy * dz)).view(s, dx, 4, dy, dz)
    t = v * fy.view(s, 1, 4, dy, dz) * fz.view(s, 1, 4, dy, dz)
    out = t[:, :, 0] + t[:, :, 1] + t[:, :, 2] + t[:, :, 3]
    return out * inside.view(s, 1, dy, dz)


def zoom_trilinear(vols: torch.Tensor, zooms) -> torch.Tensor:
    """Zoom each (X, Y, Z) volume of `vols` (S, X, Y, Z) by `zooms[i]` about
    its centre, resampled onto the same grid: three separable gathers pick
    the 8 corners of every voxel, summed in the TPU package's corner
    order."""
    s, dx, dy, dz = vols.shape
    (ix, wx, inx), (iy, wy, iny), (iz, wz, inz) = (
        _upload((np.stack(t) for t in zip(*(_zoom_axis_plan(d, z) for z in zooms))),
                vols.device)
        for d in (dx, dy, dz))
    g = vols.gather(1, ix.view(s, 2 * dx, 1, 1).expand(s, 2 * dx, dy, dz))
    g = g.gather(2, iy.view(s, 1, 2 * dy, 1).expand(s, 2 * dx, 2 * dy, dz))
    g = g.gather(3, iz.view(s, 1, 1, 2 * dz).expand(s, 2 * dx, 2 * dy, 2 * dz))
    w = wx.view(s, 2, dx, 1, 1, 1, 1) * wy.view(s, 1, 1, 2, dy, 1, 1)
    t = g.view(s, 2, dx, 2, dy, 2, dz) * (w * wz.view(s, 1, 1, 1, 1, 2, dz))
    out = t[:, 0, :, 0, :, 0]
    for a, b, c in ((0, 0, 1), (0, 1, 0), (0, 1, 1), (1, 0, 0), (1, 0, 1), (1, 1, 0),
                    (1, 1, 1)):
        out = out + t[:, a, :, b, :, c]
    inside = inx.view(s, dx, 1, 1) * iny.view(s, 1, dy, 1) * inz.view(s, 1, 1, dz)
    return out * inside


def apply_plans(images: torch.Tensor, plans) -> torch.Tensor:
    """Apply `plans[i]` to row i of a normalized (B, X, Y, Z, 1) batch:
    flip, then rotate, then zoom, each stage one batched pass over the rows
    that take it. Rows whose plans are the identity are left as they are;
    with none to change, `images` itself is returned."""
    if images.shape[-1] != 1:
        raise ValueError(f"augmentation takes one channel, got {images.shape[-1]}")
    if len(plans) != images.shape[0]:
        raise ValueError(f"{len(plans)} plans for a batch of {images.shape[0]}")

    def per_volume(fn, values):
        return lambda v, sel: fn(v[..., 0], [values[i] for i in sel])[..., None]

    x = _apply_to(images, np.array([p.flip for p in plans]), lambda v, _: v.flip(1))
    angles = [p.angle for p in plans]
    x = _apply_to(x, np.array([a is not None for a in angles]), per_volume(rotate_x, angles))
    zooms = [p.zoom for p in plans]
    return _apply_to(x, np.array([z is not None for z in zooms]),
                     per_volume(zoom_trilinear, zooms))
