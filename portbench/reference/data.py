"""Plain reference of the input path: the per-volume min-max normalisation
(scale_intensity), the corpus's uint8 store, the epoch order and the
device augmentation's draws and resample, worked out again from the seeds
the benchmark hands the program. Imports neither JAX nor the program."""

from __future__ import annotations

import math

import numpy as np
import torch


def normalize(x: torch.Tensor) -> torch.Tensor:
    """(B, ...) -> float32 (x - min) / (max - min) per volume, 0 where the
    range is under 1e-12."""
    flat = x.reshape(x.shape[0], -1).to(torch.float32)
    lo = flat.amin(dim=1, keepdim=True)
    rng = flat.amax(dim=1, keepdim=True) - lo
    safe = torch.where(rng < 1e-12, torch.ones_like(rng), rng)
    out = torch.where(rng < 1e-12, torch.zeros_like(flat), (flat - lo) / safe)
    return out.reshape(x.shape)


def to_uint8(vol: np.ndarray) -> np.ndarray:
    """One volume mapped affinely onto [0, 255] and rounded to uint8 (the
    resident corpus's store, which the configuration states)."""
    v = vol.astype(np.float32)
    mn, mx = float(v.min()), float(v.max())
    if mx - mn < 1e-12:
        return np.zeros(v.shape, np.uint8)
    return np.rint((v - mn) * (255.0 / (mx - mn))).astype(np.uint8)


def epoch_order(indices, seed: int, epoch: int) -> np.ndarray:
    """The rows of epoch `epoch` of a shuffled epoch iterator seeded `seed`."""
    order = np.asarray(indices, np.int64).copy()
    np.random.default_rng((seed, epoch)).shuffle(order)
    return order


class AugmentDraws:
    """The augmentation's decisions, drawn from a host generator seeded as
    the program's: per batch a flip draw (1, B), then a rotate/zoom draw
    (4, B), float64 uniforms; flip, rotation and zoom each with probability
    0.3, angle uniform in +-0.05 rad, zoom uniform in [0.95, 1]."""

    def __init__(self, seed: int, prob: float = 0.3, range_x: float = 0.05,
                 min_zoom: float = 0.95, max_zoom: float = 1.0):
        self.g = torch.Generator().manual_seed(seed)
        self.prob, self.range_x = prob, range_x
        self.min_zoom, self.max_zoom = min_zoom, max_zoom

    def next(self, b: int) -> list[tuple[bool, float, float]]:
        """(flip, angle, zoom) for each of the next batch's `b` rows."""
        f = torch.rand((1, b), generator=self.g, dtype=torch.float64)
        u = torch.rand((4, b), generator=self.g, dtype=torch.float64)
        rows = []
        for i in range(b):
            angle = (-self.range_x + 2 * self.range_x * float(u[1, i])
                     if float(u[0, i]) < self.prob else 0.0)
            zoom = (self.min_zoom + (self.max_zoom - self.min_zoom) * float(u[3, i])
                    if float(u[2, i]) < self.prob else 1.0)
            rows.append((float(f[0, i]) < self.prob, angle, zoom))
        return rows


def _axis_sample(c: torch.Tensor, d: int):
    """Trilinear corner and weight along one axis: the lower corner clipped
    to [0, d - 2], its weight clipped to [0, 1], and whether c lies in
    [0, d - 1]."""
    c0 = torch.clamp(torch.floor(c), 0, d - 2)
    w = torch.clamp(c - c0, 0, 1)
    return c0.long(), w, (c >= 0) & (c <= d - 1)


def rotate_zoom(vol: torch.Tensor, angle: float, zoom: float) -> torch.Tensor:
    """(X, Y, Z) float32 volume resampled trilinearly at the inverse of a
    zoom about the centre then a rotation by `angle` about the first axis;
    zero where the source point falls outside the volume."""
    dx, dy, dz = vol.shape
    dev = vol.device
    cx, cy, cz = (dx - 1) / 2.0, (dy - 1) / 2.0, (dz - 1) / 2.0
    xs = (torch.arange(dx, device=dev, dtype=torch.float64) - cx) / zoom + cx
    ys = (torch.arange(dy, device=dev, dtype=torch.float64)[:, None] - cy) / zoom + cy
    zs = (torch.arange(dz, device=dev, dtype=torch.float64)[None, :] - cz) / zoom + cz
    cos, sin = math.cos(angle), math.sin(angle)
    yr = cos * (ys - cy) + sin * (zs - cz) + cy
    zr = -sin * (ys - cy) + cos * (zs - cz) + cz
    x0, wx, inx = _axis_sample(xs, dx)
    y0, wy, iny = _axis_sample(yr, dy)
    z0, wz, inz = _axis_sample(zr, dz)
    inside = (inx[:, None, None] & (iny & inz)[None]).to(torch.float32)
    out = torch.zeros_like(vol)
    for ix in (0, 1):
        wxs = (wx if ix else 1 - wx).to(torch.float32)[:, None, None]
        for iy in (0, 1):
            wys = (wy if iy else 1 - wy).to(torch.float32)
            for iz in (0, 1):
                wzs = (wz if iz else 1 - wz).to(torch.float32)
                v = vol[(x0 + ix)[:, None, None], (y0 + iy)[None], (z0 + iz)[None]]
                out = out + v * wxs * (wys * wzs)[None]
    return out * inside


def augment(vols: torch.Tensor, draws) -> torch.Tensor:
    """(B, X, Y, Z) float32 normalized volumes augmented row by row: the
    flip of the first spatial axis first, then the rotation and zoom."""
    out = []
    for v, (flip, angle, zoom) in zip(vols, draws):
        if flip:
            v = v.flip(0)
        if angle != 0.0 or zoom != 1.0:
            v = rotate_zoom(v, angle, zoom)
        out.append(v)
    return torch.stack(out)
