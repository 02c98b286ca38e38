"""Per-sample intensity normalization (port of the TPU package's
ops/normalize.py).

Both functions take (B, X, Y, Z, C) batches and normalize each sample over
its spatial and channel axes.

- `scale_intensity` is K1 (ops/fused_gather.py) with identity indices: the
  CUDA kernel on a card, its plain version on the CPU. The port keeps no
  second, unfused min-max normalize.
- `adaptive_normal` is plain PyTorch (`torch.sort`), as it is plain XLA in
  the TPU package.
"""

from __future__ import annotations

import torch

from .fused_gather import gather_normalize


def scale_intensity(batch: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """Per-sample min-max to [0, 1] (MONAI ScaleIntensityd default)."""
    idx = torch.arange(batch.shape[0], device=batch.device)
    return gather_normalize(batch.contiguous(), idx, out_dtype)


def adaptive_normal(batch: torch.Tensor, min_p: float = 0.001,
                    max_p: float = 0.999) -> torch.Tensor:
    """Per-sample percentile normalize to [-1, 1].

    Sorts the flattened volume with negatives replaced by +inf (so they
    land at the tail), counts the n non-negative voxels per sample, and
    picks at the round-half-up index int((n-1)*p + 0.5), as the reference
    AdaptiveNormal does over the non-negative voxels only."""
    x = batch.to(torch.float32)
    b = x.shape[0]
    flat = x.reshape(b, -1)
    nonneg = flat >= 0
    n = nonneg.sum(dim=1)
    sorted_vals = torch.sort(
        torch.where(nonneg, flat, torch.full_like(flat, float("inf"))),
        dim=1).values

    def pick(p):
        idx = torch.floor((n - 1).to(torch.float32) * p + 0.5).to(torch.long)
        idx = torch.minimum(idx.clamp(min=0), (n - 1).clamp(min=0))
        return sorted_vals.gather(1, idx[:, None])[:, 0]

    lo, hi = pick(min_p), pick(max_p)
    mean = (hi + lo) / 2.0
    std = torch.clamp((hi - lo) / 2.0, min=1e-12)
    shape = (b,) + (1,) * (x.dim() - 1)
    out = (x - mean.reshape(shape)) / std.reshape(shape)
    return torch.clamp(out, -1.0, 1.0)


NORMALIZERS = {
    "scale_intensity": scale_intensity,
    "adaptive_normal": adaptive_normal,
}
