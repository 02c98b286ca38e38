"""What the benchmark makes from `--seed` and hands to both the program and
the reference: seeded sub-streams and brain-like volumes, drawn on the
run's device in a few large calls (each model family draws its weights
from `generator`)."""

from __future__ import annotations

import numpy as np
import torch

VOLUME_CHUNK = 16  # volumes drawn per noise call (fixed: the draws depend on it)


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for the stream `tags` of run seed `seed` (any integer)."""
    words = [int(seed) & (2 ** 64 - 1)] + [int(t) if isinstance(t, int) else
                                           int.from_bytes(str(t).encode()[:8], "little")
                                           for t in tags]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def brain_volumes(n: int, shape, seed: int, device, dtype=torch.float32,
                  ad=None) -> np.ndarray:
    """(n, X, Y, Z) host volumes: a noisy ellipsoidal brain with darker
    ventricles on a zero background, intensities in the int16 range. `ad`
    (a bool per volume) widens the ventricles of AD subjects. Drawn on
    `device` in chunks of VOLUME_CHUNK, returned in `dtype` on the host."""
    dev = torch.device(device)
    g = generator(seed, dev)
    params = torch.rand((n, 12), generator=g, device=dev, dtype=torch.float32)
    ad_t = (torch.zeros(n, device=dev) if ad is None
            else torch.as_tensor(np.asarray(ad, np.float32), device=dev))
    out = np.empty((n,) + tuple(shape), dtype=torch.empty(0, dtype=dtype).numpy().dtype)
    axes = [torch.arange(d, device=dev, dtype=torch.float32) for d in shape]
    for s in range(0, n, VOLUME_CHUNK):
        e = min(n, s + VOLUME_CHUNK)
        p = params[s:e]
        r2 = torch.zeros((e - s,) + tuple(shape), device=dev)
        v2 = torch.zeros_like(r2)
        for a, (d, ax) in enumerate(zip(shape, axes)):
            view = [e - s] + [1, 1, 1]
            view[1 + a] = d
            mu = 0.5 * (d - 1) + (p[:, a] - 0.5) * 0.08 * d
            rad = d * (0.36 + 0.06 * p[:, 3 + a])
            vrad = rad * (0.16 + 0.08 * p[:, 6 + a] + 0.06 * ad_t[s:e])
            off = ax.view(view[1:]).unsqueeze(0) - mu.view(-1, 1, 1, 1)
            r2 = r2 + (off / rad.view(-1, 1, 1, 1)) ** 2
            v2 = v2 + (off / vrad.view(-1, 1, 1, 1)) ** 2
        level = (800.0 + 1600.0 * p[:, 9]).view(-1, 1, 1, 1)
        noise = torch.randn(r2.shape, generator=g, device=dev)
        vol = level * (0.75 + 0.25 * (1 - r2)) * torch.where(v2 <= 1, 0.35, 1.0)
        vol = torch.where(r2 <= 1, vol + 0.05 * level * noise, torch.zeros_like(vol))
        vol = vol.clamp(0, 32767).round()
        out[s:e] = vol.to(dtype).cpu().numpy()
    return out
