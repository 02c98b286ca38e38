"""What the benchmark makes from `--seed` and hands to both the program and
the reference: seeded sub-streams, brain-like volumes and ResNet weights,
all drawn on the run's device in a few large calls."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import resnet3d as ref

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


def init_weights(depth: int, in_channels: int, num_classes: int, seed: int,
                 device) -> dict:
    """A fold's initial float32 state dict (MedicalNet names): convolutions
    Kaiming-normal by fan-out, as the program and MedicalNet initialise
    them, from one normal draw; BatchNorm scale 1, shift 0, running mean 0,
    variance 1; the Linear uniform in +-1/sqrt(fan_in), from one uniform
    draw."""
    dev = torch.device(device)
    g = generator(seed, dev)
    shapes = ref.param_shapes(depth, in_channels, num_classes)
    convs = [(k, s) for k, s in shapes.items() if len(s) == 5]
    sizes = [int(np.prod(s)) for _, s in convs]
    std = torch.tensor([(2.0 / (s[0] * s[2] * s[3] * s[4])) ** 0.5 for _, s in convs],
                       device=dev)
    flat = torch.randn(sum(sizes), generator=g, device=dev) * torch.repeat_interleave(
        std, torch.tensor(sizes, device=dev))
    sd = {}
    for (k, s), part in zip(convs, torch.split(flat, sizes)):
        sd[k] = part.view(s)
    fc_w, fc_b = shapes["conv_seg.3.weight"], shapes["conv_seg.3.bias"]
    bound = fc_w[1] ** -0.5
    u = (torch.rand(int(np.prod(fc_w)) + fc_b[0], generator=g, device=dev) * 2 - 1) * bound
    sd["conv_seg.3.weight"] = u[:int(np.prod(fc_w))].view(fc_w)
    sd["conv_seg.3.bias"] = u[int(np.prod(fc_w)):]
    for k, s in shapes.items():
        if k in sd:
            continue
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.zeros((), dtype=torch.long, device=dev)
        elif k.endswith(("weight", "running_var")):
            sd[k] = torch.ones(s, device=dev)
        else:
            sd[k] = torch.zeros(s, device=dev)
    return sd


def trained_affine(sd: dict, seed: int, device) -> dict:
    """Serving weights stand for trained folds, whose BatchNorm scales and
    shifts spread over channels (where int8's per-tensor activation scales
    lose the small channels' precision): every BatchNorm's scale drawn
    log-normal (sigma 1) and its shift normal (0.25), in one draw."""
    keys = [k[:-len(".running_var")] for k in sd if k.endswith(".running_var")]
    sizes = [sd[f"{k}.weight"].numel() for k in keys]
    z = torch.randn(2 * sum(sizes), generator=generator(seed, device), device=torch.device(device))
    scale, shift = torch.split(z, sum(sizes))
    for k, a, b in zip(keys, torch.split(scale, sizes), torch.split(shift, sizes)):
        sd[f"{k}.weight"] = torch.exp(a)
        sd[f"{k}.bias"] = 0.25 * b
    return sd


@torch.no_grad()
def calibrate_batchnorm(sd: dict, x: torch.Tensor, depth: int) -> dict:
    """Serving weights: the running statistics of every BatchNorm set to the
    batch statistics of a reference forward over `x` (normalized NCDHW
    volumes), so the eval-mode network sees normalized activations, as a
    trained one does."""
    stats = {}
    ref.forward(sd, x, depth, train=True, stats=stats)
    for prefix, (mean, var) in stats.items():
        sd[f"{prefix}.running_mean"] = mean.clone()
        sd[f"{prefix}.running_var"] = var.clone()
    return sd
