"""Device resolution and the precision policy.

Entry points take an explicit ``device`` (default ``"cuda"``). Asking for
CUDA on a machine without a card raises: the port never falls back to the
host quietly.

Precision: a float32 convolution goes through cuDNN in TF32 unless
``torch.backends.cudnn.allow_tf32`` is False, and TF32 keeps about three
decimal digits. The fp32 path must be fp32, so both TF32 switches are set
off explicitly. The bf16 path (autocast, models/resnet3d.py) is not
affected by them. ``cudnn.benchmark`` picks the fastest algorithm per
convolution shape; how serving's batch buckets are tuned is set out in
serve.py (`EnsemblePredictor._warm_buckets`).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if it is CUDA and no card is
    present. On CUDA, also sets the precision flags (idempotent)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested but no CUDA device is "
                "available; pass device='cpu' to run on the host")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.benchmark = True
    return dev
