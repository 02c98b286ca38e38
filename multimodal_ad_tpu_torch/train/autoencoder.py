"""U-Net 3-D denoising autoencoder (port of the TPU package's
train/autoencoder.py).

The reference extracts ROI features from an untrained UNet3D. This trainer
gives extraction learned weights: UNet3D(1 -> 1) learns to reconstruct the
clean volume from one whose voxels are each kept with probability
1 - `noise_rate` (0.2) and zeroed otherwise; the loss is the per-sample
MSE, averaged over the real rows of a padded batch. The 64/16/20 split of
the U-Net classifier trainer (train/single_split.py), K1 on every batch,
gradient clip 1.0 + AdamW (weight decay 1e-4, optax's default) under a
cosine from ``cfg.lr`` to 0 over max(1, num_epochs) update counts,
``cfg.compute_dtype`` autocast (bf16 by default), the validation MSE
without noise, losses fetched once an epoch, and the best checkpoint by
validation MSE in `unet_ae_best`. `load_autoencoder` restores it for
eval/features.py::extract_unet_features(model=...).

The keep masks come from a `torch.Generator` on the device seeded with
``cfg.seed + 7``; the TPU package draws ``bernoulli(fold_in(key, step))``,
so the masks follow the same distribution, not the same samples. A train
step takes an explicit `keep` mask instead where one is given.

Under a mesh (by default `make_mesh(cfg.mesh_shape)` under a process
group) each rank trains on its rows of every batch; the keep mask is
drawn for the global batch from the same generator on every rank and
sliced, so W ranks draw the masks one process draws. The MSE divides by the global count of real rows, and the mesh's
first rank writes the checkpoint.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..core.config import Config, torch_dtype
from ..core.device import resolve_device
from ..data.adni import ADNIManifest
from ..data.pipeline import VolumeBatcher, load_volume
from ..models.unet3d import UNet3D
from ..parallel import mesh as pmesh
from . import checkpoint as ckpt
from .cv import _device_batches
from .loop import (TrainState, apply_gradients, backward_mean, cosine_decay_schedule,
                   create_train_state, global_mean, next_epoch)
from .single_split import single_split

WEIGHT_DECAY = 1e-4  # optax.adamw's default, which the TPU package keeps


def _mse_sums(recon, image, mask):
    per_sample = ((recon.float() - image) ** 2).mean(dim=(1, 2, 3, 4))
    return (per_sample * mask).sum(), mask.sum()


def reconstruction_mse(recon, image, mask):
    """Per-sample mean squared error, averaged over the rows `mask` marks."""
    num, den = _mse_sums(recon, image, mask)
    return num / den.clamp(min=1e-8)


def make_ae_steps(noise_rate: float = 0.2, generator: torch.Generator | None = None):
    """(train_step, eval_step). ``train_step(state, batch, keep=None)`` zeroes
    the voxels where `keep` is False (drawn from `generator` when not
    given; under a mesh drawn for the global batch and sliced to this
    rank's rows), reconstructs, takes one update and returns the loss;
    ``eval_step(state, batch)`` returns the noise-free validation loss
    (global under a mesh). Both keep the loss on the device."""

    def train_step(state: TrainState, batch: dict, keep=None):
        image = batch["image"]
        if keep is None:
            w = pmesh.data_size(state.mesh)
            rows = pmesh.local_rows(w * image.shape[0], state.mesh)
            keep = torch.rand((w * image.shape[0], *image.shape[1:]), generator=generator,
                              device=image.device)[rows] < 1.0 - noise_rate
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        recon = state.train_module(image * keep.to(image.dtype))
        loss = backward_mean(state, *_mse_sums(recon, image, batch["mask"]))
        apply_gradients(state)
        return loss

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict):
        state.model.eval()
        return global_mean(*_mse_sums(state.model(batch["image"]), batch["image"],
                                      batch["mask"]), state.mesh)

    return train_step, eval_step


def _default_model(cfg: Config, seed: int | None = None) -> UNet3D:
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    return UNet3D(in_channels=cfg.in_channels, num_classes=1,
                  compute_dtype=torch_dtype(cfg.compute_dtype), generator=gen)


def train_unet_autoencoder(cfg: Config, records=None, loader=None, model=None,
                           noise_rate: float = 0.2, verbose=True,
                           device: str | torch.device = "cuda", mesh=None):
    """Train on the 64 % split, select by the 16 % split's MSE. Returns
    (best_val_mse, checkpoint_path); (None, checkpoint_path) on a rank
    outside the mesh. `model` replaces the config's UNet3D (64/128/256/512,
    initial weights drawn from a generator seeded with cfg.seed); `mesh` as
    train_cv's."""
    dev = resolve_device(device)
    best_path = os.path.join(cfg.checkpoint_dir, "unet_ae_best")
    mesh, main = pmesh.resolve_mesh(mesh, cfg.mesh_shape, cfg.batch_size)
    if main is None:
        return None, best_path
    verbose = verbose and main
    np.random.seed(cfg.seed)
    model = model if model is not None else _default_model(cfg, cfg.seed)
    if records is None:
        records = ADNIManifest(cfg.label_file, cfg.mri_dir, cfg.task,
                               augment=False, verbose=verbose).data_dict
    train_data, val_data, _ = single_split(records, cfg.seed)
    kw = dict(batch_size=cfg.batch_size, num_threads=cfg.loader_threads,
              loader=loader or load_volume)
    loader_tr = VolumeBatcher(train_data, shuffle=True, seed=cfg.seed, **kw)
    loader_vl = VolumeBatcher(val_data, **kw)

    state = create_train_state(model.to(dev), cosine_decay_schedule(cfg.lr, max(1, cfg.num_epochs)),
                               WEIGHT_DECAY, grad_clip_norm=1.0, optimizer="adamw",
                               mesh=mesh)
    train_step, eval_step = make_ae_steps(
        noise_rate, torch.Generator(device=dev).manual_seed(cfg.seed + 7))
    if main:
        os.makedirs(cfg.checkpoint_dir, exist_ok=True)

    def batches(loader):
        return _device_batches(loader, dev, cfg.normalizer, cfg.prefetch_depth, mesh)

    def mean(losses) -> float:  # the epoch's one device -> host fetch
        return float(np.mean(torch.stack(losses).cpu().numpy().astype(np.float64)))

    best = np.inf
    for epoch in range(1, cfg.num_epochs + 1):
        t0 = time.time()
        tr = mean([train_step(state, b) for b in batches(loader_tr)])
        vl = mean([eval_step(state, b) for b in batches(loader_vl)])
        next_epoch(state)
        if verbose:
            print(f"AE Ep{epoch:03d} | train MSE={tr:.5f} | val MSE={vl:.5f} | "
                  f"{time.time() - t0:.1f}s")
        if vl < best:
            best = vl
            if main:
                ckpt.save_checkpoint(best_path, state, metrics={"val_mse": vl, "epoch": epoch},
                                     config=cfg.to_dict())
    pmesh.barrier(mesh, dev)
    return best, best_path


def load_autoencoder(ckpt_path: str, cfg: Config, model=None,
                     device: str | torch.device = "cuda") -> UNet3D:
    """The autoencoder of `ckpt_path` (a `train_unet_autoencoder`
    checkpoint), in eval mode on `device`, for
    eval/features.py::extract_unet_features(model=...). `model` is the
    architecture to load into (default: the config's UNet3D)."""
    dev = resolve_device(device)
    model = model if model is not None else _default_model(cfg)
    weights, _ = ckpt.restore_state(ckpt_path)
    model.load_state_dict(weights)
    return model.eval().to(dev)
