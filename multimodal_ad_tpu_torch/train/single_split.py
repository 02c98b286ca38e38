"""Single-split U-Net classifier trainer (port of the TPU package's
train/single_split.py; the reference's train_unet3d.py).

The 64/16/20 split of two seed-`cfg.seed` stratified splits (data/splits.py),
a `VolumeBatcher` with the training transform (host-planned augmentation
when ``cfg.augment``, data/transforms.py) and one with the evaluation
transform, K1 on every batch (train/cv.py::_device_batches), AdamW at
``cfg.weight_decay`` with no gradient clip, plain cross entropy (unit
class weights), a cosine from ``cfg.lr`` to 0 over max(1, num_epochs)
counts that optax evaluates at the update count (so the rate is 0 from
update num_epochs on, train/loop.py), bf16 autocast by default, the
unet_results.csv log (fold 1), and the best checkpoint by validation AUC
in `best_model`. Runs on the card unless ``device="cpu"`` is given.
Under a mesh (by default `make_mesh(cfg.mesh_shape)` under a process
group) each rank trains on its rows of every batch, as train_cv does; the
mesh's first rank writes the CSV and the checkpoint.
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
from ..data.splits import stratified_test_split
from ..data.transforms import make_transforms
from ..models.unet3d import UNet3DClassifier
from ..parallel import mesh as pmesh
from ..utils.logging import cv_logger
from . import checkpoint as ckpt
from .cv import _run_epoch
from .loop import (cosine_decay_schedule, create_train_state, eval_step, next_epoch,
                   train_step)


def single_split(records, seed: int):
    """(train, val, test) records: a stratified 0.2 test split, then a 0.2
    validation split of the rest (64/16/20)."""
    train_val, test = stratified_test_split(records, 0.2, seed)
    train, val = stratified_test_split(train_val, 0.2, seed)
    return train, val, test


def train_unet_classifier(cfg: Config, records=None, loader=None, model=None,
                          verbose=True, device: str | torch.device = "cuda", mesh=None):
    """Train on the 64 % split, select by the 16 % split's AUC. Returns
    (best_val_auc, checkpoint_dir); (None, checkpoint_dir) on a rank outside
    the mesh. `model` replaces the config's UNet3DClassifier (base 32,
    initial weights drawn from a generator seeded with cfg.seed); `records`
    the manifest; `loader` the NIfTI loader; `mesh` as train_cv's."""
    dev = resolve_device(device)
    mesh, main = pmesh.resolve_mesh(mesh, cfg.mesh_shape, cfg.batch_size)
    if main is None:
        return None, cfg.checkpoint_dir
    verbose = verbose and main
    np.random.seed(cfg.seed)
    if model is None:
        model = UNet3DClassifier(in_channels=cfg.in_channels, num_classes=cfg.nb_class,
                                 compute_dtype=torch_dtype(cfg.compute_dtype),
                                 generator=torch.Generator().manual_seed(cfg.seed))
    if records is None:
        records = ADNIManifest(cfg.label_file, cfg.mri_dir, cfg.task,
                               cfg.augment, verbose=verbose).data_dict
    train_data, val_data, _ = single_split(records, cfg.seed)

    tf_train, tf_eval = make_transforms(cfg.augment, seed=cfg.seed)
    kw = dict(batch_size=cfg.batch_size, num_threads=cfg.loader_threads,
              loader=loader or load_volume)
    loader_tr = VolumeBatcher(train_data, shuffle=True, seed=cfg.seed,
                              transform=tf_train, **kw)
    loader_vl = VolumeBatcher(val_data, transform=tf_eval, **kw)

    state = create_train_state(model.to(dev), cosine_decay_schedule(cfg.lr, max(1, cfg.num_epochs)),
                               cfg.weight_decay, grad_clip_norm=0.0, optimizer="adamw",
                               mesh=mesh)
    cw = torch.ones(cfg.nb_class, device=dev)  # plain CE
    logger = cv_logger(main, cfg.checkpoint_dir, csv_name="unet_results.csv")
    run_kw = dict(normalizer=cfg.normalizer, prefetch_depth=cfg.prefetch_depth, mesh=mesh)

    best_auc = -np.inf
    best_path = os.path.join(cfg.checkpoint_dir, "best_model")
    for epoch in range(1, cfg.num_epochs + 1):
        t0 = time.time()
        state, tr_loss, tr_m = _run_epoch(train_step, state, loader_tr, dev, train=True,
                                          class_weights=cw, **run_kw)
        _, vl_loss, vl_m = _run_epoch(eval_step, state, loader_vl, dev, train=False,
                                      **run_kw)
        lr_now = state.lr()  # schedule(epoch), as the TPU package logs it
        next_epoch(state)
        logger.log_epoch(1, epoch, tr_m, tr_loss, vl_m, vl_loss, lr_now)
        if verbose:
            print(f"Epoch {epoch:03d} | Train ACC={tr_m['ACC']:.4f} "
                  f"F1={tr_m['F1']:.4f} AUC={tr_m['AUC']:.4f} | "
                  f"Val ACC={vl_m['ACC']:.4f} F1={vl_m['F1']:.4f} "
                  f"AUC={vl_m['AUC']:.4f} | time={time.time() - t0:.1f}s")
        if vl_m["AUC"] > best_auc:  # best by AUC (reference train_unet3d.py:215)
            best_auc = vl_m["AUC"]
            if main:
                ckpt.save_checkpoint(best_path, state,
                                     metrics={"val_auc": vl_m["AUC"], "epoch": epoch},
                                     config=cfg.to_dict())
    logger.close()
    pmesh.barrier(mesh, dev)
    return best_auc, cfg.checkpoint_dir
