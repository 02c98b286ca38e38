"""Multimodal fusion training: MRI (+ PET) (+ clinical table) -> diagnosis
(port of the TPU package's train/fusion.py).

Per fold of the seed-42 CV skeleton (train/cv.py's splits):

- volumes stream through `VolumeBatcher` (the MRI and, with PET, the PET
  of every record) into train/cv.py's epoch loop, which uploads them ahead
  and normalizes each modality on the device (a K1 launch each for
  scale_intensity); with ``augment`` one host-planned augmentation per row
  is applied to both modalities alike;
- the clinical table is embedded per subject by the in-context learner,
  fitted on that fold's training subjects only (`embed_table_per_fold`);
- the model (`MultimodalClassifier`, or `DAFTResNet` with
  ``arch="daft"``) trains with the class-weighted CE and Adam with warmup
  -> cosine of train/loop.py; dropout draws from a generator seeded
  ``seed * 131 + fold``;
- losses and probabilities stay on the device until an epoch ends (one
  host fetch an epoch); the epoch log goes to ``fusion_results.csv`` and
  the best epoch by 0.3 AUC + 0.7 ACC to ``fusion_best_fold{k}``. With
  more than two classes the metrics are cv.py's multiclass ones (the TPU
  package scores the class-1 column).

A ragged last batch is padded with real rows: BatchNorm sees them, the
loss and the metrics mask them out, as in the TPU package. Runs on the
card unless ``device="cpu"`` is given; under a mesh (by default
`make_mesh(cfg.mesh_shape)` under a process group) each rank trains on
its rows of every batch as train_cv does (global BatchNorm, losses and
metrics; the mesh's first rank writes the CSV and the checkpoints; each
rank fits the same table embedder).
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
from ..data.splits import stratified_kfold, stratified_test_split
from ..data.transforms import make_transforms
from ..parallel import mesh as pmesh
from ..utils.logging import cv_logger
from . import checkpoint as ckpt
from .cv import _run_epoch, class_weight_vector
from .loop import (TrainState, apply_gradients, backward_weighted_ce, create_train_state,
                   make_epoch_schedule, masked_ce, next_epoch)
from .metrics import METRIC_KEYS, model_selection_score


def make_fusion_model(cfg: Config, arch: str = "cross_transformer", use_pet: bool = False,
                      use_table: bool = False, table_dim: int | None = None,
                      model_kw: dict | None = None, seed: int = 0) -> torch.nn.Module:
    """The config's fusion model, initial weights drawn from a generator
    seeded `seed`, parameters in ``cfg.param_dtype``."""
    gen = torch.Generator().manual_seed(int(seed))
    kw = dict(num_classes=cfg.nb_class, compute_dtype=torch_dtype(cfg.compute_dtype),
              generator=gen, **(model_kw or {}))
    if arch == "daft":
        from ..models.daft import DAFTResNet

        model = DAFTResNet(dropout_rate=cfg.dropout_rate, table_dim=table_dim, **kw)
    else:
        from ..models.transformer import MultimodalClassifier

        model = MultimodalClassifier(use_pet=use_pet, use_table=use_table,
                                     table_dim=table_dim, dropout=cfg.dropout_rate, **kw)
    return model.to(dtype=torch_dtype(cfg.param_dtype))


def _inputs(batch: dict, arch: str, use_pet: bool, use_table: bool) -> dict:
    if arch == "daft":
        return {"table": batch["table"]}
    kw = {}
    if use_pet:
        kw["pet"] = batch["pet"]
    if use_table:
        kw["table"] = batch["table"]
    return kw


def make_fusion_steps(arch: str = "cross_transformer", use_pet: bool = False,
                      use_table: bool = False):
    """(train_step(state, batch, class_weights) -> (loss, probs),
    eval_step(state, batch) -> (loss, probs)) on the port's TrainState, the
    model fed the batch's image and, per `arch` and modality set, its 'pet'
    and 'table'. Both keep their outputs on the device; under a mesh the
    losses are global and the probabilities this rank's rows'."""
    def train_step(state: TrainState, batch: dict, class_weights):
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        logits = state.train_module(batch["image"],
                                    **_inputs(batch, arch, use_pet, use_table)).float()
        loss = backward_weighted_ce(state, logits, batch, class_weights)
        apply_gradients(state)
        return loss, torch.softmax(logits.detach(), dim=-1)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict):
        state.model.eval()
        logits = state.model(batch["image"], **_inputs(batch, arch, use_pet, use_table)).float()
        return (masked_ce(logits, batch["label"], batch["mask"], state.mesh),
                torch.softmax(logits, dim=-1))

    return train_step, eval_step


def embed_table_per_fold(table_X, table_y, subjects, train_subjects, embedder=None,
                         device: str | torch.device = "cuda") -> dict:
    """Fit the tabular embedder (default ``ICLClassifier(device=device)``)
    on the fold's TRAIN subjects only; embed every subject. Returns
    {subject: vector}."""
    if embedder is None:
        from ..tabular.icl import ICLClassifier

        embedder = ICLClassifier(device=str(device))
    sub_idx = {s: i for i, s in enumerate(subjects)}
    tr = [sub_idx[s] for s in train_subjects if s in sub_idx]
    embedder.fit(table_X[tr], table_y[tr])
    emb = embedder.get_embeddings(table_X)[0]  # (n, d)
    return {s: emb[sub_idx[s]] for s in subjects}


def _table_lookup(use_table, table_data, train_subjects, embedder, device):
    if not use_table:
        return None, None
    if table_data is None:
        raise ValueError("use_table=True requires table_data")
    tX, ty, tsubj = table_data
    lookup = embed_table_per_fold(tX, ty, tsubj, train_subjects, embedder, device)
    return lookup, len(next(iter(lookup.values())))


def _check_arch(arch, use_pet, use_table):
    if arch == "daft" and (not use_table or use_pet):
        raise ValueError("arch='daft' fuses image+table (use_table=True, use_pet=False)")


def train_fusion_cv(cfg: Config, use_pet: bool = False, use_table: bool = False,
                    table_data=None, model_kw=None, records=None,
                    device: str | torch.device = "cuda", loader=None, embedder=None,
                    verbose=True, arch: str = "cross_transformer", mesh=None):
    """CV training of a fusion model; returns (best score per fold,
    checkpoint_dir); (None, checkpoint_dir) on a rank outside the mesh.

    arch: 'cross_transformer' (models/transformer.py) or 'daft'
    (models/daft.py; requires use_table=True, no PET). table_data: (X, y,
    subjects) for the clinical branch, subjects matching the manifest's
    Subject ids. `loader` replaces the NIfTI volume loader; `mesh` as
    train_cv's."""
    _check_arch(arch, use_pet, use_table)
    dev = resolve_device(device)
    mesh, main = pmesh.resolve_mesh(mesh, cfg.mesh_shape, cfg.batch_size)
    if main is None:
        return None, cfg.checkpoint_dir
    verbose = verbose and main
    np.random.seed(cfg.seed)
    if records is None:
        records = ADNIManifest(cfg.label_file, cfg.mri_dir, cfg.task, cfg.augment,
                               pet_dir=cfg.pet_dir if use_pet else None,
                               verbose=verbose).data_dict
    tr_val, _ = stratified_test_split(records, cfg.split_ratio, cfg.seed)
    train_step, eval_step = make_fusion_steps(arch, use_pet, use_table)
    logger = cv_logger(main, cfg.checkpoint_dir, csv_name="fusion_results.csv")
    tf_train, tf_eval = make_transforms(cfg.augment, seed=cfg.seed)
    schedule = make_epoch_schedule(cfg.lr, cfg.num_epochs, cfg.warmup_frac, cfg.min_lr_factor)
    batcher_kw = dict(batch_size=cfg.batch_size, num_threads=cfg.loader_threads,
                      image_keys=("MRI", "PET") if use_pet else ("MRI",),
                      loader=loader or load_volume)

    best_scores = []
    for fold, train_data, val_data in stratified_kfold(tr_val, cfg.n_splits, cfg.seed):
        if verbose:
            print(f"\n=== Fusion fold {fold}/{cfg.n_splits} ===")
        lookup, table_dim = _table_lookup(use_table, table_data,
                                          [r["Subject"] for r in train_data], embedder, dev)
        loader_tr = VolumeBatcher(train_data, shuffle=True, seed=cfg.seed + fold,
                                  transform=tf_train, table_lookup=lookup, **batcher_kw)
        loader_vl = VolumeBatcher(val_data, transform=tf_eval, table_lookup=lookup,
                                  **batcher_kw)
        model = make_fusion_model(cfg, arch, use_pet, use_table, table_dim, model_kw,
                                  seed=cfg.seed + fold)
        state = create_train_state(model.to(dev), schedule, cfg.weight_decay,
                                   cfg.grad_clip_norm, "adam",
                                   dropout_seed=cfg.seed * 131 + fold, mesh=mesh)
        cw = torch.from_numpy(class_weight_vector(
            [d["label"] for d in train_data], cfg.nb_class)).to(dev)

        best = -np.inf
        for epoch in range(1, cfg.num_epochs + 1):
            t0 = time.time()
            state, tr_loss, tr_m = _run_epoch(
                train_step, state, loader_tr, dev, train=True, class_weights=cw,
                normalizer=cfg.normalizer, prefetch_depth=cfg.prefetch_depth, mesh=mesh)
            _, vl_loss, vl_m = _run_epoch(
                eval_step, state, loader_vl, dev, train=False,
                normalizer=cfg.normalizer, prefetch_depth=cfg.prefetch_depth, mesh=mesh)
            lr_now = state.lr()
            next_epoch(state)
            logger.log_epoch(fold, epoch, tr_m, tr_loss, vl_m, vl_loss, lr_now)
            if verbose:
                print(f"Fold{fold} Ep{epoch:03d} | TR ACC={tr_m['ACC']:.4f} "
                      f"AUC={tr_m['AUC']:.4f} | VL ACC={vl_m['ACC']:.4f} "
                      f"AUC={vl_m['AUC']:.4f} | {time.time() - t0:.1f}s")
            score = model_selection_score(vl_m, cfg.best_metric_weights)
            if score > best:
                best = score
                if main:
                    ckpt.save_checkpoint(
                        os.path.join(cfg.checkpoint_dir, f"fusion_best_fold{fold}"), state,
                        metrics={"val_auc": vl_m["AUC"], "epoch": epoch, "score": score},
                        config=cfg.to_dict())
        best_scores.append(best)
        pmesh.barrier(mesh, dev)
    logger.close()
    return best_scores, cfg.checkpoint_dir


def test_fusion_models(cfg: Config, test_data, use_pet: bool = False, use_table: bool = False,
                       table_data=None, model_kw=None, device: str | torch.device = "cuda",
                       loader=None, embedder=None, train_subjects=None, verbose=True,
                       arch: str = "cross_transformer", mesh=None):
    """Evaluation of each fold's `fusion_best_fold{k}` on the held-out test
    split; returns {'avg': the seven metrics averaged over folds,
    'per_fold': [...]} (None on a rank outside the mesh). `train_subjects`
    (default: every table subject not in `test_data`) restricts the table
    embedder's fit to training rows; `mesh` as train_cv's."""
    _check_arch(arch, use_pet, use_table)
    dev = resolve_device(device)
    mesh, main = pmesh.resolve_mesh(mesh, cfg.mesh_shape, cfg.batch_size)
    if main is None:
        return None
    verbose = verbose and main
    if use_table and table_data is not None and train_subjects is None:
        test_ids = {r["Subject"] for r in test_data}
        train_subjects = [s for s in table_data[2] if s not in test_ids]
    lookup, table_dim = _table_lookup(use_table, table_data, train_subjects, embedder, dev)
    _, tf_eval = make_transforms(False)
    loader_te = VolumeBatcher(test_data, batch_size=cfg.batch_size,
                              num_threads=cfg.loader_threads,
                              image_keys=("MRI", "PET") if use_pet else ("MRI",),
                              loader=loader or load_volume, transform=tf_eval,
                              table_lookup=lookup)
    _, eval_step = make_fusion_steps(arch, use_pet, use_table)
    all_metrics = []
    for fold in range(1, cfg.n_splits + 1):
        model = make_fusion_model(cfg, arch, use_pet, use_table, table_dim, model_kw)
        weights, _ = ckpt.restore_state(
            os.path.join(cfg.checkpoint_dir, f"fusion_best_fold{fold}"))
        model.load_state_dict(weights)
        state = TrainState(model.to(dev), optimizer=None, schedule=None, mesh=mesh)
        _, _, m = _run_epoch(eval_step, state, loader_te, dev, train=False,
                             normalizer=cfg.normalizer, prefetch_depth=cfg.prefetch_depth,
                             mesh=mesh)
        all_metrics.append(m)
        if verbose:
            print(f"fusion fold {fold} test: ACC={m['ACC']:.4f} AUC={m['AUC']:.4f}")
    avg = {k: float(np.mean([m[k] for m in all_metrics])) for k in METRIC_KEYS}
    return {"avg": avg, "per_fold": all_metrics}
