"""Stratified K-fold cross-validation runner + fold-ensemble test (port of
the TPU package's train/cv.py).

The canonical training path: seed -> manifest -> stratified test split ->
StratifiedKFold CV (data/splits.py, sklearn's splits in numpy); per fold:
loaders, a model, class-weighted CE (1/bincount), Adam with warmup ->
cosine, gradient clip 1.0, per-epoch train + (optional precise-BN) +
validation with the seven metrics, CSV (+ TensorBoard) logging, the best
checkpoint by 0.3*AUC + 0.7*ACC, a rolling `last_fold{k}` resume point and
the final checkpoint; then `test_models` evaluates each fold's best
checkpoint on the held-out split.

Input paths:

- ``hbm_cache=True``: the train/validation corpus is decoded once and held
  on the device as float32; each batch is gathered and normalized there
  (K1 for scale_intensity) and, for training with ``augment=True``,
  augmented there (`DeviceEpochIterator`);
- otherwise `VolumeBatcher` decodes on host threads, `device_prefetch`
  uploads, and the batch is normalized on the device (K1 for
  scale_intensity). Host augmentation (the TPU package's
  data/transforms.py) is not ported: ``augment=True`` needs
  ``hbm_cache=True``.

Losses and probabilities stay on the device until an epoch ends: one host
fetch per epoch, so queued steps run back to back. Runs on the card unless
``device="cpu"`` is given.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from ..core.config import Config, torch_dtype
from ..core.device import resolve_device
from ..data.adni import ADNIManifest
from ..data.device_cache import DeviceEpochIterator, build_device_dataset
from ..data.pipeline import VolumeBatcher, device_prefetch, load_volume
from ..data.splits import stratified_kfold, stratified_test_split
from ..models.resnet3d import generate_model
from ..ops.normalize import NORMALIZERS
from ..utils.logging import CVLogger
from ..utils.profiling import StepTimer, trace
from . import checkpoint as ckpt
from .loop import (TrainState, create_train_state, eval_step, make_epoch_schedule,
                   next_epoch, recompute_batch_stats, train_step)
from .metrics import (METRIC_KEYS, calculate_metrics, calculate_metrics_multiclass,
                      model_selection_score, roc_curve)


def class_weight_vector(labels, num_classes: int) -> np.ndarray:
    """1 / bincount (reference train_ResNet3D.py:161-163)."""
    counts = np.bincount(labels, minlength=num_classes).astype(np.float32)
    return 1.0 / np.maximum(counts, 1.0)


def _make_model(cfg: Config, model_factory, seed: int):
    """`model_factory()` if given, else the config's ResNet3D with initial
    weights drawn from a generator seeded with `seed`."""
    if model_factory is not None:
        return model_factory()
    return generate_model(
        model_type=cfg.model_type, model_depth=cfg.model_depth,
        resnet_shortcut=cfg.resnet_shortcut, nb_class=cfg.nb_class,
        dropout_rate=cfg.dropout_rate, in_channels=cfg.in_channels,
        compute_dtype=torch_dtype(cfg.compute_dtype),
        param_dtype=torch_dtype(cfg.param_dtype),
        generator=torch.Generator().manual_seed(seed))


def _device_batches(loader, device, normalizer: str, depth: int):
    """Streamed host batches, uploaded ahead and normalized on the device."""
    normalize = NORMALIZERS[normalizer]
    for batch in device_prefetch(iter(loader), device, depth=depth):
        batch["image"] = normalize(batch["image"])
        yield batch


def _epoch_metrics(probs: np.ndarray, labels: np.ndarray, mask: np.ndarray) -> dict:
    y_true = labels[mask]
    y_prob = probs[mask]
    y_pred = np.argmax(y_prob, axis=-1)
    if y_prob.shape[-1] == 2:
        return calculate_metrics(y_true, y_pred, y_prob[:, 1])
    return calculate_metrics_multiclass(y_true, y_pred, y_prob)


def _run_epoch(step_fn, state, loader, device, *, train, class_weights=None,
               normalizer="scale_intensity", prefetch_depth=2, timer=None):
    """One pass over `loader`; returns (state, mean_loss, metrics).

    Device-resident loaders (`device_resident`) yield device batches;
    streaming loaders are uploaded and normalized by `_device_batches`."""
    if getattr(loader, "device_resident", False):
        batches = iter(loader)
    else:
        batches = _device_batches(loader, device, normalizer, prefetch_depth)

    losses, labels_l, masks_l, probs_l = [], [], [], []
    for batch in batches:
        with timer if timer is not None else contextlib.nullcontext():
            if train:
                loss, probs = step_fn(state, batch, class_weights)
            else:
                loss, probs = step_fn(state, batch)
        losses.append(loss)
        probs_l.append(probs)
        masks_l.append(batch["mask"])
        labels_l.append(batch["label"])

    # one device -> host fetch for the epoch
    probs = torch.cat(probs_l).cpu().numpy()
    mask = torch.cat(masks_l).cpu().numpy() > 0
    labels = torch.cat(labels_l).cpu().numpy()
    mean_loss = float(np.mean(torch.stack(losses).cpu().numpy().astype(np.float64)))
    return state, mean_loss, _epoch_metrics(probs, labels, mask)


def train_cv(cfg: Config, model_factory=None, records=None, loader=None,
             verbose=True, device: str | torch.device = "cuda"):
    """Run the full CV pipeline. Returns (test_results, checkpoint_dir).

    `model_factory()` builds a fresh model per fold (default: the config's
    ResNet3D, initial weights seeded with seed + fold); `records` replaces
    the manifest; `loader` replaces the NIfTI volume loader."""
    dev = resolve_device(device)
    if cfg.augment and not cfg.hbm_cache:
        raise NotImplementedError(
            "augment=True needs hbm_cache=True: the port augments on the "
            "device (ops/augment.py); host augmentation (data/transforms.py) "
            "is not ported")
    np.random.seed(cfg.seed)
    if records is None:
        records = ADNIManifest(cfg.label_file, cfg.mri_dir, cfg.task,
                               cfg.augment, verbose=verbose).data_dict
    tr_val, test_data = stratified_test_split(records, cfg.split_ratio, cfg.seed)
    loader = loader or load_volume

    device_ds = None
    if cfg.hbm_cache:
        # one decode + upload of the train/validation corpus; per-epoch
        # batches are gathered on the device
        if cfg.augment and verbose:
            print("[hbm_cache] using device-side augmentation "
                  "(flip + rotate + zoom, ops/augment.py)")
        device_ds = build_device_dataset(tr_val, device=dev, loader=loader,
                                         store_dtype=np.float32,
                                         num_threads=cfg.loader_threads)
        subj_to_idx = {r["Subject"]: i for i, r in enumerate(tr_val)}
        subjects = [r["Subject"] for r in tr_val]

    logger = CVLogger(cfg.checkpoint_dir)
    schedule = make_epoch_schedule(cfg.lr, cfg.num_epochs, cfg.warmup_frac,
                                   cfg.min_lr_factor)
    batcher_kw = dict(batch_size=cfg.batch_size, num_threads=cfg.loader_threads,
                      loader=loader)

    for fold, train_data, val_data in stratified_kfold(tr_val, cfg.n_splits, cfg.seed):
        if verbose:
            print(f"\n=== Fold {fold}/{cfg.n_splits} ===")
        if device_ds is not None:
            loader_tr = DeviceEpochIterator(
                device_ds, [subj_to_idx[r["Subject"]] for r in train_data],
                cfg.batch_size, shuffle=True, seed=cfg.seed + fold,
                subjects=subjects, augment=cfg.augment,
                normalizer=cfg.normalizer)
            loader_vl = DeviceEpochIterator(
                device_ds, [subj_to_idx[r["Subject"]] for r in val_data],
                cfg.batch_size, subjects=subjects, normalizer=cfg.normalizer)
        else:
            loader_tr = VolumeBatcher(train_data, shuffle=True,
                                      seed=cfg.seed + fold, **batcher_kw)
            loader_vl = VolumeBatcher(val_data, **batcher_kw)

        model = _make_model(cfg, model_factory, cfg.seed + fold)
        if cfg.pretrain_path and os.path.isfile(cfg.pretrain_path):
            # MedicalNet partial transfer by key intersection
            # (reference train_ResNet3D.py:74-81)
            from ..utils.torch_weights import (load_medicalnet_weights,
                                               load_torch_state_dict)
            load_medicalnet_weights(model, load_torch_state_dict(cfg.pretrain_path),
                                    verbose=verbose)
            if verbose:
                print("Loaded pretrained weights.")
        elif cfg.pretrain_path and verbose:
            print(f"[Warning] no pretrained file at {cfg.pretrain_path}")
        state = create_train_state(model.to(dev), schedule, cfg.weight_decay,
                                   cfg.grad_clip_norm, "adam",
                                   dropout_seed=cfg.seed * 1000 + fold)
        cw = torch.from_numpy(class_weight_vector(
            [d["label"] for d in train_data], cfg.nb_class)).to(dev)

        best_metric = -np.inf
        best_path = os.path.join(cfg.checkpoint_dir, f"best_fold{fold}")
        last_path = os.path.join(cfg.checkpoint_dir, f"last_fold{fold}")
        final_path = os.path.join(cfg.checkpoint_dir, f"model_fold{fold}_final")
        start_epoch = 1
        if cfg.resume and os.path.isdir(last_path):
            state, meta = ckpt.restore_state(last_path, state)
            done = int(meta.get("metrics", {}).get("epoch", 0))
            best_metric = float(meta.get("metrics", {}).get("best_metric", -np.inf))
            if done >= cfg.num_epochs:
                if verbose:
                    print(f"[resume] fold {fold}: {done}/{cfg.num_epochs} "
                          f"epochs already done; skipping")
                continue
            start_epoch = done + 1
            if verbose:
                print(f"[resume] fold {fold} from epoch {start_epoch}")
        # a step timer synchronizes every step: only when profiling
        step_timer = StepTimer() if cfg.profile_dir else None
        for epoch in range(start_epoch, cfg.num_epochs + 1):
            t0 = time.time()
            # profile the steady-state epoch (the 2nd, past cuDNN autotune)
            prof = trace(cfg.profile_dir) if (
                cfg.profile_dir and fold == 1 and epoch == 2
            ) else contextlib.nullcontext()
            with prof:
                state, tr_loss, tr_m = _run_epoch(
                    train_step, state, loader_tr, dev, train=True,
                    class_weights=cw, normalizer=cfg.normalizer,
                    prefetch_depth=cfg.prefetch_depth, timer=step_timer)
            if cfg.precise_bn:
                if getattr(loader_tr, "device_resident", False):
                    stat_batches = iter(loader_tr)
                else:
                    stat_batches = _device_batches(loader_tr, dev, cfg.normalizer,
                                                   cfg.prefetch_depth)
                recompute_batch_stats(state, stat_batches)
            _, vl_loss, vl_m = _run_epoch(
                eval_step, state, loader_vl, dev, train=False,
                normalizer=cfg.normalizer, prefetch_depth=cfg.prefetch_depth)

            lr_now = state.lr()  # schedule(epoch), as the TPU package logs it
            next_epoch(state)
            logger.log_epoch(fold, epoch, tr_m, tr_loss, vl_m, vl_loss, lr_now)
            if verbose:
                print(f"Fold{fold} Ep{epoch:03d} | "
                      f"TR ACC={tr_m['ACC']:.4f} AUC={tr_m['AUC']:.4f} "
                      f"loss={tr_loss:.4f} | "
                      f"VL ACC={vl_m['ACC']:.4f} AUC={vl_m['AUC']:.4f} "
                      f"loss={vl_loss:.4f} | lr={lr_now:.2e} "
                      f"time={time.time() - t0:.1f}s")

            score = model_selection_score(vl_m, cfg.best_metric_weights)
            if score > best_metric:
                best_metric = score
                ckpt.save_checkpoint(
                    best_path, state,
                    metrics={"train_auc": tr_m["AUC"], "val_auc": vl_m["AUC"],
                             "val_loss": vl_loss, "current_metric": score,
                             "epoch": epoch},
                    config=cfg.to_dict())
            if cfg.resume:  # rolling resume point
                ckpt.save_checkpoint(
                    last_path, state,
                    metrics={"epoch": epoch, "best_metric": best_metric},
                    config=cfg.to_dict())

        if verbose and step_timer is not None and step_timer.times:
            st = step_timer.summary()
            print(f"Fold{fold} train-step timing: mean={st['mean_s']*1000:.1f}ms "
                  f"p50={st['p50_s']*1000:.1f}ms p95={st['p95_s']*1000:.1f}ms "
                  f"({st['steps']} steps)")
        ckpt.save_checkpoint(
            final_path, state,
            metrics={"train_auc": tr_m["AUC"], "val_auc": vl_m["AUC"],
                     "val_loss": vl_loss},
            config=cfg.to_dict())

    logger.close()
    results = test_models(cfg, test_data, model_factory=model_factory,
                          loader=loader, verbose=verbose, device=dev)
    return results, cfg.checkpoint_dir


def test_models(cfg: Config, test_data, model_factory=None, loader=None,
                verbose=True, plot=True, device: str | torch.device = "cuda"):
    """Per-fold test evaluation of each `best_fold{k}` + pooled ROC
    (reference train_ResNet3D.py:335-446, test.py:107-209): binary tasks
    decide by prob > 0.5 (train_ResNet3D.py:388), multiclass by argmax.
    Returns {'avg', 'std', 'per_fold', 'pooled'}."""
    dev = resolve_device(device)
    loader_te = VolumeBatcher(test_data, batch_size=cfg.batch_size,
                              num_threads=cfg.loader_threads,
                              loader=loader or load_volume)

    all_metrics, all_probs, all_labels, fold_curves = [], [], [], []
    for fold in range(1, cfg.n_splits + 1):
        model = _make_model(cfg, model_factory, 0)
        weights, _ = ckpt.restore_state(
            os.path.join(cfg.checkpoint_dir, f"best_fold{fold}"))
        model.load_state_dict(weights)
        state = TrainState(model.to(dev), optimizer=None, schedule=None)

        probs_l, masks_l, labels_l = [], [], []
        for batch in _device_batches(loader_te, dev, cfg.normalizer,
                                     cfg.prefetch_depth):
            _, p = eval_step(state, batch)
            probs_l.append(p)
            masks_l.append(batch["mask"])
            labels_l.append(batch["label"])
        # one end-of-pass host fetch
        mask = torch.cat(masks_l).cpu().numpy() > 0
        prob_mat = torch.cat(probs_l).cpu().numpy()[mask]
        labels = torch.cat(labels_l).cpu().numpy()[mask].tolist()

        if prob_mat.shape[-1] > 2:
            probs = prob_mat.tolist()
            y_pred = prob_mat.argmax(-1)
            m = calculate_metrics_multiclass(labels, y_pred, prob_mat)
        else:
            probs = prob_mat[:, 1].tolist()
            y_pred = (np.array(probs) > 0.5).astype(int)
            m = calculate_metrics(labels, y_pred, probs)
        all_metrics.append(m)
        all_probs.extend(probs)
        all_labels.extend(labels)
        fold_curves.append((labels, probs))
        if verbose:
            print(f"\n=== Fold {fold} Test Metrics ===")
            for k in METRIC_KEYS:
                print(f"{k}: {m[k]:.4f}")
            print("Confusion Matrix:\n", m["cm"])

    avg = {k: float(np.mean([m[k] for m in all_metrics])) for k in METRIC_KEYS}
    std = {k: float(np.std([m[k] for m in all_metrics])) for k in METRIC_KEYS}
    if verbose:
        print("\n=== Final Test Results ===")
        for k in METRIC_KEYS:
            print(f"{k}: {avg[k]:.4f} ± {std[k]:.4f}")

    if plot and fold_curves and np.ndim(fold_curves[0][1][0]) == 0:
        # the pooled ROC is a binary-task artifact
        try:
            _plot_roc(fold_curves, all_labels, all_probs,
                      os.path.join(cfg.checkpoint_dir, "test_roc_curves.png"))
        except ImportError as e:  # matplotlib is optional
            if verbose:
                print(f"[warn] ROC plot skipped: {e}")

    return {"avg": avg, "std": std, "per_fold": all_metrics,
            "pooled": {"labels": all_labels, "probs": all_probs}}


def _plot_roc(fold_curves, all_labels, all_probs, out_path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from .metrics import binary_auc

    plt.figure(figsize=(10, 8))
    for i, (labels, probs) in enumerate(fold_curves, 1):
        fpr, tpr = roc_curve(labels, probs)
        plt.plot(fpr, tpr, lw=1, alpha=0.3,
                 label=f"Fold {i} (AUC={binary_auc(labels, probs):.2f})")
    fpr, tpr = roc_curve(all_labels, all_probs)
    mean_fpr = np.linspace(0, 1, 100)
    plt.plot(mean_fpr, np.interp(mean_fpr, fpr, tpr), "b-", lw=2,
             label=f"Mean ROC (AUC={binary_auc(all_labels, all_probs):.2f})")
    plt.plot([0, 1], [0, 1], "k--", lw=2)
    plt.xlim([0.0, 1.0])
    plt.ylim([0.0, 1.05])
    plt.xlabel("False Positive Rate")
    plt.ylabel("True Positive Rate")
    plt.title("Test ROC Curves")
    plt.legend(loc="lower right")
    plt.savefig(out_path, dpi=300, bbox_inches="tight")
    plt.close()
