#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (multimodal_ad_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit, nothing is caught):

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build K1 (csrc/fused_gather.cu) and K2 (csrc/roi_pool.cu) with nvcc
   for sm_90a, in parallel, timed;
3. K1 against its plain PyTorch version on the card: 32 full-size
   91x109x91 volumes in uint8, int16 (with negatives) and float32,
   repeated indices and one constant volume, f32 and bf16 output, int32
   and int64 indices; one call is one kernel (torch.profiler); then its
   time (CUDA events, L2 flushed and a device spin before each launch,
   median of 25) at the serving, resident and extraction shapes beside
   the bound, the plain version's time and an empty launch, with the
   exchange mode the kernel took (cluster or grid);
4. serving: 5 seeded full-width ResNet-18 fold checkpoints, 12 NIfTI
   volumes, `cli.predict --batch-size 8` (chunks 8 + 4) on the card; the
   bf16 ensemble against the fp32 one (TF32 off), and one fold's fp32
   logits on the card against the same on the host CPU; vols/s;
5. resident corpus: DeviceDataset(quantize="uint8") of 32 volumes,
   gather_normalized by index, 5-fold forward at batch 8 and 32; vols/s;
6. K2 against its plain PyTorch version computed in float64 on the card:
   (8, 91, 109, 91, 64) float32 and bfloat16 features over a 166-ROI
   synthetic atlas with AAL-like sparse ids, compacted, with background and
   one ROI emptied; (1, 182, 218, 182, 64) float32 over 600 ROIs (the 1-mm
   grid); rtol 1e-5, atol 1e-6, and two launches bit-identical, with the
   tile size T, the tile count and the path (bulk or SIMT) of each; then
   its time (as K1's) beside its bound, the plain version's and the
   `index_add_` library call's;
7. ROI extraction: a 50-subject dataset at 91x109x91, the atlas as NIfTI +
   JSON LUT, `cli.extract_features` on the card at full width (UNet3D
   64/128/256/512, float32, batch 8; the seed-42 test split is 10 subjects,
   batches 8 + 2): K1 and K2 launched, CSV shapes, finite values, a second
   run byte-identical; a narrow U-Net on the card against the host CPU on a
   full-size volume (ROI means within rtol = atol = 1e-3); subjects/s, the
   time split of a batch (upload, K1, forward, K2, copy back, CSV write),
   K2 on the U-Net's tap and K1 at its shape with the spun timer, the
   path K2 took on the tap, the cost of deterministic cuDNN, peak memory,
   and a profile;
8. training: a 40-subject dataset at 91x109x91; 8 steps of a fresh
   ResNet-18 (bf16 autocast) on one fixed batch, whose weighted CE must
   fall, the first step timed (cuDNN autotune of the backward
   convolutions); then `cli.train_resnet3d` on the card at full width
   (ResNet-18 B, batch 8, hbm_cache + augment + precise_bn,
   scale_intensity, 2 folds x 2 epochs, lr 1e-3): K1 launched on every
   batch, finite losses, the 19-column CSV, the checkpoints, finite test
   metrics; the trained best_fold{k} served by EnsemblePredictor against
   the test run's fold-mean probabilities; training vols/s (resident,
   augmented, B = 8, median of 14 steps after 2 of warm-up, CUDA events),
   the time split of a step (K1, augmentation, forward + backward,
   optimizer), peak memory and a profile of two steps; three fp32 steps of
   a ResNet-10 at 32x38x32, card against host CPU, the card starting each
   step from the host's state (losses and BN statistics rtol = atol =
   1e-3; parameters within 2 lr, 99.9 % of them within 1e-3: Adam can step
   either way where a gradient is near zero);
9. one JSON line {"kernels": [...]} and, last, the device line.

It exits non-zero without printing a result when no CUDA device is
present, or when the port's package is not beside it.
"""

from __future__ import annotations

import csv
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
VOL_SHAPE = (91, 109, 91)
VOX = VOL_SHAPE[0] * VOL_SHAPE[1] * VOL_SHAPE[2]
N_FOLDS = 5
N_SERVE = 12
N_CORPUS = 32
BATCH = 8
# H100 SXM data sheet: HBM rate, float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
K1_OPS_PER_VOXEL = 4  # min, max, subtract, multiply
K1_REPLACES = "multimodal_ad_tpu/ops/fused_gather.py:63"
K1_SOURCE = "multimodal_ad_tpu_torch/csrc/fused_gather.cu"
K2_REPLACES = "multimodal_ad_tpu/ops/roi_pool.py:94"
K2_SOURCE = "multimodal_ad_tpu_torch/csrc/roi_pool.cu"
N_ROIS = 166  # the 2-mm AAL grid
N_ROIS_1MM = 600
SHAPE_1MM = (182, 218, 182)
ROI_CH = 64  # the U-Net's pre-head width
N_SUBJECTS = 50  # seed-42 test split of 0.2: 10 subjects, batches 8 + 2
N_TRAIN = 40  # seed-42 test split: 8 subjects; 2 folds of 16 train / 16 val
TRAIN_EPOCHS = 2


def log(msg=""):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def k1_bound_ms(batch, src_bytes, out_bytes, idx_bytes):
    """Least time for K1's work: each gathered voxel read once, each output
    written once, the indices read once; or its ~4 operations per voxel at
    the float32 rate, whichever is larger."""
    moved = batch * VOX * (src_bytes + out_bytes) + batch * idx_bytes
    ops = batch * VOX * K1_OPS_PER_VOXEL
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k2_bound_ms(atlas, batch, channels, elem_bytes):
    """Least time for K2's work: the labelled voxels' features read once
    (background is never read), the voxel order and segment offsets read
    once, the output written once. One add per element read is far below
    the float32 rate, so bytes bound it."""
    m = atlas.order.numel()
    moved = (batch * m * channels * elem_bytes + 4 * (m + atlas.num_rois + 1)
             + 4 * batch * atlas.num_rois * channels)
    return 1e3 * moved / HBM_BYTES_PER_S, "bytes"


def time_cuda(torch, fn, reps=25, flush=None):
    """Median ms of `fn()` over `reps` launches, each between its own CUDA
    events, with the L2 flushed (a 128 MB write) before each launch. A
    ~0.5 ms device-side spin after the flush keeps the card behind the
    host, so the events bracket device work only and not the wrapper's
    host-side launch cost."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(1_000_000)  # clock cycles
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def sparse_aal_ids(n):
    """n ROI ids that skip some, as AAL3's do (35, 36, 81, 82)."""
    ids, i = [], 1
    while len(ids) < n:
        if i not in (35, 36, 81, 82):
            ids.append(i)
        i += 1
    return np.asarray(ids)


def nearest_centre_labels(torch, dev, shape, n_rois, seed):
    """make_atlas's rule (nearest of n_rois random centres, background
    outside a sphere) computed on the card slab by slab: the 1-mm grid with
    600 ROIs would take minutes in numpy."""
    rng = np.random.default_rng(seed)
    centres = torch.tensor(rng.uniform(0.15, 0.85, (n_rois, 3)),
                           dtype=torch.float32, device=dev)
    axes = [torch.linspace(0, 1, s, device=dev) for s in shape]
    gy, gz = torch.meshgrid(axes[1], axes[2], indexing="ij")
    labels = torch.empty(shape, dtype=torch.int32, device=dev)
    for i in range(shape[0]):
        pts = torch.stack([axes[0][i].expand_as(gy), gy, gz], -1).reshape(-1, 3)
        lab = torch.cdist(pts, centres).argmin(1).to(torch.int32) + 1
        lab[(pts - 0.5).norm(dim=1) > 0.55] = 0
        labels[i] = lab.reshape(gy.shape)
    return labels


def bf16_ulps(torch, a, b):
    """Largest distance in bf16 steps between two non-negative bf16 tensors."""
    ia = a.view(torch.int16).to(torch.int32)
    ib = b.view(torch.int16).to(torch.int32)
    return int((ia - ib).abs().max())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "multimodal_ad_tpu_torch")):
        print("chip_smoke: the multimodal_ad_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)

    from multimodal_ad_tpu_torch.cli import extract_features as cli_extract
    from multimodal_ad_tpu_torch.cli import predict as cli_predict
    from multimodal_ad_tpu_torch.cli import train_resnet3d as cli_train
    from multimodal_ad_tpu_torch.core.config import Config
    from multimodal_ad_tpu_torch.core.device import resolve_device
    from multimodal_ad_tpu_torch.data.adni import ADNIManifest
    from multimodal_ad_tpu_torch.data.device_cache import (DeviceDataset,
                                                           DeviceEpochIterator)
    from multimodal_ad_tpu_torch.data.pipeline import load_volume
    from multimodal_ad_tpu_torch.data.splits import stratified_test_split
    from multimodal_ad_tpu_torch.data.synthetic import (make_adni_dir, make_atlas,
                                                        make_volume)
    from multimodal_ad_tpu_torch.eval.atlas import compact_labels, load_atlas
    from multimodal_ad_tpu_torch.eval.features import deterministic_cudnn
    from multimodal_ad_tpu_torch.models.resnet3d import generate_model
    from multimodal_ad_tpu_torch.models.unet3d import UNet3D
    from multimodal_ad_tpu_torch.ops import _build
    from multimodal_ad_tpu_torch.ops import fused_gather as fg
    from multimodal_ad_tpu_torch.ops import roi_pool as rp
    from multimodal_ad_tpu_torch.ops.augment import augment_batch
    from multimodal_ad_tpu_torch.ops.normalize import scale_intensity
    from multimodal_ad_tpu_torch.serve import EnsemblePredictor
    from multimodal_ad_tpu_torch.train import checkpoint as ckpt
    from multimodal_ad_tpu_torch.train import loop
    from multimodal_ad_tpu_torch.utils import nifti

    t_start = time.time()
    dev = resolve_device("cuda")  # TF32 off, cudnn.benchmark on

    # ---- 1. the card ---------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log("== 1. card")
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {kind}, count {torch.cuda.device_count()}")

    # ---- 2. build K1 ---------------------------------------------------
    log("== 2. build")
    t0 = time.time()
    _build.build(["fused_gather", "roi_pool"])  # one nvcc each, in parallel
    fg._lib()
    rp._lib()
    log(f"K1 and K2 built and loaded in {time.time() - t0:.2f} s "
        f"({_build.library_path('fused_gather').name}, "
        f"{_build.library_path('roi_pool').name})")
    log(_build.build_log("fused_gather").strip())
    log(_build.build_log("roi_pool").strip())

    # ---- 3. K1 against its plain version --------------------------------
    log("== 3. K1 vs plain, 32 volumes of 91x109x91")
    g = torch.Generator(device=dev).manual_seed(SEED)
    shape = (N_CORPUS, *VOL_SHAPE, 1)
    sources = {
        torch.uint8: torch.randint(0, 256, shape, generator=g, device=dev,
                                   dtype=torch.uint8),
        torch.int16: torch.randint(-1000, 4000, shape, generator=g, device=dev,
                                   dtype=torch.int16),
        torch.float32: torch.randn(shape, generator=g, device=dev) * 100 + 20,
    }
    for s in sources.values():
        s[5] = 7  # one constant volume: maps to 0
    idx8 = [0, 5, 7, 7, 31, 12, 5, 3]  # repeats and the constant volume
    idx32 = torch.randint(0, N_CORPUS, (32,), generator=g, device=dev).tolist()
    max_err = 0.0
    for sdt, src in sources.items():
        for odt in (torch.float32, torch.bfloat16):
            for idx_list, idt in ((idx8, torch.int32), (idx32, torch.int64)):
                idx = torch.tensor(idx_list, dtype=idt, device=dev)
                out = fg.gather_normalize(src, idx, odt)
                ref = fg.gather_normalize_plain(src, idx, odt)
                torch.cuda.synchronize()
                err = float((out.float() - ref.float()).abs().max())
                max_err = max(max_err, err)
                zero_rows = [i for i, v in enumerate(idx_list) if v == 5]
                check(bool((out[zero_rows] == 0).all()),
                      f"constant volume not zeroed ({sdt}->{odt})")
                if odt == torch.float32:
                    check(err <= 1e-6, f"K1 f32 error {err} ({sdt}, B={len(idx_list)})")
                    log(f"  {str(sdt):14s} -> float32  B={len(idx_list):2d} "
                        f"{str(idt):11s} max |err| {err:.3g} (tolerance 1e-6)")
                else:
                    ulps = bf16_ulps(torch, out, ref)
                    check(ulps <= 1, f"K1 bf16 off by {ulps} ulp ({sdt})")
                    log(f"  {str(sdt):14s} -> bfloat16 B={len(idx_list):2d} "
                        f"{str(idt):11s} max |err| {err:.3g} ({ulps} bf16 ulp; "
                        "tolerance 1 ulp)")

    log(f"K1 launches in this check: {fg.gather_normalize.launches}")
    serve_src = sources[torch.float32][:BATCH].contiguous()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fg.gather_normalize(serve_src, torch.arange(BATCH, device=dev), torch.bfloat16)
        torch.cuda.synchronize()
    k1_kernels = sum(e.count for e in prof.key_averages() if "gather_normalize" in e.key)
    log(f"K1 kernels on the card for one call (torch.profiler): {k1_kernels}")
    check(k1_kernels == 1, f"one K1 call ran {k1_kernels} kernels")
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.int32, device=dev)
    timings, k1_modes = {}, {}
    log("K1 device times (L2 flushed and a device spin before each launch, "
        "median of 25):")
    # serving shape: a float32 chunk of 8 volumes -> bf16 batch; resident
    # shapes: the uint8 corpus -> bf16 batch of 8 and 32; extraction shape:
    # scale_intensity of a float32 batch of 8
    cases = [("serving f32->bf16 B=8", serve_src,
              torch.arange(BATCH, device=dev), torch.bfloat16),
             ("resident u8->bf16 B=8", sources[torch.uint8],
              torch.tensor(idx8, device=dev), torch.bfloat16),
             ("resident u8->bf16 B=32", sources[torch.uint8],
              torch.tensor(idx32, device=dev), torch.bfloat16),
             ("extraction f32->f32 B=8", serve_src,
              torch.arange(BATCH, device=dev), torch.float32)]
    for name, src, idx, odt in cases:
        ms = time_cuda(torch, lambda: fg.gather_normalize(src, idx, odt), flush=flush)
        plain_ms = time_cuda(
            torch, lambda: fg.gather_normalize_plain(src, idx, odt), flush=flush)
        bound, bound_by = k1_bound_ms(idx.numel(), src.element_size(),
                                      torch.empty((), dtype=odt).element_size(),
                                      idx.element_size())
        timings[name] = (ms, plain_ms, bound, bound_by)
        k1_modes[name] = fg.gather_normalize.mode
        log(f"  {name:24s} kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
            f"bound {bound:.4f} ms ({bound_by})  -> {bound / ms:.1%} of bound; "
            f"{fg.gather_normalize.mode} mode, {fg.gather_normalize.blocks_per_volume} "
            f"blocks a volume, {fg.gather_normalize.smem_bytes} B of shared memory each")
    empty_ms = time_cuda(torch, lambda: torch.cuda._sleep(0), flush=flush)
    log(f"  an empty launch (torch.cuda._sleep(0)) {empty_ms:.4f} ms")
    log("  library call: none (no single PyTorch call gathers and min-max "
        "normalizes per volume)")
    del sources, flush

    # ---- 4. serving ----------------------------------------------------
    log("== 4. serving: 5-fold ResNet-18, 12 NIfTI volumes, cli.predict")
    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    rng = np.random.default_rng(SEED)
    vol_paths = []
    for i in range(N_SERVE):
        v = make_volume(rng, VOL_SHAPE, label=i % 2, extent_jitter=0.3,
                        center_jitter=0.05)
        vol_paths.append(os.path.join(work, f"subject_{i:02d}.nii"))
        nifti.save(vol_paths[-1], v)

    cfg = Config(model_depth=18, batch_size=BATCH, compute_dtype="bfloat16",
                 input_W=VOL_SHAPE[0], input_H=VOL_SHAPE[1],
                 input_D=VOL_SHAPE[2])
    ckpt_dir = os.path.join(work, "ckpt")
    calib = fg.gather_normalize(
        torch.from_numpy(np.stack([load_volume(p) for p in vol_paths[:4]])
                         [..., None]).to(dev),
        torch.arange(4, device=dev))
    t0 = time.time()
    for k in range(1, N_FOLDS + 1):
        # Random weights from a seed. BN statistics are set from two
        # calibration volumes (a train-mode pass with a cumulative average),
        # then BN scale/bias are perturbed per fold, so the logits neither
        # explode nor saturate the softmax.
        torch.manual_seed(SEED + k)
        model = generate_model(model_depth=18, compute_dtype=torch.float32).to(dev)
        gk = torch.Generator(device=dev).manual_seed(SEED + 100 + k)
        bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm3d)]
        for bn in bns:
            bn.reset_running_stats()
            bn.momentum = None
        model.train()
        with torch.no_grad():
            model(calib[[(k - 1) % 4, k % 4]])
            for bn in bns:
                bn.momentum = 0.1
                bn.weight.mul_(0.75 + 0.5 * torch.rand(bn.weight.shape, generator=gk, device=dev))
                bn.bias.add_(0.1 * torch.randn(bn.bias.shape, generator=gk, device=dev))
        ckpt.save_checkpoint(os.path.join(ckpt_dir, f"best_fold{k}"),
                             model.state_dict(), config=cfg.to_dict())
    del model, calib
    log(f"wrote {N_FOLDS} fold checkpoints + {N_SERVE} volumes in "
        f"{time.time() - t0:.1f} s")

    out_csv = os.path.join(work, "pred.csv")
    fg.gather_normalize.launches = 0
    t0 = time.time()
    cli_predict.main(["--ckpt-dir", ckpt_dir, "--volumes", *vol_paths,
                      "--batch-size", str(BATCH), "--out", out_csv])
    torch.cuda.synchronize()
    t_cli = time.time() - t0
    serve_launches = fg.gather_normalize.launches
    log(f"cli.predict (first call: checkpoint load, NIfTI decode, cuDNN "
        f"autotune) {t_cli:.2f} s; K1 launches {serve_launches}")
    check(serve_launches >= 2, f"serving ran K1 {serve_launches} times, "
          "expected one launch per chunk (8 + 4)")
    with open(out_csv) as f:
        rows = list(csv.reader(f))
    check(rows[0] == ["Subject_ID", "pred", "prob_0", "prob_1"], f"CSV header {rows[0]}")
    check(len(rows) == 1 + N_SERVE, f"CSV has {len(rows) - 1} predictions")
    csv_proba = np.array([[float(r[2]), float(r[3])] for r in rows[1:]])
    check(bool(np.isfinite(csv_proba).all()), "non-finite probabilities")
    check(bool(np.allclose(csv_proba.sum(1), 1.0, atol=1e-5)),
          f"probabilities do not sum to 1: {csv_proba.sum(1)}")
    log(f"  prob_1 per subject: {np.round(csv_proba[:, 1], 4).tolist()}")

    vols = np.stack([load_volume(p) for p in vol_paths])
    pred16 = EnsemblePredictor.from_checkpoint_dir(ckpt_dir, batch_size=BATCH)
    pred32 = EnsemblePredictor.from_checkpoint_dir(
        ckpt_dir, cfg=cfg.replace(compute_dtype="float32"), batch_size=BATCH)
    p16 = pred16.predict_proba(vols)
    p32 = pred32.predict_proba(vols)
    d = float(np.abs(p16 - p32).max())
    log(f"bf16 vs fp32 ensemble (TF32 off): max |dprob| {d:.3g}, "
        f"argmax agreement {(p16.argmax(1) == p32.argmax(1)).mean():.3f}")
    # bf16 keeps 8 significant bits; over 18 layers the logits move by
    # about 1e-2 relative, and a probability by at most 1/4 of a logit move
    check(d <= 0.05, f"bf16 ensemble differs from fp32 by {d}")

    fold = generate_model(model_depth=18, compute_dtype=torch.float32)
    fold.load_state_dict(ckpt.restore_state(os.path.join(ckpt_dir, "best_fold1"))[0])
    fold.eval()
    x2 = fg.gather_normalize(torch.from_numpy(vols[:2, ..., None]).to(dev),
                             torch.arange(2, device=dev))
    with torch.no_grad():
        card_logits = fold.to(dev)(x2).cpu().numpy()
        host_logits = fold.cpu()(x2.cpu()).numpy()
    d = float(np.abs(card_logits - host_logits).max())
    log(f"fold 1 fp32 logits, card vs host CPU: max |d| {d:.3g} "
        f"(card {card_logits.ravel().round(4).tolist()})")
    check(np.allclose(card_logits, host_logits, rtol=2e-3, atol=2e-3),
          f"card and host fp32 logits differ by {d}")
    del fold, x2

    serve_rates = {}
    for name, pred in (("bf16", pred16), ("fp32", pred32)):
        reps = []
        for _ in range(3):
            t0 = time.time()
            pred.predict_proba(vols)  # ends in a device->host copy
            reps.append(time.time() - t0)
        serve_rates[name] = N_SERVE / statistics.median(reps)
        log(f"serving {name}: {serve_rates[name]:.2f} vols/s "
            f"(predict_proba on {N_SERVE} host volumes, chunks 8 + 4, "
            f"{N_FOLDS} folds, median of 3) on {card}")
    del pred32

    # ---- 5. resident corpus -------------------------------------------
    log("== 5. resident corpus: DeviceDataset(quantize='uint8'), 32 volumes")
    corpus = np.stack([make_volume(rng, VOL_SHAPE, label=i % 2,
                                   extent_jitter=0.3, center_jitter=0.05)
                       for i in range(N_CORPUS)])[..., None]
    t0 = time.time()
    ds = DeviceDataset(corpus, np.arange(N_CORPUS) % 2, quantize="uint8")
    torch.cuda.synchronize()
    log(f"quantize + upload {ds.volumes.nbytes / 1e6:.1f} MB in {time.time() - t0:.2f} s")
    del corpus
    resident_rates = {}
    fg.gather_normalize.launches = 0
    for b in (8, 32):
        plan = [np.asarray(rng.integers(0, N_CORPUS, b), np.int64) for _ in range(4)]
        probs = pred16.forward(ds.gather_normalized(plan[0], torch.bfloat16)["image"])
        torch.cuda.synchronize()  # warm-up: cuDNN autotune for this batch
        t0 = time.time()
        n_iter = 6
        for i in range(n_iter):
            probs = pred16.forward(
                ds.gather_normalized(plan[i % 4], torch.bfloat16)["image"])
        torch.cuda.synchronize()
        resident_rates[b] = n_iter * b / (time.time() - t0)
        p = probs.cpu().numpy()
        check(p.shape == (b, 2) and bool(np.isfinite(p).all())
              and bool(np.allclose(p.sum(1), 1.0, atol=1e-5)),
              f"resident batch {b}: bad probabilities")
        log(f"resident batch {b}: {resident_rates[b]:.2f} vols/s "
            f"(gather + K1 + {N_FOLDS}-fold forward, {n_iter} batches) on {card}")
    resident_launches = fg.gather_normalize.launches
    log(f"K1 launches on the resident path: {resident_launches}")
    check(resident_launches > 0, "resident path never launched K1")

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(2):
            pred16.forward(ds.gather_normalized(plan[i], torch.bfloat16)["image"])
        torch.cuda.synchronize()
    log("profile of 2 resident batches of 32 (device time by kernel):")
    log(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=12,
                                  max_name_column_width=60))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    log(f"clocks/power after the runs: {smi.stdout.strip()}")
    del pred16, ds

    # ---- 6. K2 against its plain version --------------------------------
    log("== 6. K2 vs plain (float64), 166 ROIs on 91x109x91, 600 on 182x218x182")
    t0 = time.time()
    ids = sparse_aal_ids(N_ROIS)  # AAL-like sparse ids, written as the atlas
    atlas_vol = make_atlas(VOL_SHAPE, n_rois=N_ROIS, seed=SEED)
    atlas_vol = np.concatenate([[0], ids])[atlas_vol].astype(np.int16)
    atlas_nii = os.path.join(work, "atlas.nii")
    nifti.save(atlas_nii, atlas_vol)
    atlas_lut = os.path.join(work, "atlas.json")
    with open(atlas_lut, "w") as f:  # one id left out: it is named ROI{id}
        json.dump({"rois": {str(i): {"label": f"R{i:03d}_L"} for i in ids[1:]}}, f)
    labels, roi_ids, roi_names, _ = load_atlas(atlas_nii, atlas_lut)
    labels = compact_labels(labels, roi_ids)
    check(len(roi_ids) == N_ROIS and int(labels.max()) == N_ROIS,
          f"atlas has {len(roi_ids)} ROIs")
    log(f"atlas: {N_ROIS} ROIs (ids {ids[0]}..{ids[-1]}), "
        f"{(labels > 0).mean():.1%} of voxels labelled; made in {time.time() - t0:.1f} s")

    k2_labels = labels.copy()
    k2_labels[k2_labels == 100] = 0  # ROI 100 without voxels
    atlas = rp.RoiAtlas.build(k2_labels, N_ROIS, dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    feats = torch.randn((BATCH, *VOL_SHAPE, ROI_CH), generator=g, device=dev)
    labels_1mm = nearest_centre_labels(torch, dev, SHAPE_1MM, N_ROIS_1MM, SEED)
    atlas_1mm = rp.RoiAtlas.build(labels_1mm, N_ROIS_1MM, dev)
    feats_1mm = torch.randn((1, *SHAPE_1MM, ROI_CH), generator=g, device=dev)
    k2_err = 0.0
    for name, f, a, r in (("f32 B=8 2-mm", feats, atlas, N_ROIS),
                          ("bf16 B=8 2-mm", feats.to(torch.bfloat16), atlas, N_ROIS),
                          ("f32 B=1 1-mm", feats_1mm, atlas_1mm, N_ROIS_1MM)):
        out = rp.roi_pool(f, a, r)
        out2 = rp.roi_pool(f, a, r)
        ref = rp.roi_pool_plain(f.double(), a, r)
        torch.cuda.synchronize()
        err = float((out.double() - ref).abs().max())
        k2_err = max(k2_err, err)
        check(torch.allclose(out.double(), ref, rtol=1e-5, atol=1e-6),
              f"K2 {name} differs from plain by {err}")
        check(torch.equal(out, out2), f"K2 {name}: two launches differ")
        if r == N_ROIS:
            check(bool((out[:, 99] == 0).all()), "the empty ROI 100 is not 0")
        log(f"  {name:14s} max |err| {err:.3g} vs float64 plain (rtol 1e-5, "
            f"atol 1e-6); two launches bit-identical; T {a.tile_size}, "
            f"{a.num_tiles} tiles, {a.runs.shape[0]} runs, {rp.k2_path(f, a)} path")
        del ref
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.int32, device=dev)
    lab_long = atlas.labels.to(torch.long)
    flat = feats.reshape(BATCH, -1, ROI_CH)
    clamped = atlas.counts.clamp(min=1e-6)[None, :, None]

    def library_call():
        sums = torch.zeros((BATCH, N_ROIS + 1, ROI_CH), device=dev)
        return sums.index_add_(1, lab_long, flat)[:, 1:] / clamped

    torch.cuda.synchronize()
    err = float((library_call() - rp.roi_pool(feats, atlas, N_ROIS)).abs().max())
    log(f"  index_add_ library call vs K2: max |d| {err:.3g}")
    k2_ms = time_cuda(torch, lambda: rp.roi_pool(feats, atlas, N_ROIS), flush=flush)
    k2_plain_ms = time_cuda(torch, lambda: rp.roi_pool_plain(feats, atlas, N_ROIS),
                            reps=20, flush=flush)
    k2_lib_ms = time_cuda(torch, library_call, flush=flush)
    k2_bound, k2_bound_by = k2_bound_ms(atlas, BATCH, ROI_CH, 4)
    k2_1mm_ms = time_cuda(torch, lambda: rp.roi_pool(feats_1mm, atlas_1mm, N_ROIS_1MM),
                          flush=flush)
    k2_1mm_bound, _ = k2_bound_ms(atlas_1mm, 1, ROI_CH, 4)
    log("K2 device times (L2 flushed before each launch, median of 25; plain 20):")
    log(f"  f32 B=8 2-mm, 166 ROIs  kernel {k2_ms:.4f} ms  plain {k2_plain_ms:.4f} ms  "
        f"index_add_ {k2_lib_ms:.4f} ms  bound {k2_bound:.4f} ms ({k2_bound_by}, "
        f"{atlas.order.numel()} labelled voxels) -> {k2_bound / k2_ms:.1%} of bound")
    log(f"  f32 B=1 1-mm, 600 ROIs  kernel {k2_1mm_ms:.4f} ms  bound "
        f"{k2_1mm_bound:.4f} ms -> {k2_1mm_bound / k2_1mm_ms:.1%} of bound")
    del feats, feats_1mm, flat, atlas_1mm, labels_1mm, flush

    # ---- 7. ROI extraction -------------------------------------------------
    log("== 7. ROI extraction: cli.extract_features, full-width UNet3D, float32")
    t0 = time.time()
    label_csv, mri_dir = make_adni_dir(
        os.path.join(work, "adni"), n_per_class=N_SUBJECTS // 2,
        classes=("AD", "CN"), shape=VOL_SHAPE, seed=SEED, extent_jitter=0.3,
        center_jitter=0.05)
    log(f"wrote {N_SUBJECTS} subjects in {time.time() - t0:.1f} s")
    argv = ["--atlas", atlas_nii, "--atlas-json", atlas_lut,
            f"label_file={label_csv}", f"mri_dir={mri_dir}", f"batch_size={BATCH}"]
    fg.gather_normalize.launches = 0
    rp.roi_pool.launches = 0
    rp.roi_pool.path_launches = dict.fromkeys(rp.PATHS, 0)
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for run in (1, 2):
        t0 = time.time()
        feat_csv, roi_csv = cli_extract.main(argv + ["--out", os.path.join(work, f"out{run}")])
        walls.append(time.time() - t0)
        if run == 1:
            ext_k1 = fg.gather_normalize.launches
            ext_k2 = rp.roi_pool.launches
            ext_k2_paths = dict(rp.roi_pool.path_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"extraction K1 launches {ext_k1}, K2 launches {ext_k2} (first run; K2 by "
        f"path {ext_k2_paths})")
    check(ext_k1 > 0 and ext_k2 > 0, "the extraction path did not launch K1 and K2")
    n_test = len(stratified_test_split(
        ADNIManifest(label_csv, mri_dir, verbose=False).data_dict, 0.2, 42)[1])
    with open(feat_csv) as f:
        frows = list(csv.reader(f))
    with open(roi_csv) as f:
        rrows = list(csv.reader(f))
    check(len(frows) == 1 + n_test and all(len(r) == 1 + VOX for r in frows),
          f"features.csv is {len(frows)} rows of {len(frows[0])} columns")
    check(len(rrows) == 1 + n_test and all(len(r) == 1 + N_ROIS * ROI_CH for r in rrows),
          f"roi_features.csv is {len(rrows)} rows of {len(rrows[0])} columns")
    check(rrows[0][1] == f"ROI{ids[0]}_c0" and rrows[0][1 + ROI_CH] == f"R{ids[1]:03d}_L_c0",
          f"roi header {rrows[0][:3]}")
    roi_vals = np.asarray([r[1:] for r in rrows[1:]], np.float64)
    vox_vals = np.asarray([r[1:] for r in frows[1:]], np.float64)
    check(bool(np.isfinite(roi_vals).all() and np.isfinite(vox_vals).all()),
          "non-finite features")
    with open(roi_csv, "rb") as a, open(os.path.join(work, "out1", "roi_features.csv"), "rb") as b:
        same = a.read() == b.read()
    check(same, "two extraction runs wrote different roi_features.csv bytes")
    rate = n_test / walls[1]
    log(f"features.csv {len(frows) - 1} x {len(frows[0])}, roi_features.csv "
        f"{len(rrows) - 1} x {len(rrows[0])}, finite; ROI means in "
        f"[{roi_vals.min():.4g}, {roi_vals.max():.4g}]; second run byte-identical")
    log(f"extraction: {rate:.3f} subjects/s ({n_test} subjects, second run "
        f"{walls[1]:.2f} s; first {walls[0]:.2f} s) on {card}; peak memory "
        f"{peak_gb:.2f} GB")

    # the card against the host CPU: a narrow U-Net on one full-size volume
    host = torch.from_numpy(np.stack([
        load_volume(os.path.join(mri_dir, f"CN_{i:03d}.nii")) for i in range(BATCH)])[..., None])
    narrow = UNet3D(level_channels=(8, 16, 32), bottleneck_channel=64,
                    generator=torch.Generator().manual_seed(SEED)).eval()
    host_atlas = rp.RoiAtlas.build(labels, N_ROIS)
    with torch.inference_mode():
        h_out, h_feats = narrow(scale_intensity(host[:1]), return_features=True)
        h_roi = rp.roi_pool(h_feats, host_atlas, N_ROIS)
        with deterministic_cudnn():
            c_out, c_feats = narrow.to(dev)(scale_intensity(host[:1].to(dev)),
                                            return_features=True)
        c_roi = rp.roi_pool(c_feats, rp.RoiAtlas.build(labels, N_ROIS, dev), N_ROIS)
    d_roi = float((c_roi.cpu() - h_roi).abs().max())
    d_out = float((c_out.cpu() - h_out).abs().max())
    log(f"narrow U-Net, card vs host CPU (fp32, TF32 off): ROI means max |d| "
        f"{d_roi:.3g}, output map max |d| {d_out:.3g}")
    check(torch.allclose(c_roi.cpu(), h_roi, rtol=1e-3, atol=1e-3),
          f"card and host ROI means differ by {d_roi}")
    del narrow, c_out, c_feats

    # time split of one full batch of 8, stage by stage (synchronized)
    model = UNet3D(generator=torch.Generator().manual_seed(42)).eval().to(dev)
    ext_atlas = rp.RoiAtlas.build(labels, N_ROIS, dev)

    def timed(fn, reps=3):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times), out

    split = {}
    t0 = time.time()
    pinned = host.pin_memory()
    split["pin_host_ms"] = 1e3 * (time.time() - t0)
    split["upload_ms"], raw = timed(lambda: pinned.to(dev, non_blocking=True))
    split["k1_ms"], x = timed(lambda: scale_intensity(raw))
    with torch.inference_mode(), deterministic_cudnn():
        split["forward_ms"], (out, tap) = timed(lambda: model(x, return_features=True))
        torch.backends.cudnn.deterministic = False
        fwd_free_ms, _ = timed(lambda: model(x, return_features=True))
        torch.backends.cudnn.deterministic = True
        split["k2_ms"], roi = timed(lambda: rp.roi_pool(tap, ext_atlas, N_ROIS), reps=25)
        split["copy_back_ms"], (flat_h, roi_h) = timed(
            lambda: (out.reshape(BATCH, -1).cpu().numpy(), roi.cpu().numpy()))
    t0 = time.time()
    with open(os.path.join(work, "split.csv"), "w", newline="") as f:
        w = csv.writer(f)
        rows = roi_h.reshape(BATCH, -1)
        for i in range(BATCH):
            w.writerow([f"S{i}"] + flat_h[i].tolist())
            w.writerow([f"S{i}"] + rows[i].tolist())
    split["csv_write_ms"] = 1e3 * (time.time() - t0)
    log(f"time split of one batch of {BATCH} (ms; CUDA events, median of 3; "
        f"K2 of 25): " + ", ".join(f"{k} {v:.2f}" for k, v in split.items()))
    log(f"  deterministic cuDNN: forward {split['forward_ms']:.1f} ms against "
        f"{fwd_free_ms:.1f} ms with cuDNN free to choose (heuristics, no benchmark)")
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.int32, device=dev)
    tap_path = rp.k2_path(tap, ext_atlas)
    k2_tap_ms = time_cuda(torch, lambda: rp.roi_pool(tap, ext_atlas, N_ROIS), flush=flush)
    k2_tap_bound, _ = k2_bound_ms(ext_atlas, BATCH, ROI_CH, 4)
    k1_ext_ms = time_cuda(torch, lambda: scale_intensity(raw), flush=flush)
    k1_ext_bound, _ = k1_bound_ms(BATCH, 4, 4, 8)
    del flush
    log(f"  tap strides {tuple(tap.stride())} (channels-last, cropped from the "
        f"padded 96x112x96 map): K2 took the {tap_path} path, "
        f"{split['k2_ms']:.4f} ms (events, median of 25), {k2_tap_ms:.4f} ms with "
        f"the spun timer (L2 flushed, device spin) against its bound "
        f"{k2_tap_bound:.4f} ms -> {k2_tap_bound / k2_tap_ms:.1%}")
    log(f"  K1 at the extraction shape (scale_intensity, f32 -> f32, B=8) "
        f"{k1_ext_ms:.4f} ms with the spun timer against its bound "
        f"{k1_ext_bound:.4f} ms -> {k1_ext_bound / k1_ext_ms:.1%}; "
        f"{fg.gather_normalize.mode} mode")
    with torch.inference_mode(), deterministic_cudnn(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        o, t = model(scale_intensity(raw), return_features=True)
        rp.roi_pool(t, ext_atlas, N_ROIS).cpu()
        torch.cuda.synchronize()
    log("profile of one extraction batch of 8 (K1 + forward + K2, device time by kernel):")
    log(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=12,
                                  max_name_column_width=60))
    del model, raw, x, out, tap, o, t

    # ---- 8. training ----------------------------------------------------
    log("== 8. training: ResNet-18 B, bf16 autocast, 91x109x91, batch 8")
    t0 = time.time()
    train_csv, train_mri = make_adni_dir(
        os.path.join(work, "train"), n_per_class=N_TRAIN // 2, classes=("AD", "CN"),
        shape=VOL_SHAPE, seed=SEED + 7, extent_jitter=0.3, center_jitter=0.04,
        noise=0.25)
    records = ADNIManifest(train_csv, train_mri, verbose=False).data_dict
    tr_val, test_recs = stratified_test_split(records, 0.2, 42)
    log(f"wrote {N_TRAIN} subjects in {time.time() - t0:.1f} s ({len(tr_val)} train/val, "
        f"{len(test_recs)} test)")
    train_ds = DeviceDataset(np.stack([load_volume(r["MRI"]) for r in tr_val])[..., None],
                             np.array([r["label"] for r in tr_val]), store_dtype=np.float32)
    cw = torch.tensor([0.5, 0.5], device=dev)

    def fresh_state(seed, epochs=20):
        m = generate_model(model_depth=18, compute_dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(seed)).to(dev)
        return loop.create_train_state(m, loop.make_epoch_schedule(1e-3, epochs),
                                       dropout_seed=seed)

    # one fixed batch, no augmentation: the weighted CE must fall; the first
    # step carries cuDNN's autotune of the backward convolutions (serving
    # tuned the bf16 forward at this shape in phase 4)
    fixed = next(iter(DeviceEpochIterator(train_ds, np.arange(BATCH), BATCH)))
    state = fresh_state(SEED + 11)
    fixed_losses, fixed_walls = [], []
    for _ in range(8):
        torch.cuda.synchronize()
        t0 = time.time()
        loss, _ = loop.train_step(state, fixed, cw)
        fixed_losses.append(float(loss))  # syncs
        fixed_walls.append(time.time() - t0)
    autotune_s = fixed_walls[0] - statistics.median(fixed_walls[2:])
    log(f"fixed batch, 8 steps: weighted CE {[round(v, 4) for v in fixed_losses]}")
    log(f"first train step {fixed_walls[0]:.2f} s against {statistics.median(fixed_walls[2:]) * 1e3:.1f} "
        f"ms later: cuDNN autotune about {autotune_s:.2f} s")
    check(all(np.isfinite(fixed_losses)), "non-finite loss on the fixed batch")
    check(fixed_losses[-1] < fixed_losses[0],
          f"weighted CE did not fall on a fixed batch: {fixed_losses}")
    del state

    # the main path: cli.train_resnet3d on the card
    train_ckpt = os.path.join(work, "train_ckpt")
    train_argv = [f"label_file={train_csv}", f"mri_dir={train_mri}", "model_depth=18",
                  "resnet_shortcut=B", "compute_dtype=bfloat16", f"batch_size={BATCH}",
                  "hbm_cache=true", "augment=true", "precise_bn=true",
                  "normalizer=scale_intensity", "n_splits=2",
                  f"num_epochs={TRAIN_EPOCHS}", "lr=1e-3", f"checkpoint_dir={train_ckpt}"]
    fg.gather_normalize.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    results = cli_train.main(train_argv)
    torch.cuda.synchronize()
    train_wall = time.time() - t0
    train_launches = fg.gather_normalize.launches
    train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # per fold and epoch: train, precise-BN and validation batches of 16
    # subjects (2 each); then one test batch of 8 per fold
    per_epoch = 3 * (-(-(len(tr_val) // 2) // BATCH))
    expect = 2 * TRAIN_EPOCHS * per_epoch + 2 * (-(-len(test_recs) // BATCH))
    log(f"cli.train_resnet3d: {train_wall:.1f} s (dataset upload, 2 folds x "
        f"{TRAIN_EPOCHS} epochs, checkpoints, test); K1 launches {train_launches} "
        f"(expected {expect}); peak memory {train_peak_gb:.2f} GB")
    check(train_launches == expect, f"training ran K1 {train_launches} times, expected {expect}")
    with open(os.path.join(train_ckpt, "cv_results.csv")) as f:
        cv_rows = list(csv.reader(f))
    check(len(cv_rows) == 1 + 2 * TRAIN_EPOCHS and all(len(r) == 19 for r in cv_rows),
          f"cv_results.csv is {len(cv_rows)} rows of {len(cv_rows[0])} columns")
    il, vl = cv_rows[0].index("tr_loss"), cv_rows[0].index("vl_loss")
    cv_losses = [(float(r[il]), float(r[vl])) for r in cv_rows[1:]]
    check(bool(np.isfinite(cv_losses).all()), f"non-finite CV losses {cv_losses}")
    log(f"  cv_results.csv (fold, epoch, tr_loss, vl_loss, lr): "
        f"{[(r[0], r[1], r[il], r[vl], r[-1]) for r in cv_rows[1:]]}")
    for k in (1, 2):
        for name in (f"best_fold{k}", f"model_fold{k}_final"):
            check(os.path.isfile(os.path.join(train_ckpt, name, "model.pt"))
                  and os.path.isfile(os.path.join(train_ckpt, name, ckpt.TRAIN_STATE_FILE)),
                  f"checkpoint {name} missing")
    check(all(np.isfinite(results["avg"][k]) for k in ("ACC", "AUC", "SPE", "MCC")),
          f"test metrics {results['avg']}")
    log(f"  test metrics (fold mean): "
        + ", ".join(f"{k} {v:.4f}" for k, v in results["avg"].items()))

    # serve the trained folds: the ensemble is the mean of the folds' test
    # probabilities
    trained = EnsemblePredictor.from_checkpoint_dir(train_ckpt, batch_size=BATCH)
    served = trained.predict_proba(np.stack([load_volume(r["MRI"]) for r in test_recs]))
    pooled = np.asarray(results["pooled"]["probs"]).reshape(2, len(test_recs))
    d_serve = float(np.abs(served[:, 1] - pooled.mean(0)).max())
    log(f"  served trained best_fold1..2: prob_1 {np.round(served[:, 1], 4).tolist()}; "
        f"against the test run's fold mean max |d| {d_serve:.3g}")
    check(bool(np.isfinite(served).all()) and d_serve <= 2e-3,
          f"serving the trained folds differs from their test run by {d_serve}")
    del trained

    # training rate on the resident path: gather + K1 + augmentation + step
    state = fresh_state(SEED + 12)
    it = DeviceEpochIterator(train_ds, np.arange(train_ds.n), BATCH, shuffle=True,
                             seed=SEED, augment=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    batches = (bt for _ in range(4) for bt in it)  # 16 steps, 4 epochs of 4
    events, t_wall = [], None
    for step_i in range(16):
        if step_i == 2:
            torch.cuda.synchronize()
            t_wall = time.time()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        loop.train_step(state, next(batches), cw)  # gather + K1 + augment + step
        b.record()
        if step_i >= 2:
            events.append((a, b))
    torch.cuda.synchronize()
    wall = time.time() - t_wall
    step_ms = statistics.median(a.elapsed_time(b) for a, b in events)
    train_rate = BATCH / (step_ms / 1e3)
    pipelined_rate = len(events) * BATCH / wall
    train_peak_step_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"training: {train_rate:.2f} vols/s (resident, augmented, B={BATCH}: median step "
        f"{step_ms:.2f} ms of {len(events)} after 2 of warm-up, CUDA events), "
        f"{pipelined_rate:.2f} vols/s over the {len(events)} steps back to back (host "
        f"clock) on {card}; peak memory {train_peak_step_gb:.2f} GB")

    def step_split():
        """One resident step, each stage between CUDA events."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        idx = it._upload(np.asarray(rng.permutation(train_ds.n)[:BATCH], np.int64))
        ev[0].record()
        bt = train_ds.gather_normalized(idx)
        ev[1].record()
        t_aug = time.perf_counter()
        bt["image"] = augment_batch(bt["image"], it.generator, **it.aug_kw)
        host_aug.append(1e3 * (time.perf_counter() - t_aug))
        ev[2].record()
        loop.forward_backward(state, bt, cw)
        ev[3].record()
        loop.apply_gradients(state)
        ev[4].record()
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]

    host_aug = []
    splits = [step_split() for _ in range(7)]
    names = ("gather_k1_ms", "augment_ms", "forward_backward_ms", "optimizer_ms")
    train_split = {n: statistics.median(sp[i] for sp in splits) for i, n in enumerate(names)}
    log(f"time split of a resident step (ms; CUDA events from an idle card, host "
        f"launch costs included; gather_k1 is K1 + the label gather; median of 7): "
        + ", ".join(f"{k} {v:.3f}" for k, v in train_split.items())
        + f"; sum {sum(train_split.values()):.2f} ms; augmentation's host time "
        f"(launches and planning) median {statistics.median(host_aug):.3f} ms")
    aug_in = train_ds.gather_normalized(np.arange(BATCH))["image"]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            augment_batch(aug_in, it.generator, **it.aug_kw)
        torch.cuda.synchronize()
    log("profile of 4 augmentations of a batch of 8, by host time:")
    log(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=12,
                                  max_name_column_width=60))
    del aug_in
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _, batch in zip(range(2), it):
            loop.train_step(state, batch, cw)
        torch.cuda.synchronize()
    log("profile of 2 resident train steps (device time by kernel):")
    log(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=15,
                                  max_name_column_width=60))
    log("the same 2 steps by host time:")
    log(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=15,
                                  max_name_column_width=60))
    del state, it, train_ds, fixed

    # fp32, TF32 off: three steps of a ResNet-10, card against host CPU. The
    # card starts each step from the host's weights and Adam state: where a
    # gradient is near zero Adam can step either way on the two sides (it
    # moves a parameter by about lr whatever the gradient's size), and over
    # free-running steps those flips feed the next forward
    def make_state(device):
        m = generate_model(model_depth=10, dropout_rate=0.0, compute_dtype=torch.float32,
                           generator=torch.Generator().manual_seed(SEED)).to(device)
        return loop.create_train_state(m, loop.make_epoch_schedule(1e-3, 20))

    host_st, card_st = make_state(torch.device("cpu")), make_state(dev)
    gs = torch.Generator().manual_seed(SEED + 1)
    fp32_rows = []
    for _ in range(3):
        card_st.model.load_state_dict(host_st.model.state_dict())
        if host_st.step:
            card_st.optimizer.load_state_dict(host_st.optimizer.state_dict())
        card_st.step = host_st.step
        bt = {"image": torch.randn((4, 32, 38, 32, 1), generator=gs) * 2 + 1,
              "label": torch.tensor([0, 1, 1, 0]), "mask": torch.tensor([1.0, 1.0, 1.0, 0.0])}
        cwt = torch.tensor([0.3, 0.7])
        l_host = float(loop.train_step(host_st, bt, cwt)[0])
        l_card = float(loop.train_step(card_st, {k: v.to(dev) for k, v in bt.items()},
                                       cwt.to(dev))[0])
        h_sd = host_st.model.state_dict()
        c_sd = {k: v.cpu() for k, v in card_st.model.state_dict().items()}
        stats = max(float(((c_sd[k] - v).abs() / (1e-3 + 1e-3 * v.abs())).max())
                    for k, v in h_sd.items() if ".running_" in k)
        d_par = torch.cat([(c_sd[k] - v).abs().flatten() for k, v in h_sd.items()
                           if v.is_floating_point() and ".running_" not in k])
        fp32_rows.append((l_card, l_host, stats, float(d_par.max()),
                          float((d_par <= 1e-3).float().mean())))
    lr_max = 1e-3
    log("ResNet-10 fp32, 3 steps at 32x38x32, card vs host CPU from the host's state "
        "(loss card / host, BN statistics as a share of the rtol = atol = 1e-3 bound, "
        "parameter max |d| against 2 lr, share within 1e-3): "
        + "; ".join(f"{a:.7f} / {b:.7f}, {c:.3g}, {d:.3g}, {e:.6f}"
                    for a, b, c, d, e in fp32_rows))
    check(all(abs(a - b) <= 1e-3 + 1e-3 * abs(b) and c <= 1.0 and d <= 2 * lr_max
              and e >= 0.999 for a, b, c, d, e in fp32_rows),
          "card and host fp32 train steps differ beyond their bounds")
    shutil.rmtree(work, ignore_errors=True)

    # ---- 9. result -----------------------------------------------------
    ms, plain_ms, bound, bound_by = timings["serving f32->bf16 B=8"]
    kernels = {"kernels": [{
        "name": "fused_gather_normalize",
        "route": "cuda",
        "source": K1_SOURCE,
        "replaces": K1_REPLACES,
        "launches": serve_launches + resident_launches + ext_k1 + train_launches,
        "launches_serving": serve_launches,
        "launches_resident": resident_launches,
        "launches_extraction": ext_k1,
        "launches_training": train_launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": None,
        "shape": "float32 (8, 91, 109, 91, 1) -> bfloat16, B=8",
        "ms_resident_u8_b8": timings["resident u8->bf16 B=8"][0],
        "ms_resident_u8_b32": timings["resident u8->bf16 B=32"][0],
        "ms_extraction_f32_b8": k1_ext_ms,
        "bound_ms_extraction_f32_b8": k1_ext_bound,
        "empty_launch_ms": empty_ms,
        "kernels_per_call": k1_kernels,
        "mode_by_shape": k1_modes,
        "design_pr": 3,
    }, {
        "name": "roi_pool",
        "route": "cuda",
        "source": K2_SOURCE,
        "replaces": K2_REPLACES,
        "launches": ext_k2,
        "max_abs_err": k2_err,
        "ms": k2_ms,
        "plain_ms": k2_plain_ms,
        "bound_ms": k2_bound,
        "bound_by": k2_bound_by,
        "library_ms": k2_lib_ms,
        "shape": "float32 (8, 91, 109, 91, 64), 166 ROIs -> (8, 166, 64)",
        "ms_on_tap": k2_tap_ms,
        "bound_ms_on_tap": k2_tap_bound,
        "tap_path": tap_path,
        "launches_by_path": ext_k2_paths,
        "tile_size": ext_atlas.tile_size,
        "tiles_2mm": ext_atlas.num_tiles,
        "ms_1mm_600_rois": k2_1mm_ms,
        "bound_ms_1mm_600_rois": k2_1mm_bound,
        "design_pr": 3,
    }]}
    log(json.dumps({"serving_vols_per_s": serve_rates,
                    "resident_vols_per_s": {str(k): v for k, v in resident_rates.items()},
                    "extraction_subjects_per_s": rate,
                    "extraction_split_ms": split,
                    "extraction_peak_gb": peak_gb,
                    "training_vols_per_s": train_rate,
                    "training_vols_per_s_pipelined": pipelined_rate,
                    "training_step_split_ms": train_split,
                    "training_step_median_ms": step_ms,
                    "training_augment_host_ms": statistics.median(host_aug),
                    "training_first_step_s": fixed_walls[0],
                    "training_autotune_s": autotune_s,
                    "training_cli_s": train_wall,
                    "training_peak_gb": train_peak_step_gb,
                    "training_cli_peak_gb": train_peak_gb,
                    "training_test_avg": results["avg"],
                    "card": card, "seconds": time.time() - t_start}))
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
