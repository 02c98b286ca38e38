#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (multimodal_ad_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit, nothing is caught):

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build K1 (csrc/fused_gather.cu), K2 (csrc/roi_pool.cu) and K3
   (csrc/int8_conv.cu) with nvcc for sm_90a, in parallel, timed, and the
   native NIfTI decoder (native/nifti_reader.cpp) with g++, timed; the run
   fails if either does not build;
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
7. the native NIfTI decoder: bit-equal to the Python reader on the 50
   volumes below, each reader's decode rate at VolumeBatcher's
   8 threads (in turns) and NativeBatchDecoder's; then ROI extraction: a
   50-subject dataset at 91x109x91, the atlas as NIfTI +
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
9. U-Net classifier training on phase 8's dataset: the host-planned
   augmentation (K1 + `apply_plans`) on the card against the host CPU for
   the same plans (every combination of flip, rotation and zoom; 1e-6);
   8 AdamW steps of a fresh UNet3DClassifier (base 32, bf16) on one fixed
   batch at a constant rate, whose CE must fall, the first step timed
   (cuDNN autotune); the step rate (median of 12 after 2 of warm-up, CUDA
   events), its split (K1 + augmentation, forward + backward, optimizer),
   peak memory and a profile of two steps; streamed epochs, for the
   share of time the card waits on the host's decode, with the native
   decoder and with the Python reader (MAD_NO_NATIVE_IO=1): one uncounted
   epoch, then four epochs at a time in turns native, python, python,
   native; then
   `cli.train_unet3d` (augment, 2 epochs, lr 1e-3): K1 launched on every
   batch, finite losses, the 19-column unet_results.csv, best_model's fp32
   logits on the card against the host CPU (2e-3); and the JAX package's
   small learning recipe (best validation AUC >= 0.85);
10. the denoising autoencoder (UNet3D 64/128/256/512, bf16, batch 8): its
   step time, rate, first step, peak memory and profile;
   `train_unet_autoencoder` (2 epochs), `load_autoencoder` and
   `extract_unet_features` from it over phase 7's 10 test subjects: K1 and
   K2 launched, CSV shapes, finite values, ROI features that differ from
   phase 7's untrained network's; the JAX package's small recipe (best
   validation MSE < 0.05);
11. int8 serving: K3 (csrc/int8_conv.cu) against its plain version
   (float64 convolution + the plain epilogues), bit-equal in all four
   epilogues (the block output with a bf16 and a float32 residual, with
   and without the next quant point) at the ten distinct block-conv shapes
   of the flagship at B = 8, at a depth-50 Bottleneck set at B = 2 and at
   odd sizes; its time in each epilogue the path runs on a shape (as
   K1's) beside its bound, the share of the dense taps its tiles execute
   and the share inside the volume, `torch._int_mm` on a pre-built im2col
   matrix of the same GEMM (int32-equal to K3), the bf16 cuDNN
   convolution of the same shape and the plain version; then phase 4's
   five folds through `EnsemblePredictor.quantize_int8` -> `predict_proba`
   (K3 launched 19 x 5 times a batch), calibration seconds, int8 against
   bf16 (max |dprob|, argmax agreement), the int8 ensemble on the card
   against the same export and scales on the host CPU (2 volumes;
   probabilities within 1e-2, and from one stem output the quant points
   bit-equal), resident int8 and bf16 vols/s at B = 8 and 32 and
   `predict_proba` vols/s, the s2d bf16 stem's time against the fp32 7^3
   stem's, a profile of one int8 batch split into K3, stem, quantize and
   elementwise, max pool, with the device kernels each launches a fold;
   and phase 8's trained folds quantized with
   training volumes: `evaluate_records` AUC of int8 within 0.01 of bf16
   over the 8 test subjects and 40 more held-out subjects of phase 8's
   generator (the test subjects' AUC is printed too);
12. DenseNet-3D training at the TPU package's full width (growth 16,
   blocks 6/12/24/16, dilations 1/1/2/4, 64 initial features, compression
   0.5, dropout 0.2, bf16 autocast, batch 8): 8 steps on one fixed batch,
   whose weighted CE must fall, the first timed; `cli.train_densenet` on
   phase 8's dataset as phase 8 trains the ResNet (hbm_cache + augment +
   precise_bn, 2 folds x 2 epochs): K1 launched on every batch, finite
   losses, the 19-column CSV, the checkpoints, finite test metrics; the
   resident augmented rate (median of 14 steps after 2, CUDA events), a
   profile of 4 steps (device time against wall time, so the idle share;
   device kernels a step; the depthwise convs' share; the top kernels),
   peak memory; three fp32 steps of a narrow DenseNet, card against host,
   held to phase 8's bars;
13. encoder features: `extract_encoder_features` of a seeded ResNet-18 B
   in float32 with heads none (1,032,192 floats a row) and pool over
   phase 7's 10 test subjects at batch 8: CSV shapes, finite values, the
   stage-tap shape file, K1 launched a batch, native decodes, subjects/s
   and a batch's split (forward against CSV writing); a ResNet-10 on the
   card against the host (rtol = atol = 1e-3); the seg head (ResNet-18
   head seg, B = 2, fp32) on the card against the host (1e-3 of the
   spread);
14. MSHyper at the TPU package's defaults (d_model 64, windows (4, 4),
   inner size 3, attention; seq 96 -> 24, 7 channels, batch 32): forward
   and the gradients of one backward on the card against the host (1e-4
   of each tensor's spread), the train step's time; `cli.pvalue` and
   `cli.roi_visualize --query-voxel --query-world --html` over phase 6's
   atlas (no --mri: the card's machine has no matplotlib);
15. tabular in-context inference, with sklearn, pandas, flax and msgpack
   blocked, on a seeded synthetic clinical table written by `make_table`
   (580 rows, 14 leading columns and 156 features, 6 of them string
   categoricals, classes CN / SMCI / PMCI / AD, 7.3 % of the numeric cells
   blank and two columns 95 % blank): (a) the three bundled assets read by
   the port's msgpack reader (leaves, parameters, read time); (b) the
   full-width classifier network (V = 8 views, a 512-row bucket with 464
   valid rows, 116 queries, the categorical mask) on the card against the
   host CPU (logits, query and context states and the penultimate tap
   within 1e-4 of their spread), its time (CUDA events, median of 25)
   beside its FLOP bound at the fp32 rate, the attention alone against
   SDPA (comparison only) and the device kernels a forward launches; (c)
   `ICLClassifier()` with every default on the 464 / 116 split: fit and
   predict times, the chosen preprocess, test ACC and macro AUC, and the
   same fit on the host (the same preprocess, probabilities within 1e-4,
   predictions equal where the top two differ by more than 1e-3); (d)
   `ICLRegressor()` on a target drawn from the table's columns: mean,
   median and quantiles on the card against the host within 1e-4 of the
   target's spread; (e) `tabel_encoder_multi` with the default
   `EnsembleICLEmbedder` (6 members x 4 views, n_fold 5, test 0.2): wall
   time, 36 forwards, CSV shapes (1,776 embedding columns), finite values,
   a second run byte-identical, the wall split into host work, card
   forwards and CSV writing, and the card's idle share (a profile);
16. one JSON line {"kernels": [...]} and, last, the device line.

Every streamed path of phases 7, 9 (cli.train_unet3d), 10 and 13 prints
VolumeBatcher's decodes by reader and fails unless they are all native;
phase 9's timed epochs check that each ran on the reader it was given.

It exits non-zero without printing a result when no CUDA device is
present, or when the port's package is not beside it.
"""

from __future__ import annotations

import csv
import json
import math
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
K3_REPLACES = "multimodal_ad_tpu/models/resnet3d_int8.py:131"
K3_SOURCE = "multimodal_ad_tpu_torch/csrc/int8_conv.cu"
INT8_OPS_PER_S = 1979e12  # H100 SXM data sheet, int8 dense tensor-core rate
# K3 at the flagship's block convs, B = 8 (name, input grid, C_in, C_out,
# kernel, stride, dilation, and the epilogues the path runs on the shape
# with their launches a forward: "int8" a block's first conv, "float32" its
# shortcut conv, "block_out bf16" / "block_out f32" its last conv with the
# identity's or the shortcut's residual; "last": the last block, which
# writes no next quant point)
K3_SHAPES = [
    ("stage 1, 3^3, 64->64", (23, 28, 23), 64, 64, 3, 1, 1,
     (("int8", 2), ("block_out bf16", 2))),
    ("stage 2 b0 conv1, 3^3/2, 64->128", (23, 28, 23), 64, 128, 3, 2, 1, (("int8", 1),)),
    ("stage 2 down, 1^3/2, 64->128", (23, 28, 23), 64, 128, 1, 2, 1, (("float32", 1),)),
    ("stage 2, 3^3, 128->128", (12, 14, 12), 128, 128, 3, 1, 1,
     (("int8", 1), ("block_out f32", 1), ("block_out bf16", 1))),
    ("stage 3 b0 conv1, 3^3 d2, 128->256", (12, 14, 12), 128, 256, 3, 1, 2, (("int8", 1),)),
    ("stage 3 down, 1^3, 128->256", (12, 14, 12), 128, 256, 1, 1, 1, (("float32", 1),)),
    ("stage 3, 3^3 d2, 256->256", (12, 14, 12), 256, 256, 3, 1, 2,
     (("int8", 1), ("block_out f32", 1), ("block_out bf16", 1))),
    ("stage 4 b0 conv1, 3^3 d4, 256->512", (12, 14, 12), 256, 512, 3, 1, 4, (("int8", 1),)),
    ("stage 4 down, 1^3, 256->512", (12, 14, 12), 256, 512, 1, 1, 1, (("float32", 1),)),
    ("stage 4, 3^3 d4, 512->512", (12, 14, 12), 512, 512, 3, 1, 4,
     (("int8", 1), ("block_out f32", 1), ("block_out bf16 last", 1))),
]
# a depth-50 Bottleneck set at B = 2 on reduced grids, and odd sizes
K3_EXTRA = [
    ("d50 stage 1 conv1, 1^3, 64->64, B=2", 2, (12, 14, 12), 64, 64, 1, 1, 1),
    ("d50 stage 1 conv3, 1^3, 64->256, B=2", 2, (12, 14, 12), 64, 256, 1, 1, 1),
    ("d50 stage 1 b1 conv1, 1^3, 256->64, B=2", 2, (12, 14, 12), 256, 64, 1, 1, 1),
    ("d50 stage 2 conv2, 3^3/2, 128->128, B=2", 2, (12, 14, 12), 128, 128, 3, 2, 1),
    ("d50 stage 2 down, 1^3/2, 256->512, B=2", 2, (12, 14, 12), 256, 512, 1, 2, 1),
    ("d50 stage 3 conv2, 3^3 d2, 256->256, B=2", 2, (6, 7, 6), 256, 256, 3, 1, 2),
    ("d50 stage 3 conv3, 1^3, 256->1024, B=2", 2, (6, 7, 6), 256, 1024, 1, 1, 1),
    ("d50 stage 4 conv1, 1^3, 2048->512, B=2", 2, (6, 7, 6), 2048, 512, 1, 1, 1),
    ("d50 stage 4 conv2, 3^3 d4, 512->512, B=2", 2, (6, 7, 6), 512, 512, 3, 1, 4),
    ("d50 stage 4 conv3, 1^3, 512->2048, B=2", 2, (6, 7, 6), 512, 2048, 1, 1, 1),
    ("B=1 stage 2 b0 conv1, 3^3/2, 64->128", 1, (23, 28, 23), 64, 128, 3, 2, 1),
    ("B=3 stage 4, 3^3 d4, 512->512", 3, (12, 14, 12), 512, 512, 3, 1, 4),
    ("B=3 odd grid 13x15x11, 3^3 d2, 96->40", 3, (13, 15, 11), 96, 40, 3, 1, 2),
]
INT8_HOST_VOLS = 2  # volumes of the card-vs-host int8 comparison
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


def step_events(torch, fn, n, warmup=2):
    """Run `fn()` warmup + n times back to back, each between CUDA events;
    returns (median ms of the last n, host wall s of the first call)."""
    events, first = [], None
    for i in range(warmup + n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.time()
        a.record()
        fn()
        b.record()
        if i == 0:
            b.synchronize()
            first = time.time() - t0
        if i >= warmup:
            events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events), first


def card_vs_host_steps(torch, dev, make_model, shape):
    """Three fp32 train steps (TF32 off) of `make_model()` at `shape`, B =
    4 with one padded row, card against host CPU. The card starts each step
    from the host's weights and Adam state: where a gradient is near zero
    Adam can step either way on the two sides (it moves a parameter by about
    lr whatever the gradient's size), and over free-running steps those
    flips feed the next forward. Rows: (card loss, host loss, BN statistics
    as a share of the rtol = atol = 1e-3 bound, parameter max |d|, share of
    parameters within 1e-3)."""
    from multimodal_ad_tpu_torch.train import loop

    def make_state(device):
        return loop.create_train_state(make_model().to(device),
                                       loop.make_epoch_schedule(1e-3, 20))

    host_st, card_st = make_state(torch.device("cpu")), make_state(dev)
    gs = torch.Generator().manual_seed(SEED + 1)
    rows = []
    for _ in range(3):
        card_st.model.load_state_dict(host_st.model.state_dict())
        if host_st.step:
            card_st.optimizer.load_state_dict(host_st.optimizer.state_dict())
        card_st.step = host_st.step
        bt = {"image": torch.randn((4, *shape, 1), generator=gs) * 2 + 1,
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
        rows.append((l_card, l_host, stats, float(d_par.max()),
                     float((d_par <= 1e-3).float().mean())))
    return rows


def log_card_vs_host_steps(rows, name, lr_max=1e-3):
    """Print `card_vs_host_steps`' rows and hold them to their bars: losses
    rtol = atol = 1e-3, BN statistics within the same, parameters within 2
    lr and 99.9 % of them within 1e-3."""
    log(f"{name} fp32, 3 steps, card vs host CPU from the host's state (loss card / host, "
        "BN statistics as a share of the rtol = atol = 1e-3 bound, parameter max |d| against "
        "2 lr, share within 1e-3): "
        + "; ".join(f"{a:.7f} / {b:.7f}, {c:.3g}, {d:.3g}, {e:.6f}" for a, b, c, d, e in rows))
    check(all(abs(a - b) <= 1e-3 + 1e-3 * abs(b) and c <= 1.0 and d <= 2 * lr_max
              and e >= 0.999 for a, b, c, d, e in rows),
          f"card and host fp32 {name} train steps differ beyond their bounds")


def reads_since(before):
    """VolumeBatcher's decodes by reader since the counts `before`."""
    from multimodal_ad_tpu_torch.data.pipeline import VolumeBatcher

    return {k: v - before.get(k, 0) for k, v in VolumeBatcher.reads.items()}


def reads_now():
    from multimodal_ad_tpu_torch.data.pipeline import VolumeBatcher

    return dict(VolumeBatcher.reads)


def check_native_reads(counts, phase):
    check(counts["native"] > 0 and counts["python"] == 0,
          f"{phase} decoded {counts} (expected the native reader only)")


def top_kernels(torch, fn, rows=12):
    """The device-time table of `fn()` under torch.profiler."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=rows,
                                     max_name_column_width=60)


def native_decoder_check(torch, mri_dir):
    """Phase 7's first part: the native NIfTI decoder builds here (g++),
    is bit-equal to the Python reader on every file of `mri_dir`, and each
    reader's decode rate at VolumeBatcher's 8 threads (in turns: python,
    native, native, python), with NativeBatchDecoder's."""
    from concurrent.futures import ThreadPoolExecutor

    from multimodal_ad_tpu_torch.data.pipeline import read_volume
    from multimodal_ad_tpu_torch.utils import native_loader, nifti

    out = {}
    check(native_loader.available(), "the native NIfTI decoder is not loaded")
    paths = sorted(os.path.join(mri_dir, f) for f in os.listdir(mri_dir))
    for p in paths:
        vol, reader = read_volume(p)
        ref = nifti.load(p)
        check(reader == "native" and vol.shape == VOL_SHAPE
              and np.array_equal(vol.view(np.uint32), ref.view(np.uint32)),
              f"native decode of {p} ({reader}) differs from the Python reader's")
    log(f"native NIfTI decoder ({native_loader.library_path().name}): {len(paths)} volumes "
        "bit-equal to the Python reader")
    rates = {"native": [], "python": []}
    with ThreadPoolExecutor(max_workers=8) as pool:
        for reader in ("python", "native", "native", "python"):
            t0 = time.time()
            vols = list(pool.map(lambda p: read_volume(p, native=reader == "native"), paths))
            rates[reader].append(len(paths) / (time.time() - t0))
            check(all(r == reader for _, r in vols), f"{reader} run used another reader")
    t0 = time.time()
    native_loader.NativeBatchDecoder(VOL_SHAPE, n_threads=8).decode(paths)
    out["batch_decoder_vols_per_s"] = len(paths) / (time.time() - t0)
    out["decode_vols_per_s"] = rates
    log(f"decode rate of {len(paths)} uncompressed 91x109x91 float32 volumes at 8 threads "
        f"(vols/s, host clock, page cache warm): native {[round(r, 1) for r in rates['native']]}, "
        f"python {[round(r, 1) for r in rates['python']]}; NativeBatchDecoder (8 pthreads) "
        f"{out['batch_decoder_vols_per_s']:.1f}")
    return out


def unet_classifier_phase(torch, dev, card, work, train_csv, train_mri, records):
    """Phase 9: UNet3DClassifier (base 32, bf16) training on the card."""
    from multimodal_ad_tpu_torch.cli import train_unet3d as cli_unet
    from multimodal_ad_tpu_torch.core.config import Config
    from multimodal_ad_tpu_torch.data.pipeline import VolumeBatcher, load_volume
    from multimodal_ad_tpu_torch.data.synthetic import make_adni_dir
    from multimodal_ad_tpu_torch.data.transforms import (AugmentPlan, VolumeTransform,
                                                         apply_plans)
    from multimodal_ad_tpu_torch.models.unet3d import UNet3DClassifier
    from multimodal_ad_tpu_torch.ops import fused_gather as fg
    from multimodal_ad_tpu_torch.ops.normalize import scale_intensity
    from multimodal_ad_tpu_torch.train import checkpoint as ckpt
    from multimodal_ad_tpu_torch.train import loop
    from multimodal_ad_tpu_torch.train.cv import _device_batches
    from multimodal_ad_tpu_torch.train.single_split import (single_split,
                                                            train_unet_classifier)

    log(f"== 9. U-Net classifier training: UNet3DClassifier base 32, bf16 autocast, "
        f"91x109x91, batch {BATCH}, host-planned augmentation")
    out = {}
    u_train, u_val, _ = single_split(records, 42)
    raw_host = torch.from_numpy(np.stack([load_volume(r["MRI"]) for r in u_train[:BATCH]])
                                [..., None])
    labels = torch.tensor([r["label"] for r in u_train[:BATCH]], device=dev)
    raw = raw_host.to(dev)

    # the card's augmentation against its host-CPU version, for the same
    # plans: every combination of flip, rotation and zoom, and the identity
    plans = [AugmentPlan(True, 0.04, 0.96), AugmentPlan(False, -0.05, None),
             AugmentPlan(False, None, 0.951), AugmentPlan(True, None, None), AugmentPlan(),
             AugmentPlan(False, 0.01, 0.99), AugmentPlan(True, -0.02, None),
             AugmentPlan(True, None, 0.97)]
    card_aug = apply_plans(scale_intensity(raw), plans)
    host_aug = apply_plans(scale_intensity(raw_host), plans)
    aug_err = float((card_aug.cpu() - host_aug).abs().max())
    bit_equal = torch.equal(card_aug.cpu(), host_aug)
    log(f"augmentation (K1 + apply_plans), card vs host CPU, 8 full-size volumes: max |d| "
        f"{aug_err:.3g}, bit-equal {bit_equal} (bound 1e-6)")
    check(aug_err <= 1e-6, f"card and host augmentation differ by {aug_err}")
    out["augment_card_vs_host_max_abs"] = aug_err
    del host_aug, card_aug
    t0 = time.perf_counter()
    tf = VolumeTransform(augment=True, seed=42)
    for i in range(100):
        tf.plan(i, 0)
    out["plan_host_ms_per_volume"] = 1e3 * (time.perf_counter() - t0) / 100
    aug_ms, _ = step_events(torch, lambda: apply_plans(scale_intensity(raw), plans), 5)
    out["k1_augment_ms"] = aug_ms
    log(f"K1 + apply_plans of those plans: {aug_ms:.3f} ms a batch (CUDA events, median of "
        f"5); planning {out['plan_host_ms_per_volume']:.4f} ms a volume on the host")

    # one fixed batch, a constant rate: the plain CE must fall; the first
    # step carries cuDNN's autotune of this network's convolutions
    fixed = {"image": scale_intensity(raw), "label": labels,
             "mask": torch.ones(BATCH, device=dev)}
    ones = torch.ones(2, device=dev)
    model = UNet3DClassifier(generator=torch.Generator().manual_seed(SEED + 21)).to(dev)
    state = loop.create_train_state(model, lambda _: 1e-3, 1e-4, grad_clip_norm=0.0,
                                    optimizer="adamw")
    losses, walls = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(8):
        torch.cuda.synchronize()
        t0 = time.time()
        losses.append(float(loop.train_step(state, fixed, ones)[0]))
        walls.append(time.time() - t0)
    out["first_step_s"] = walls[0]
    out["autotune_s"] = walls[0] - statistics.median(walls[2:])
    log(f"fixed batch, 8 AdamW steps at a constant 1e-3: CE {[round(v, 4) for v in losses]}")
    log(f"first train step {walls[0]:.2f} s against {statistics.median(walls[2:]) * 1e3:.1f} ms "
        f"later (cudnn.benchmark {torch.backends.cudnn.benchmark}): autotune about "
        f"{out['autotune_s']:.2f} s")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"CE did not fall on a fixed batch: {losses}")

    # the rate: K1 + host-planned augmentation + step on resident raw batches
    tf_plans = [[tf.plan(i, e) for i in range(BATCH)] for e in range(2)]
    n = 0

    def step():
        nonlocal n
        x = apply_plans(scale_intensity(raw), tf_plans[n % 2])
        n += 1
        loop.train_step(state, {"image": x, "label": labels, "mask": fixed["mask"]}, ones)

    torch.cuda.reset_peak_memory_stats()
    out["step_ms"], _ = step_events(torch, step, 12)
    out["vols_per_s"] = BATCH / (out["step_ms"] / 1e3)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9

    def split_step():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        x = apply_plans(scale_intensity(raw), tf_plans[0])
        ev[1].record()
        loop.forward_backward(state, {"image": x, "label": labels, "mask": fixed["mask"]}, ones)
        ev[2].record()
        loop.apply_gradients(state)
        ev[3].record()
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]

    splits = [split_step() for _ in range(5)]
    names = ("k1_augment_ms", "forward_backward_ms", "optimizer_ms")
    out["split_ms"] = {k: statistics.median(sp[i] for sp in splits) for i, k in enumerate(names)}
    log(f"training: {out['vols_per_s']:.2f} vols/s (B={BATCH}: median step {out['step_ms']:.2f} ms "
        f"of 12 after 2 of warm-up, CUDA events; K1 + augmentation + forward + backward + "
        f"AdamW) on {card}; peak memory {out['peak_gb']:.2f} GB")
    log("time split of a step (ms; CUDA events from an idle card, median of 5): "
        + ", ".join(f"{k} {v:.3f}" for k, v in out["split_ms"].items()))
    log("profile of 2 train steps (device time by kernel):")
    log(top_kernels(torch, lambda: [step() for _ in range(2)]))

    # streaming: how long the card waits for the host's NIfTI decode, with
    # the native decoder and with the Python reader (MAD_NO_NATIVE_IO=1), in
    # turns after one uncounted run: native, python, python, native; 4
    # epochs a run (at 2 epochs a run one reader's runs spread over 21-32 %)
    def streamed_epochs(python_reader, epochs=4):
        if python_reader:
            os.environ["MAD_NO_NATIVE_IO"] = "1"
        before = reads_now()
        try:
            loader = VolumeBatcher(u_train, batch_size=BATCH, shuffle=True, seed=42,
                                   transform=VolumeTransform(augment=True, seed=42))
            dev_ms = []
            torch.cuda.synchronize()
            t0 = time.time()
            for _ in range(epochs):
                for bt in _device_batches(loader, dev, "scale_intensity", 2):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    loop.train_step(state, bt, ones)
                    b.record()
                    dev_ms.append((a, b))
            torch.cuda.synchronize()
            wall = time.time() - t0
        finally:
            os.environ.pop("MAD_NO_NATIVE_IO", None)
        busy = sum(a.elapsed_time(b) for a, b in dev_ms) / 1e3
        return wall, busy, len(dev_ms), reads_since(before)

    streamed_epochs(False, epochs=1)
    waits = {"native": [], "python": []}
    for reader in ("native", "python", "python", "native"):
        wall, busy, n_steps, counts = streamed_epochs(reader == "python")
        check(counts[reader] > 0 and sum(counts.values()) == counts[reader],
              f"streamed epochs with the {reader} reader decoded {counts}")
        waits[reader].append(1 - busy / wall)
        log(f"streamed epochs ({reader} NIfTI decode, VolumeBatcher's 8 threads, 4 x "
            f"{n_steps // 4} batches, decodes {counts}): {wall:.2f} s wall, steps {busy:.2f} s "
            f"on the card: the card waits on the host {1 - busy / wall:.1%} of the time")
    out["streamed_wait_share_native"] = waits["native"]
    out["streamed_wait_share_python"] = waits["python"]
    log(f"streamed wait share: native {[round(w, 4) for w in waits['native']]}, python "
        f"{[round(w, 4) for w in waits['python']]}")
    del state, model, fixed, raw

    # the main path: cli.train_unet3d on the card
    unet_ckpt = os.path.join(work, "unet_ckpt")
    fg.gather_normalize.launches = 0
    torch.cuda.reset_peak_memory_stats()
    before = reads_now()
    t0 = time.time()
    best_auc = cli_unet.main([
        "--device", "cuda", f"label_file={train_csv}", f"mri_dir={train_mri}",
        "compute_dtype=bfloat16", f"batch_size={BATCH}", "augment=true",
        "normalizer=scale_intensity", f"num_epochs={TRAIN_EPOCHS}", "lr=1e-3",
        f"checkpoint_dir={unet_ckpt}"])
    torch.cuda.synchronize()
    out["cli_s"] = time.time() - t0
    out["k1_launches"] = fg.gather_normalize.launches
    out["cli_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["cli_reads"] = reads_since(before)
    check_native_reads(out["cli_reads"], "cli.train_unet3d")
    log(f"cli.train_unet3d decodes by reader: {out['cli_reads']}")
    expect = TRAIN_EPOCHS * (-(-len(u_train) // BATCH) - (-len(u_val) // BATCH))
    log(f"cli.train_unet3d: {out['cli_s']:.1f} s ({len(u_train)} train / {len(u_val)} val "
        f"subjects streamed, {TRAIN_EPOCHS} epochs); K1 launches {out['k1_launches']} "
        f"(expected {expect}); best val AUC {best_auc:.4f}; peak memory {out['cli_peak_gb']:.2f} GB")
    check(out["k1_launches"] == expect,
          f"U-Net training ran K1 {out['k1_launches']} times, expected {expect}")
    with open(os.path.join(unet_ckpt, "unet_results.csv")) as f:
        rows = list(csv.reader(f))
    check(len(rows) == 1 + TRAIN_EPOCHS and all(len(r) == 19 for r in rows),
          f"unet_results.csv is {len(rows)} rows of {len(rows[0])} columns")
    il, vl = rows[0].index("tr_loss"), rows[0].index("vl_loss")
    cli_losses = [(float(r[il]), float(r[vl])) for r in rows[1:]]
    check(bool(np.isfinite(cli_losses).all()), f"non-finite losses {cli_losses}")
    log(f"  unet_results.csv (epoch, tr_loss, vl_loss, vl_auc, lr): "
        f"{[(r[1], r[il], r[vl], r[rows[0].index('vl_auc')], r[-1]) for r in rows[1:]]}")
    out["best_val_auc"] = best_auc

    # best_model restores; its fp32 logits on the card against the host CPU
    weights, meta = ckpt.restore_state(os.path.join(unet_ckpt, "best_model"))
    check(meta["metrics"]["val_auc"] == best_auc, f"best_model meta {meta['metrics']}")
    m32 = UNet3DClassifier(compute_dtype=torch.float32)
    m32.load_state_dict(weights)
    m32.eval()
    two = raw_host[:2]
    with torch.no_grad():
        card_logits = m32.to(dev)(scale_intensity(two.to(dev))).cpu().numpy()
        host_logits = m32.cpu()(scale_intensity(two)).numpy()
    d = float(np.abs(card_logits - host_logits).max())
    out["best_model_card_vs_host"] = d
    log(f"  best_model fp32 logits (2 volumes), card vs host CPU: max |d| {d:.3g} "
        f"(card {card_logits.ravel().round(4).tolist()})")
    check(np.allclose(card_logits, host_logits, rtol=2e-3, atol=2e-3),
          f"card and host best_model logits differ by {d}")
    del m32, weights

    # the JAX package's learning recipe at its small size (test_learning.py)
    t0 = time.time()
    lp_csv, lp_mri = make_adni_dir(os.path.join(work, "unet_lp"), n_per_class=24,
                                   classes=("AD", "CN"), shape=(16, 20, 16), seed=13,
                                   extent_jitter=0.3, center_jitter=0.04, noise=0.25)
    cfg = Config(label_file=lp_csv, mri_dir=lp_mri, task="ADCN", num_epochs=15, batch_size=4,
                 lr=1e-3, checkpoint_dir=os.path.join(work, "unet_lp_ckpt"),
                 compute_dtype="float32", loader_threads=2)
    lp_auc, _ = train_unet_classifier(
        cfg, model=UNet3DClassifier(base_ch=8, compute_dtype=torch.float32,
                                    generator=torch.Generator().manual_seed(SEED)),
        verbose=False, device=dev)
    out["recipe_best_val_auc"], out["recipe_s"] = lp_auc, time.time() - t0
    log(f"learning recipe (48 subjects 16x20x16, base 8, 15 epochs, batch 4, lr 1e-3, fp32): "
        f"best val AUC {lp_auc:.4f} in {out['recipe_s']:.1f} s (bar 0.85)")
    check(lp_auc >= 0.85, f"U-Net learning recipe: best val AUC {lp_auc} < 0.85")
    return out


def autoencoder_phase(torch, dev, card, work, train_csv, train_mri, records, ext_records,
                      atlas_labels, roi_names, untrained_roi_csv):
    """Phase 10: the UNet3D denoising autoencoder, then extraction from it."""
    from multimodal_ad_tpu_torch.core.config import Config
    from multimodal_ad_tpu_torch.data.pipeline import load_volume
    from multimodal_ad_tpu_torch.data.synthetic import make_adni_dir
    from multimodal_ad_tpu_torch.eval.features import extract_unet_features
    from multimodal_ad_tpu_torch.models.unet3d import UNet3D
    from multimodal_ad_tpu_torch.ops import fused_gather as fg
    from multimodal_ad_tpu_torch.ops import roi_pool as rp
    from multimodal_ad_tpu_torch.ops.normalize import scale_intensity
    from multimodal_ad_tpu_torch.train import autoencoder as ae_mod
    from multimodal_ad_tpu_torch.train import loop
    from multimodal_ad_tpu_torch.train.single_split import single_split

    log(f"== 10. autoencoder: UNet3D 64/128/256/512, bf16 autocast, 91x109x91 (96x112x96 "
        f"padded), batch {BATCH}; then extraction from its checkpoint")
    out = {}
    ae_train, ae_val, _ = single_split(records, 42)
    first = ae_train[:BATCH]
    x = scale_intensity(torch.from_numpy(np.stack([load_volume(r["MRI"]) for r in first])
                                         [..., None]).to(dev))
    batch = {"image": x, "mask": torch.ones(BATCH, device=dev)}
    model = UNet3D(compute_dtype=torch.bfloat16,
                   generator=torch.Generator().manual_seed(SEED + 31)).to(dev)
    state = loop.create_train_state(model, lambda _: 1e-3, ae_mod.WEIGHT_DECAY,
                                    grad_clip_norm=1.0, optimizer="adamw")
    step, _ = ae_mod.make_ae_steps(0.2, torch.Generator(device=dev).manual_seed(SEED + 7))
    torch.cuda.reset_peak_memory_stats()
    out["step_ms"], out["first_step_s"] = step_events(torch, lambda: step(state, batch), 10)
    out["vols_per_s"] = BATCH / (out["step_ms"] / 1e3)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"autoencoder step: first {out['first_step_s']:.2f} s (cudnn.benchmark "
        f"{torch.backends.cudnn.benchmark}), then median {out['step_ms']:.2f} ms of 10 after 2 "
        f"of warm-up (CUDA events) -> {out['vols_per_s']:.2f} vols/s on {card}; peak memory "
        f"{out['peak_gb']:.2f} GB")
    log("profile of 2 autoencoder steps (device time by kernel):")
    log(top_kernels(torch, lambda: [step(state, batch) for _ in range(2)]))
    del state, model, batch, x

    # the main path: train_unet_autoencoder, then extraction from its checkpoint
    cfg = Config(label_file=train_csv, mri_dir=train_mri, task="ADCN",
                 num_epochs=TRAIN_EPOCHS, batch_size=BATCH, lr=1e-3, compute_dtype="bfloat16",
                 checkpoint_dir=os.path.join(work, "ae_ckpt"))
    fg.gather_normalize.launches = 0
    torch.cuda.reset_peak_memory_stats()
    before = reads_now()
    t0 = time.time()
    best, path = ae_mod.train_unet_autoencoder(cfg, device=dev)
    torch.cuda.synchronize()
    out["train_s"], out["k1_launches"] = time.time() - t0, fg.gather_normalize.launches
    out["train_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["best_val_mse"] = best
    expect = TRAIN_EPOCHS * (-(-len(ae_train) // BATCH) - (-len(ae_val) // BATCH))
    log(f"train_unet_autoencoder: {out['train_s']:.1f} s ({TRAIN_EPOCHS} epochs streamed), "
        f"best val MSE {best:.5f}, K1 launches {out['k1_launches']} (expected {expect}); "
        f"peak memory {out['train_peak_gb']:.2f} GB")
    check(np.isfinite(best) and os.path.isfile(os.path.join(path, "model.pt")),
          f"autoencoder: best val MSE {best}, checkpoint {path}")
    check(out["k1_launches"] == expect,
          f"the autoencoder ran K1 {out['k1_launches']} times, expected {expect}")

    model = ae_mod.load_autoencoder(path, cfg, device=dev)
    fg.gather_normalize.launches = 0
    rp.roi_pool.launches = 0
    t0 = time.time()
    feat_csv, roi_csv = extract_unet_features(ext_records, atlas_labels, roi_names,
                                              os.path.join(work, "out_trained"), model=model,
                                              batch_size=BATCH, device=dev)
    out["extraction_s"] = time.time() - t0
    out["extraction_k1"] = fg.gather_normalize.launches
    out["extraction_k2"] = rp.roi_pool.launches
    out["reads"] = reads_since(before)
    check_native_reads(out["reads"], "autoencoder training and trained extraction")
    log(f"autoencoder training + trained extraction decodes by reader: {out['reads']}")
    log(f"extraction from the trained autoencoder: {out['extraction_s']:.2f} s for "
        f"{len(ext_records)} subjects; K1 launches {out['extraction_k1']}, K2 launches "
        f"{out['extraction_k2']}")
    check(out["extraction_k1"] > 0 and out["extraction_k2"] > 0,
          "trained extraction did not launch K1 and K2")
    with open(feat_csv) as f:
        frows = list(csv.reader(f))
    with open(roi_csv) as f:
        rrows = list(csv.reader(f))
    with open(untrained_roi_csv) as f:
        urows = list(csv.reader(f))
    check(len(frows) == 1 + len(ext_records) and all(len(r) == 1 + VOX for r in frows),
          f"features.csv is {len(frows)} rows of {len(frows[0])} columns")
    check(len(rrows) == 1 + len(ext_records)
          and all(len(r) == 1 + N_ROIS * ROI_CH for r in rrows),
          f"roi_features.csv is {len(rrows)} rows of {len(rrows[0])} columns")
    check(rrows[0] == urows[0] and [r[0] for r in rrows] == [r[0] for r in urows],
          "trained and untrained roi_features.csv differ in header or subjects")
    trained = np.asarray([r[1:] for r in rrows[1:]], np.float64)
    untrained = np.asarray([r[1:] for r in urows[1:]], np.float64)
    vox = np.asarray([r[1:] for r in frows[1:]], np.float64)
    check(bool(np.isfinite(trained).all() and np.isfinite(vox).all()), "non-finite features")
    out["roi_max_abs_diff_vs_untrained"] = float(np.abs(trained - untrained).max())
    log(f"  roi_features.csv {trained.shape}, finite; against the untrained network's "
        f"(phase 7): max |d| {out['roi_max_abs_diff_vs_untrained']:.4g}")
    check(out["roi_max_abs_diff_vs_untrained"] > 1e-3,
          "ROI features of the trained autoencoder equal the untrained network's")
    del model

    # the JAX package's autoencoder recipe at its small size (test_autoencoder.py)
    t0 = time.time()
    lp_csv, lp_mri = make_adni_dir(os.path.join(work, "ae_lp"), n_per_class=6,
                                   classes=("AD", "CN"), shape=(20, 24, 20), seed=0)
    cfg = Config(label_file=lp_csv, mri_dir=lp_mri, task="ADCN", num_epochs=3, batch_size=8,
                 lr=3e-3, checkpoint_dir=os.path.join(work, "ae_lp_ckpt"),
                 compute_dtype="float32", loader_threads=2)
    lp_best, _ = ae_mod.train_unet_autoencoder(
        cfg, model=UNet3D(level_channels=(8, 16, 32), bottleneck_channel=64,
                          generator=torch.Generator().manual_seed(SEED)),
        verbose=False, device=dev)
    out["recipe_best_val_mse"], out["recipe_s"] = lp_best, time.time() - t0
    log(f"autoencoder recipe (12 subjects 20x24x20, UNet3D 8/16/32/64, 3 epochs, batch 8, "
        f"lr 3e-3, fp32): best val MSE {lp_best:.5f} in {out['recipe_s']:.1f} s (bar 0.05)")
    check(lp_best < 0.05, f"autoencoder recipe: best val MSE {lp_best} >= 0.05")
    return out


def k3_work(batch, grid, c_in, c_out, ksize, stride, dil):
    """(operations, input bytes) the convolution needs: 2 C_in C_out per
    (output voxel, tap) pair whose tap lands inside the volume (taps in the
    padding multiply zeros), and the input voxels some tap reads (a strided
    1^3 conv reads one in stride^3)."""
    pad = dil * (ksize - 1) // 2
    pairs, read = 1, 1
    for s in grid:
        n_out = (s + 2 * pad - dil * (ksize - 1) - 1) // stride + 1
        pos = [o * stride - pad + t * dil for o in range(n_out) for t in range(ksize)]
        inside = [q for q in pos if 0 <= q < s]
        pairs *= len(inside)
        read *= len(set(inside))
    return 2.0 * batch * pairs * c_in * c_out, batch * read * c_in


def k3_epilogue(spec):
    """(epilogue, residual dtype name or None, writes the next quant point,
    bytes the epilogue moves per (M, N) element) of a K3_SHAPES entry: the
    output written, and for the block output the residual read and the
    bf16 h plus, unless it is the last block, the int8 quant point."""
    parts = spec.split()
    epi, res = parts[0], (parts[1] if len(parts) > 1 else None)
    if epi != "block_out":
        return epi, None, epi == "int8", {"int32": 4, "int8": 1, "float32": 4}[epi]
    q = "last" not in parts
    return epi, res, q, {"bf16": 2, "f32": 4}[res] + 2 + (1 if q else 0)


def k3_bound_ms(ops, in_bytes, m, n, k, out_bytes):
    """Least time for K3's work: the input voxels it needs, the weights and
    the epilogue vectors read once, `out_bytes` (k3_epilogue) moved per
    (M, N) element; or `ops` (k3_work) at the int8 dense rate."""
    moved = in_bytes + n * k + 8 * n + m * n * out_bytes
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def im2col(torch, x, ksize, stride, dil):
    """(B, D, H, W, C) -> (M, k^3 C) int8 rows in K3's K order (tap-major),
    zero rows for taps in the padding."""
    pad = dil * (ksize - 1) // 2
    xp = torch.nn.functional.pad(x, (0, 0) + (pad, pad) * 3)
    b, d, h, w, c = x.shape
    outs = [(s + 2 * pad - dil * (ksize - 1) - 1) // stride + 1 for s in (d, h, w)]
    cols = []
    for kd in range(ksize):
        for kh in range(ksize):
            for kw in range(ksize):
                cols.append(xp[:, kd * dil::stride, kh * dil::stride, kw * dil::stride][
                    :, :outs[0], :outs[1], :outs[2]])
    return torch.cat(cols, dim=-1).reshape(-1, ksize ** 3 * c)


def device_us(e):
    """Device time of a profiler row of a device kernel in microseconds (0
    for host-side rows, whose totals include their kernels; the attribute's
    name differs between torch versions)."""
    if not str(getattr(e, "device_type", "")).endswith("CUDA"):
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(e, name, None)
        if v is not None:
            return float(v)
    return 0.0


def int8_phase(torch, dev, card, work, ckpt_dir, vols, train_ckpt, tr_val, test_recs):
    """Phase 11: K3 against its plain version and its times, then int8
    serving of phase 4's folds and of phase 8's trained folds."""
    import copy

    from multimodal_ad_tpu_torch.data.adni import ADNIManifest
    from multimodal_ad_tpu_torch.data.device_cache import DeviceDataset
    from multimodal_ad_tpu_torch.data.pipeline import load_volume
    from multimodal_ad_tpu_torch.data.synthetic import make_adni_dir, make_volume
    from multimodal_ad_tpu_torch.ops import fused_gather as fg
    from multimodal_ad_tpu_torch.ops import int8_conv as k3
    from multimodal_ad_tpu_torch.serve import EnsemblePredictor, evaluate_records

    log("== 11. int8 serving: K3 against its plain version, then quantize_int8 of the "
        "5-fold ResNet-18")
    out = {}
    g = torch.Generator(device=dev).manual_seed(SEED + 50)

    def operands(batch, grid, c_in, c_out, ksize):
        x = torch.randint(-127, 128, (batch, *grid, c_in), generator=g, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (c_out, ksize, ksize, ksize, c_in), generator=g,
                          device=dev, dtype=torch.int8)
        # dequant factors of the size calibration gives (s_act * s_w ~ 1e-5)
        kv = torch.rand(c_out, generator=g, device=dev) * 2e-5 + 1e-6
        bv = torch.randn(c_out, generator=g, device=dev) * 0.5
        return x, w, kv, bv

    max_err = [0.0]  # the largest |K3 - plain| over every comparison

    def check_k3(name, batch, grid, c_in, c_out, ksize, stride, dil):
        """K3 against the plain version in every epilogue, the block output
        with a bf16 and a float32 residual, with and without the next
        quant point: bit-equal."""
        x, w, kv, bv = operands(batch, grid, c_in, c_out, ksize)
        acc = k3.conv_i8_plain(x, w, stride, dil)
        r = torch.randn(acc.shape, generator=g, device=dev) * 2
        cases = [(epi, None, 0.05) for epi in ("int32", "int8", "float32")]
        cases += [("block_out", res, s_next) for res in (r.to(torch.bfloat16), r)
                  for s_next in (0.05, None)]
        for epi, res, s_next in cases:
            got = k3.conv_i8(x, w, stride, dil, epi, kv, bv, s_next, res)
            ref = k3.epilogue_plain(acc, epi, kv, bv, s_next, res)
            if epi == "block_out":
                check((got[1] is None) == (s_next is None), f"K3 {name}: block_out's hq")
                got = torch.cat([got[0].float().flatten()]
                                + ([got[1].float().flatten()] if s_next else []))
                ref = torch.cat([ref[0].float().flatten()]
                                + ([ref[1].float().flatten()] if s_next else []))
            err = float((got.double() - ref.double()).abs().max())
            max_err[0] = max(max_err[0], err)
            check(got.dtype == ref.dtype and torch.equal(got, ref),
                  f"K3 {name} ({epi}, residual "
                  f"{None if res is None else res.dtype}, s_next {s_next}) differs from its "
                  f"plain version by {err}")
        del r
        return x, w, kv, bv, acc

    k3.conv_i8.launches = 0
    t0 = time.time()
    for name, batch, grid, c_in, c_out, ksize, stride, dil in K3_EXTRA:
        check_k3(name, batch, grid, c_in, c_out, ksize, stride, dil)
    log(f"K3 bit-equal to its plain version in the int32, int8, float32 and block_out "
        f"(bf16 and float32 residual, with and without the next quant point) epilogues at "
        f"{len(K3_EXTRA)} depth-50 / odd shapes ({time.time() - t0:.1f} s)")

    flush = torch.empty(32 * 1024 * 1024, dtype=torch.int32, device=dev)
    rows, forward = [], {"ops": 0.0, "ms": 0.0, "bound_ms": 0.0, "int_mm_ms": 0.0,
                         "cudnn_bf16_ms": 0.0, "plain_ms": 0.0}
    log(f"K3 at the flagship's block convs, B = {BATCH}, in the epilogues the path runs "
        f"(CUDA events, L2 flushed and a device spin before each launch, median of 25; plain "
        f"version 10; taps: executed / inside the volume, shares of the dense (row, tap) "
        f"pairs):")
    for name, grid, c_in, c_out, ksize, stride, dil, epilogues in K3_SHAPES:
        x, w, kv, bv, acc = check_k3(name, BATCH, grid, c_in, c_out, ksize, stride, dil)
        m, n, kk = acc[..., 0].numel(), c_out, ksize ** 3 * c_in
        plan = k3.tile_plan(tuple(x.shape), tuple(w.shape), stride, dil,
                            torch.cuda.get_device_properties(dev).multi_processor_count)
        a_mat = im2col(torch, x, ksize, stride, dil)
        b_mat = w.reshape(c_out, kk).t()
        lib_out = torch._int_mm(a_mat, b_mat)
        check(torch.equal(lib_out, acc.reshape(m, n)), f"{name}: torch._int_mm differs")
        del lib_out
        x16 = x.to(torch.bfloat16).permute(0, 4, 1, 2, 3)
        w16 = w.to(torch.bfloat16).permute(0, 4, 1, 2, 3).contiguous(
            memory_format=torch.channels_last_3d)
        pad = dil * (ksize - 1) // 2
        lib_ms = time_cuda(torch, lambda: torch._int_mm(a_mat, b_mat), flush=flush)
        bf16_ms = time_cuda(torch, lambda: torch.nn.functional.conv3d(
            x16, w16, stride=stride, padding=pad, dilation=dil), flush=flush)
        ops, in_bytes = k3_work(BATCH, grid, c_in, c_out, ksize, stride, dil)
        inside = ops / (2.0 * m * n * kk)  # the in-volume share of the dense pairs
        for spec, per_fwd in epilogues:
            epi, res_name, with_q, moved = k3_epilogue(spec)
            res = None
            if res_name is not None:
                res = torch.randn(acc.shape, generator=g, device=dev)
                res = res.to(torch.bfloat16) if res_name == "bf16" else res
            s_next = 0.05 if with_q else None
            ms = time_cuda(torch, lambda: k3.conv_i8(x, w, stride, dil, epi, kv, bv, s_next,
                                                     res), flush=flush)
            plain_ms = time_cuda(torch, lambda: k3.epilogue_plain(
                k3.conv_i8_plain(x, w, stride, dil), epi, kv, bv, s_next, res), reps=10,
                flush=flush)
            bound, bound_by = k3_bound_ms(ops, in_bytes, m, n, kk, moved)
            rows.append({"shape": name, "M": m, "N": n, "K": kk, "epilogue": spec,
                         "per_forward": per_fwd, "ops": ops, "dense_ops": 2.0 * m * n * kk,
                         "executed_taps": plan.executed_taps, "in_volume_taps": inside,
                         "bn": plan.bn, "box": plan.box,
                         "ms": ms, "bound_ms": bound, "bound_by": bound_by,
                         "int_mm_ms": lib_ms, "cudnn_bf16_ms": bf16_ms, "plain_ms": plain_ms,
                         "tops": ops / (ms * 1e9)})
            for key in ("ops", "ms", "bound_ms", "int_mm_ms", "cudnn_bf16_ms", "plain_ms"):
                forward[key] += per_fwd * rows[-1][key]
            log(f"  {name:36s} x{per_fwd} {spec:19s} M {m:6d} N {n:3d} K {kk:5d} K3 {ms:.4f} ms "
                f"({rows[-1]['tops']:.0f} TOP/s in-volume; taps {plan.executed_taps:.3f} / "
                f"{inside:.3f}; BN {plan.bn}, box {plan.box}) bound {bound:.4f} ({bound_by}) -> "
                f"{bound / ms:.1%}; _int_mm {lib_ms:.4f}; bf16 cuDNN {bf16_ms:.4f}; plain "
                f"{plain_ms:.3f}")
            del res
        del x, w, acc, a_mat, b_mat, x16, w16
    out["k3_shapes"] = rows
    out["k3_forward"] = forward
    out["k3_max_abs_err"] = max_err[0]
    out["k3_check_launches"] = k3.conv_i8.launches
    log(f"  the 19 block convs of one forward: K3 {forward['ms']:.3f} ms "
        f"({forward['ops'] / (forward['ms'] * 1e9):.0f} TOP/s in-volume), bound "
        f"{forward['bound_ms']:.3f} ({forward['bound_ms'] / forward['ms']:.1%}), _int_mm "
        f"{forward['int_mm_ms']:.3f}, bf16 cuDNN "
        f"{forward['cudnn_bf16_ms']:.3f}, plain {forward['plain_ms']:.2f} ms")
    check(sum(per for *_, eps in K3_SHAPES for _, per in eps) == 19, "K3_SHAPES' launches")
    torch.cuda.empty_cache()

    # ---- the main path: quantize_int8 -> predict_proba ----------------------
    rng = np.random.default_rng(SEED + 60)
    cal = np.stack([make_volume(rng, VOL_SHAPE, label=i % 2, extent_jitter=0.3,
                                center_jitter=0.05) for i in range(4)])
    pred16 = EnsemblePredictor.from_checkpoint_dir(ckpt_dir, batch_size=BATCH)
    pred8 = EnsemblePredictor.from_checkpoint_dir(ckpt_dir, batch_size=BATCH)
    torch.cuda.synchronize()
    t0 = time.time()
    pred8.quantize_int8(cal)
    torch.cuda.synchronize()
    out["calibration_s"] = time.time() - t0
    fg.gather_normalize.launches = 0
    k3.conv_i8.launches = 0
    t0 = time.time()
    p8 = pred8.predict_proba(vols)
    torch.cuda.synchronize()
    out["first_predict_s"] = time.time() - t0
    out["k3_launches"] = k3.conv_i8.launches
    out["k1_launches"] = fg.gather_normalize.launches
    n_chunks = -(-len(vols) // BATCH)
    out["k3_launches_per_batch"] = out["k3_launches"] // n_chunks
    log(f"quantize_int8 (4 calibration volumes, {N_FOLDS} folds: export, folded bf16 forward, "
        f"scales) "
        f"{out['calibration_s']:.2f} s; predict_proba of {len(vols)} volumes (first call) "
        f"{out['first_predict_s']:.2f} s: K3 launches {out['k3_launches']} (expected "
        f"{n_chunks} x 19 x {N_FOLDS}), K1 launches {out['k1_launches']}")
    check(out["k3_launches"] == n_chunks * 19 * N_FOLDS,
          f"int8 serving ran K3 {out['k3_launches']} times")
    check(out["k1_launches"] == n_chunks, f"int8 serving ran K1 {out['k1_launches']} times")
    check(p8.shape == (len(vols), 2) and bool(np.isfinite(p8).all())
          and bool(np.allclose(p8.sum(1), 1.0, atol=1e-5)), "bad int8 probabilities")
    p16 = pred16.predict_proba(vols)
    out["int8_vs_bf16_max_dprob"] = float(np.abs(p8 - p16).max())
    out["int8_vs_bf16_argmax_agreement"] = float((p8.argmax(1) == p16.argmax(1)).mean())
    log(f"int8 vs bf16 ensemble, {len(vols)} volumes: max |dprob| "
        f"{out['int8_vs_bf16_max_dprob']:.4g}, argmax agreement "
        f"{out['int8_vs_bf16_argmax_agreement']:.3f} (bounds 0.1 and 0.75); prob_1 int8 "
        f"{np.round(p8[:, 1], 4).tolist()}")
    check(out["int8_vs_bf16_max_dprob"] <= 0.1 and out["int8_vs_bf16_argmax_agreement"] >= 0.75,
          "int8 ensemble strays from bf16")

    # the card against the host CPU: the same export and scales
    xs = fg.gather_normalize(torch.from_numpy(vols[:INT8_HOST_VOLS, ..., None]).to(dev),
                             torch.arange(INT8_HOST_VOLS, device=dev), torch.bfloat16)
    t0 = time.time()
    with torch.inference_mode():
        card_p = sum(torch.softmax(net(xs).float(), -1) for net in pred8.int8_folds) / N_FOLDS
        hosts = [copy.deepcopy(net).cpu() for net in pred8.int8_folds]
        host_p = sum(torch.softmax(net(xs.cpu()).float(), -1) for net in hosts) / N_FOLDS
        h = pred8.int8_folds[0].stem(xs)
        taps_c, taps_h = [], []
        out_c, _ = pred8.int8_folds[0].blocks_forward(h, taps=taps_c)
        out_h, _ = hosts[0].blocks_forward(h.cpu(), taps=taps_h)
        logit_d = float((pred8.int8_folds[0].head(out_c).cpu() - hosts[0].head(out_h)).abs().max())
    out["host_s"] = time.time() - t0
    out["card_vs_host_max_dprob"] = float((card_p.cpu() - host_p).abs().max())
    same_taps = all(torch.equal(a.cpu(), b) for a, b in zip(taps_c, taps_h))
    log(f"int8 ensemble, card vs host CPU ({INT8_HOST_VOLS} volumes, same export and scales): "
        f"max |dprob| {out['card_vs_host_max_dprob']:.3g} (bound 1e-2); from one card stem "
        f"output, fold 1's {len(taps_c)} quant points bit-equal {same_taps}, block output "
        f"bit-equal {torch.equal(out_c.cpu(), out_h)}, logits max |d| {logit_d:.3g} "
        f"({out['host_s']:.1f} s on the host)")
    check(out["card_vs_host_max_dprob"] <= 1e-2, "int8 card and host ensembles differ")
    check(same_taps and torch.equal(out_c.cpu(), out_h) and logit_d <= 1e-5,
          "int8 blocks differ between the card and the host")
    out["card_vs_host_logits_from_one_stem"] = logit_d
    del hosts, xs, h, out_c, out_h, taps_c, taps_h

    # rates: resident corpus (uint8) at B = 8 and 32, and host volumes
    ds = DeviceDataset(vols[..., None], np.arange(len(vols)) % 2, quantize="uint8")
    rates = {}
    for b in (8, 32):
        plan = [np.asarray(rng.integers(0, len(vols), b), np.int64) for _ in range(4)]
        for name, pred in (("bf16", pred16), ("int8", pred8), ("int8 again", pred8),
                           ("bf16 again", pred16)):
            pred.forward(ds.gather_normalized(plan[0], torch.bfloat16)["image"])
            torch.cuda.synchronize()
            t0 = time.time()
            for i in range(6):
                probs = pred.forward(ds.gather_normalized(plan[i % 4], torch.bfloat16)["image"])
            torch.cuda.synchronize()
            key = f"{name.split()[0]}_b{b}" + ("_2" if "again" in name else "")
            rates[key] = 6 * b / (time.time() - t0)
            check(bool(torch.isfinite(probs).all()), f"resident {name} B={b}: non-finite")
        log(f"resident B={b}: int8 {rates[f'int8_b{b}']:.2f} / {rates[f'int8_b{b}_2']:.2f} "
            f"vols/s, bf16 {rates[f'bf16_b{b}']:.2f} / {rates[f'bf16_b{b}_2']:.2f} vols/s "
            f"(gather + K1 + 5-fold forward, 6 batches, in turns bf16, int8, int8, bf16) on "
            f"{card}")
    out["resident_vols_per_s"] = rates
    serve = {}
    for name, pred in (("int8", pred8), ("bf16", pred16)):
        reps = []
        for _ in range(3):
            t0 = time.time()
            pred.predict_proba(vols)
            reps.append(time.time() - t0)
        serve[name] = len(vols) / statistics.median(reps)
    out["serving_vols_per_s"] = serve
    log(f"predict_proba on {len(vols)} host volumes (chunks 8 + 4, 5 folds, median of 3): "
        f"int8 {serve['int8']:.2f} vols/s, bf16 {serve['bf16']:.2f} vols/s on {card}")

    # the s2d bf16 stem against the fp32 7^3 stem under bf16 autocast
    x8 = ds.gather_normalized(np.arange(BATCH) % len(vols), torch.bfloat16)["image"]
    net, fold = pred8.int8_folds[0], pred16.folds[0]
    with torch.inference_mode():
        s2d_ms = time_cuda(torch, lambda: net.stem(x8), flush=flush)
        x_ncdhw = x8.permute(0, 4, 1, 2, 3)

        def stem_fp32():
            with torch.autocast(x_ncdhw.device.type, dtype=torch.bfloat16):
                return fold.maxpool(torch.relu(fold.bn1(fold.conv1(x_ncdhw))))

        stem7_ms = time_cuda(torch, stem_fp32, flush=flush)
    out["stem_s2d_bf16_ms"], out["stem_7cubed_autocast_ms"] = s2d_ms, stem7_ms
    log(f"stem of one fold at B={BATCH}: s2d bf16 (conv 4^3 over 8 phases + affine + ReLU + "
        f"max pool) {s2d_ms:.3f} ms; the bf16 model's 7^3 stride-2 stem (conv + BN + ReLU + max "
        f"pool, autocast) {stem7_ms:.3f} ms")

    # profile of one int8 batch of 8 (5 folds), split by kind
    with torch.inference_mode(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        pred8.forward(x8)
        torch.cuda.synchronize()
    split = {"K3": 0.0, "stem conv": 0.0, "max pool": 0.0, "quantize and elementwise": 0.0}
    launched = {k: 0 for k in split}
    for e in prof.key_averages():
        key = e.key.lower()
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = device_us(e)
        kind = ("K3" if "conv_i8" in key else "max pool" if "max_pool" in key or "maxpool" in key
                else "stem conv" if any(t in key for t in ("conv", "xmma", "fprop", "cudnn",
                                                           "implicit", "gemm"))
                else "quantize and elementwise")
        launched[kind] += e.count
        split[kind] += us
    total = sum(split.values())
    out["profile_us"] = split
    out["profile_kernels_per_fold"] = {k: v / N_FOLDS for k, v in launched.items()}
    log(f"profile of one int8 batch of {BATCH} (5 folds; device time {total / 1e3:.3f} ms): "
        + ", ".join(f"{k} {v / 1e3:.3f} ms ({v / max(total, 1e-9):.1%})" for k, v in split.items()))
    log(f"device kernels launched a fold: {sum(launched.values()) / N_FOLDS:.1f} ("
        + ", ".join(f"{k} {v / N_FOLDS:.1f}" for k, v in launched.items()) + ")")
    log(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=12,
                                  max_name_column_width=60))
    del ds, x8, pred16, pred8, flush

    # phase 8's trained folds: int8 keeps their held-out AUC. The 8 test
    # subjects give 16 (AD, CN) pairs, so one pair that int8 reorders moves
    # the AUC by 0.0625; 40 more subjects of phase 8's generator (unseen in
    # training) make 576 pairs, where 0.01 is six reordered pairs.
    more_csv, more_mri = make_adni_dir(os.path.join(work, "int8_held_out"), n_per_class=20,
                                       classes=("AD", "CN"), shape=VOL_SHAPE, seed=SEED + 8,
                                       extent_jitter=0.3, center_jitter=0.04, noise=0.25)
    held_out = test_recs + ADNIManifest(more_csv, more_mri, verbose=False).data_dict
    trained = EnsemblePredictor.from_checkpoint_dir(train_ckpt, batch_size=BATCH)
    fp, fp_all = evaluate_records(trained, test_recs), evaluate_records(trained, held_out)
    trained.quantize_int8(np.stack([load_volume(r["MRI"]) for r in tr_val[:4]]))
    q8, q8_all = evaluate_records(trained, test_recs), evaluate_records(trained, held_out)
    out["trained_test_bf16"], out["trained_test_int8"] = fp, q8
    out["trained_held_out_bf16"], out["trained_held_out_int8"] = fp_all, q8_all
    log(f"trained best_fold1..2 (evaluate_records, no sklearn): {len(test_recs)} test subjects "
        f"bf16 AUC {fp['AUC']:.4f} ACC {fp['ACC']:.4f}, int8 AUC {q8['AUC']:.4f} ACC "
        f"{q8['ACC']:.4f}; {len(held_out)} held-out subjects bf16 AUC {fp_all['AUC']:.4f} ACC "
        f"{fp_all['ACC']:.4f}, int8 AUC {q8_all['AUC']:.4f} ACC {q8_all['ACC']:.4f} (bound "
        f"|dAUC| <= 0.01 on the {len(held_out)})")
    check(abs(q8_all["AUC"] - fp_all["AUC"]) <= 0.01,
          f"int8 held-out AUC {q8_all} drifted from bf16 {fp_all}")
    return out


def profile_split(torch, prof, n_steps):
    """(device ms, device kernels and copies) a step from a torch.profiler
    run of `n_steps` steps."""
    rows = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    return (sum(device_us(e) for e in rows) / 1e3 / n_steps,
            sum(e.count for e in rows) / n_steps)


def densenet_phase(torch, dev, card, work, train_csv, train_mri, tr_val, test_recs):
    """Phase 12: the dilated DenseNet-3D at the TPU package's full width,
    trained on the card through cli.train_densenet."""
    from multimodal_ad_tpu_torch.cli import train_densenet as cli_dense
    from multimodal_ad_tpu_torch.data.device_cache import DeviceDataset, DeviceEpochIterator
    from multimodal_ad_tpu_torch.data.pipeline import load_volume
    from multimodal_ad_tpu_torch.models.densenet import DilatedDenseNet
    from multimodal_ad_tpu_torch.ops import fused_gather as fg
    from multimodal_ad_tpu_torch.train import checkpoint as ckpt
    from multimodal_ad_tpu_torch.train import loop

    log(f"== 12. DenseNet-3D training: growth 16, blocks 6/12/24/16, dilations 1/1/2/4, 64 "
        f"initial features, compression 0.5, dropout 0.2, bf16 autocast, 91x109x91, batch "
        f"{BATCH}")
    out = {}
    ds = DeviceDataset(np.stack([load_volume(r["MRI"]) for r in tr_val])[..., None],
                       np.array([r["label"] for r in tr_val]), store_dtype=np.float32)
    cw = torch.tensor([0.5, 0.5], device=dev)

    def fresh_state(seed):
        m = DilatedDenseNet(compute_dtype=torch.bfloat16,
                            generator=torch.Generator().manual_seed(seed)).to(dev)
        return loop.create_train_state(m, loop.make_epoch_schedule(1e-3, 20),
                                       dropout_seed=seed)

    # one fixed batch, no augmentation: the weighted CE must fall; the first
    # step carries cuDNN's autotune of the 58 layers' convolutions
    fixed = next(iter(DeviceEpochIterator(ds, np.arange(BATCH), BATCH)))
    state = fresh_state(SEED + 41)
    out["params"] = sum(p.numel() for p in state.model.parameters())
    losses, walls = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(8):
        torch.cuda.synchronize()
        t0 = time.time()
        losses.append(float(loop.train_step(state, fixed, cw)[0]))
        walls.append(time.time() - t0)
    out["first_step_s"] = walls[0]
    out["autotune_s"] = walls[0] - statistics.median(walls[2:])
    log(f"{out['params']} parameters; fixed batch, 8 steps: weighted CE "
        f"{[round(v, 4) for v in losses]}")
    log(f"first train step {walls[0]:.2f} s against {statistics.median(walls[2:]) * 1e3:.1f} ms "
        f"later: cuDNN autotune about {out['autotune_s']:.2f} s")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"DenseNet weighted CE did not fall on a fixed batch: {losses}")
    del state

    # the main path: cli.train_densenet on the card, as phase 8 trains the ResNet
    dense_ckpt = os.path.join(work, "densenet_ckpt")
    argv = [f"label_file={train_csv}", f"mri_dir={train_mri}", "compute_dtype=bfloat16",
            f"batch_size={BATCH}", "hbm_cache=true", "augment=true", "precise_bn=true",
            "normalizer=scale_intensity", "n_splits=2", f"num_epochs={TRAIN_EPOCHS}",
            "lr=1e-3", "dropout_rate=0.2", f"checkpoint_dir={dense_ckpt}", "--device", "cuda"]
    fg.gather_normalize.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    results = cli_dense.main(argv)
    torch.cuda.synchronize()
    out["cli_s"] = time.time() - t0
    out["k1_launches"] = fg.gather_normalize.launches
    out["cli_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    per_epoch = 3 * (-(-(len(tr_val) // 2) // BATCH))
    expect = 2 * TRAIN_EPOCHS * per_epoch + 2 * (-(-len(test_recs) // BATCH))
    log(f"cli.train_densenet: {out['cli_s']:.1f} s (dataset upload, 2 folds x {TRAIN_EPOCHS} "
        f"epochs, checkpoints, test); K1 launches {out['k1_launches']} (expected {expect}); "
        f"peak memory {out['cli_peak_gb']:.2f} GB")
    check(out["k1_launches"] == expect,
          f"DenseNet training ran K1 {out['k1_launches']} times, expected {expect}")
    with open(os.path.join(dense_ckpt, "cv_results.csv")) as f:
        rows = list(csv.reader(f))
    check(len(rows) == 1 + 2 * TRAIN_EPOCHS and all(len(r) == 19 for r in rows),
          f"cv_results.csv is {len(rows)} rows of {len(rows[0])} columns")
    il, vl = rows[0].index("tr_loss"), rows[0].index("vl_loss")
    cv_losses = [(float(r[il]), float(r[vl])) for r in rows[1:]]
    check(bool(np.isfinite(cv_losses).all()), f"non-finite CV losses {cv_losses}")
    log(f"  cv_results.csv (fold, epoch, tr_loss, vl_loss, lr): "
        f"{[(r[0], r[1], r[il], r[vl], r[-1]) for r in rows[1:]]}")
    for k in (1, 2):
        for name in (f"best_fold{k}", f"model_fold{k}_final"):
            check(os.path.isfile(os.path.join(dense_ckpt, name, "model.pt"))
                  and os.path.isfile(os.path.join(dense_ckpt, name, ckpt.TRAIN_STATE_FILE)),
                  f"checkpoint {name} missing")
    check(all(np.isfinite(results["avg"][k]) for k in ("ACC", "AUC", "SPE", "MCC")),
          f"test metrics {results['avg']}")
    out["test_avg"] = results["avg"]
    log("  test metrics (fold mean): " + ", ".join(f"{k} {v:.4f}"
                                                   for k, v in results["avg"].items()))

    # the rate on the resident path: gather + K1 + augmentation + step
    state = fresh_state(SEED + 42)
    it = DeviceEpochIterator(ds, np.arange(ds.n), BATCH, shuffle=True, seed=SEED, augment=True)
    batches = (bt for _ in range(4) for bt in it)  # 16 steps, 4 epochs of 4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events, t_wall = [], None
    for step_i in range(16):
        if step_i == 2:
            torch.cuda.synchronize()
            t_wall = time.time()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        loop.train_step(state, next(batches), cw)
        b.record()
        if step_i >= 2:
            events.append((a, b))
    torch.cuda.synchronize()
    wall = time.time() - t_wall
    out["step_ms"] = statistics.median(a.elapsed_time(b) for a, b in events)
    out["vols_per_s"] = BATCH / (out["step_ms"] / 1e3)
    out["vols_per_s_pipelined"] = len(events) * BATCH / wall
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"training: {out['vols_per_s']:.2f} vols/s (resident, augmented, B={BATCH}: median "
        f"step {out['step_ms']:.2f} ms of {len(events)} after 2 of warm-up, CUDA events), "
        f"{out['vols_per_s_pipelined']:.2f} vols/s over the {len(events)} steps back to back "
        f"(host clock) on {card}; peak memory {out['peak_gb']:.2f} GB")

    # device time against wall time over 4 steps back to back: the idle share
    prof_batches = [bt for bt in it]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for bt in prof_batches:
            loop.train_step(state, bt, cw)
        torch.cuda.synchronize()
        prof_wall_ms = 1e3 * (time.time() - t0) / len(prof_batches)
    dev_ms, launches = profile_split(torch, prof, len(prof_batches))
    depthwise_us = sum(device_us(e) for e in prof.key_averages()
                       if "depthwise" in e.key.lower())
    out["device_ms_per_step"], out["launches_per_step"] = dev_ms, launches
    out["profiled_wall_ms_per_step"] = prof_wall_ms
    out["idle_share"] = 1 - dev_ms / prof_wall_ms
    out["depthwise_share"] = depthwise_us / 1e3 / len(prof_batches) / dev_ms
    log(f"profile of {len(prof_batches)} steps: {dev_ms:.2f} ms of device time a step against "
        f"{prof_wall_ms:.2f} ms of wall time (profiler on): the card idles "
        f"{out['idle_share']:.1%}; {launches:.0f} device kernels and copies a step; kernels "
        f"named depthwise {out['depthwise_share']:.1%} of the device time")
    log(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=15,
                                  max_name_column_width=70))
    del state, it, ds, fixed, prof_batches

    rows = card_vs_host_steps(
        torch, dev, lambda: DilatedDenseNet(growth=8, block_config=(2, 3, 2),
                                            dilations=(1, 2, 4), init_features=16,
                                            dropout_rate=0.0, compute_dtype=torch.float32,
                                            generator=torch.Generator().manual_seed(SEED)),
        (32, 38, 32))
    log_card_vs_host_steps(rows, "DenseNet (growth 8, blocks 2/3/2) at 32x38x32")
    return out


ENCODER_TAPS = ["(8, 23, 28, 23, 64)", "(8, 12, 14, 12, 128)", "(8, 12, 14, 12, 256)",
                "(8, 12, 14, 12, 512)"]  # ResNet-18 stage outputs at 91x109x91, B = 8


def encoder_phase(torch, dev, card, work, ext_records):
    """Phase 13: ResNet-18 encoder features (heads none and pool) and the
    seg head on the card."""
    from multimodal_ad_tpu_torch.eval.features import (deterministic_cudnn,
                                                      extract_encoder_features)
    from multimodal_ad_tpu_torch.data.pipeline import load_volume
    from multimodal_ad_tpu_torch.models.resnet3d import ResNet3D
    from multimodal_ad_tpu_torch.ops import fused_gather as fg
    from multimodal_ad_tpu_torch.ops.normalize import scale_intensity

    log(f"== 13. encoder features: ResNet-18 B float32 with seeded weights, heads none and "
        f"pool, {len(ext_records)} subjects (phase 7's test split), batch {BATCH}; the seg head")
    out = {}
    n = len(ext_records)
    for head, width in (("none", 512 * 12 * 14 * 12), ("pool", 512)):
        fg.gather_normalize.launches = 0
        before = reads_now()
        t0 = time.time()
        f, s = extract_encoder_features(ext_records, os.path.join(work, f"encoder_{head}"),
                                        depth=18, global_pool=head == "pool",
                                        batch_size=BATCH, seed=SEED, device=dev)
        wall = time.time() - t0
        reads, k1 = reads_since(before), fg.gather_normalize.launches
        with open(f) as fh:
            rows = list(csv.reader(fh))
        with open(s) as sh:
            shapes = list(csv.reader(sh))
        check(len(rows) == 1 + n and all(len(r) == 2 + width for r in rows),
              f"adni_features.csv (head {head}) is {len(rows)} rows of {len(rows[0])} columns")
        check(rows[0][-1] == "label" and [r[0] for r in rows[1:]] == [r["Subject"]
                                                                       for r in ext_records],
              f"adni_features.csv (head {head}) header or subjects")
        vals = np.asarray([r[1:-1] for r in rows[1:]], np.float64)
        check(bool(np.isfinite(vals).all()) and {r[-1] for r in rows[1:]} <= {"0", "1"},
              f"head {head}: non-finite features or bad labels")
        check(shapes == [["module", "output_shape"]] + [["stage_out", t] for t in ENCODER_TAPS],
              f"feature_map_shapes.csv {shapes}")
        check(k1 == -(-n // BATCH), f"head {head}: K1 launched {k1} times")
        check_native_reads(reads, f"encoder extraction (head {head})")
        out[head] = {"wall_s": wall, "subjects_per_s": n / wall, "k1_launches": k1,
                     "reads": reads, "columns": len(rows[0])}
        log(f"extract_encoder_features head {head}: {n} x {len(rows[0])} columns, finite, "
            f"feature_map_shapes.csv as expected; {wall:.2f} s -> {n / wall:.3f} subjects/s "
            f"on {card} (model init and the first call included); K1 launches {k1}; decodes "
            f"{reads}")
    out["k1_launches"] = out["none"]["k1_launches"] + out["pool"]["k1_launches"]

    # the split of a head-none batch of 8: forward (CUDA events) against CSV writing
    host = torch.from_numpy(np.stack([load_volume(r["MRI"]) for r in ext_records[:BATCH]])
                            [..., None])
    model = ResNet3D(depth=18, head="none", compute_dtype=torch.float32,
                     generator=torch.Generator().manual_seed(SEED)).eval().to(dev)
    x = scale_intensity(host.to(dev))
    with torch.inference_mode(), deterministic_cudnn():
        fwd_ms, _ = step_events(torch, lambda: model(x, return_taps=True), 3, warmup=1)
        flat = model(x).reshape(BATCH, -1).cpu().numpy()
    t0 = time.time()
    with open(os.path.join(work, "encoder_split.csv"), "w", newline="") as fh:
        w = csv.writer(fh)
        for i in range(BATCH):
            w.writerow([f"S{i}"] + flat[i].tolist() + [0])
    csv_ms = 1e3 * (time.time() - t0)
    out["split_ms"] = {"forward_ms": fwd_ms, "csv_write_ms": csv_ms}
    log(f"split of a head-none batch of {BATCH}: forward {fwd_ms:.2f} ms (CUDA events, "
        f"deterministic cuDNN, median of 3), CSV rows {csv_ms:.1f} ms (host clock)")
    del model, x

    # the card against the host CPU: ResNet-10 head none on one full-size volume
    narrow = ResNet3D(depth=10, head="none", compute_dtype=torch.float32,
                      generator=torch.Generator().manual_seed(SEED)).eval()
    x1 = scale_intensity(host[:1])
    with torch.inference_mode():
        h = narrow(x1)
        with deterministic_cudnn():
            c = narrow.to(dev)(x1.to(dev)).cpu()
    out["resnet10_card_vs_host"] = float((c - h).abs().max())
    log(f"ResNet-10 head none, card vs host CPU (fp32, TF32 off), one volume: max |d| "
        f"{out['resnet10_card_vs_host']:.3g} (rtol = atol = 1e-3)")
    check(torch.allclose(c, h, rtol=1e-3, atol=1e-3),
          f"card and host encoder features differ by {out['resnet10_card_vs_host']}")

    # the seg head: ResNet-18 head seg at 91x109x91, B = 2, fp32
    seg = ResNet3D(depth=18, head="seg", num_seg_classes=2, compute_dtype=torch.float32,
                   generator=torch.Generator().manual_seed(SEED + 1)).eval()
    x2 = scale_intensity(host[:2])
    with torch.inference_mode():
        h = seg(x2)
        with deterministic_cudnn():
            c = seg.to(dev)(x2.to(dev)).cpu()
    spread = float(h.abs().max())
    out["seg_card_vs_host"] = float((c - h).abs().max())
    out["seg_shape"] = list(c.shape)
    log(f"ResNet-18 head seg (2 classes), B = 2, fp32: output {tuple(c.shape)}, card vs host "
        f"CPU max |d| {out['seg_card_vs_host']:.3g} against a spread of {spread:.4g} (bound "
        f"1e-3 of the spread)")
    check(tuple(c.shape) == (2, 24, 28, 24, 2) and bool(torch.isfinite(c).all()),
          f"seg output {tuple(c.shape)}")
    check(out["seg_card_vs_host"] <= 1e-3 * max(spread, 1e-6),
          f"card and host seg outputs differ by {out['seg_card_vs_host']}")
    return out


def mshyper_and_tools_phase(torch, dev, card, work, atlas_nii, atlas_lut):
    """Phase 14: MSHyper forward and backward on the card against the host,
    its step time; cli.pvalue and cli.roi_visualize on this machine."""
    import contextlib
    import io

    from multimodal_ad_tpu_torch.cli import pvalue as cli_pvalue
    from multimodal_ad_tpu_torch.cli import roi_visualize as cli_roi
    from multimodal_ad_tpu_torch.models.hypergraph import MSHyperModel

    log("== 14. MSHyper (d_model 64, windows (4, 4), inner size 3, attention; seq 96 -> 24, "
        "7 channels, batch 32), cli.pvalue, cli.roi_visualize")
    out = {}
    torch.manual_seed(SEED)
    host = MSHyperModel(96, 24, 7)
    model = MSHyperModel(96, 24, 7).to(dev)
    model.load_state_dict(host.state_dict())
    g = torch.Generator().manual_seed(SEED + 5)
    series = torch.cumsum(torch.randn((32, 120, 7), generator=g), dim=1)
    x, y = series[:, :96], series[:, 96:]
    grads = {}
    for name, m, d in (("host", host, "cpu"), ("card", model, dev)):
        pred = m(x.to(d))
        ((pred - y.to(d)) ** 2).mean().backward()
        grads[name] = [pred.detach().cpu()] + [p.grad.cpu() for p in m.parameters()]
    (c_out, *c_grads), (h_out, *h_grads) = grads["card"], grads["host"]
    out_rel = float((c_out - h_out).abs().max()) / float(h_out.abs().max())
    g_scale = max(float(g.abs().max()) for g in h_grads)
    grad_rel = max(float((a - b).abs().max()) for a, b in zip(c_grads, h_grads)) / g_scale
    own = {n: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
           for (n, _), a, b in zip(host.named_parameters(), c_grads, h_grads)}
    worst = max(own, key=own.get)
    log(f"  largest |d| against a gradient's own magnitude: {worst} {own[worst]:.3g} (its "
        f"magnitude {float(h_grads[list(own).index(worst)].abs().max()):.3g})")
    out["card_vs_host_rel"] = {"output": out_rel, "gradients": grad_rel}
    log(f"forward and the gradients of one backward, card vs host CPU (fp32, TF32 off): output "
        f"max |d| {out_rel:.3g} of its largest magnitude, the {len(h_grads)} gradients max |d| "
        f"{grad_rel:.3g} of the largest gradient (bounds 1e-4; a tensor alone is no scale: the "
        f"attention key's bias gets a gradient of ~1e-10 that is 0 in exact arithmetic)")
    check(out_rel <= 1e-4 and grad_rel <= 1e-4,
          f"MSHyper card and host differ: output {out_rel}, gradients {grad_rel}")
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    xd, yd = x.to(dev), y.to(dev)
    losses = []

    def step():
        opt.zero_grad(set_to_none=True)
        loss = ((model(xd) - yd) ** 2).mean()
        loss.backward()
        opt.step()
        losses.append(loss.detach())

    out["step_ms"], _ = step_events(torch, step, 20, warmup=3)
    losses = [float(v) for v in losses]
    out["windows_per_s"] = 32 / (out["step_ms"] / 1e3)
    log(f"train step (forward + backward + Adam), B = 32: median {out['step_ms']:.3f} ms of 20 "
        f"after 3 of warm-up (CUDA events) -> {out['windows_per_s']:.1f} windows/s on {card}; "
        f"MSE {losses[0]:.4f} -> {losses[-1]:.4f}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"MSHyper loss did not fall: {losses[0]} -> {losses[-1]}")

    def run(main, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(argv)
        return buf.getvalue().splitlines()

    lines = run(cli_pvalue.main, ["--a", "0.9152", "0.8830", "0.9218", "0.9340", "0.9418",
                                  "--b", "0.9867", "0.9767", "0.9806", "0.9845", "0.9751"])
    log("cli.pvalue: " + " | ".join(lines))
    check(len(lines) == 2 and lines[0].startswith("paired t-test:")
          and lines[1].startswith("wilcoxon:"), f"cli.pvalue printed {lines}")
    html = os.path.join(work, "atlas_viewer.html")
    lines = run(cli_roi.main, ["--atlas", atlas_nii, "--atlas-json", atlas_lut,
                               "--query-voxel", "45", "54", "45",
                               "--query-world", "-30", "-20", "10", "--html", html])
    log("cli.roi_visualize: " + " | ".join(lines))
    check(len(lines) == 3 and lines[0].startswith("voxel (45, 54, 45) -> ")
          and lines[1].startswith("world (-30.0, -20.0, 10.0) -> ")
          and os.path.getsize(html) > VOX, f"cli.roi_visualize printed {lines}")
    out["html_bytes"] = os.path.getsize(html)
    return out


TAB_CLASSES = ["CN", "SMCI", "PMCI", "AD"]
TAB_ROWS = 580  # the 0.2 test split leaves 464 training rows
TAB_FEATURES = 156  # 6 of them string categoricals, after 14 leading columns
TAB_CATEGORICAL = 6
TAB_BLANK = 0.073  # share of the numeric feature cells left blank
TAB_SPARSE_BLANK = 0.95  # two columns this empty
TAB_VIEWS, TAB_BUCKET, TAB_QUERIES = 8, 512, 116  # the classifier's forward


def icl_forward_flops(cfg, views, n_ctx, n_qry):
    """Multiply-add FLOPs (2 per MAC) of one ICLTransformer forward over
    `views` tasks: feature and categorical projections of every token, per
    layer the q/k/v/out projections, scores, the weighted sum and the MLP,
    and the class head on the queries; elementwise work is not counted."""
    t, d, f, ff = n_ctx + n_qry, cfg.d_model, cfg.max_features, cfg.d_ff
    proj = 2 * t * f * d * (2 if cfg.cat_input else 1)
    layer = 2 * t * d * d * 4 + 2 * 2 * t * t * d + 2 * 2 * t * d * ff
    head = 2 * n_qry * d * cfg.max_classes
    return views * (proj + cfg.n_layers * layer + head)


class _PathTimer:
    """Wall time spent inside chosen callables (a device sync closes each
    forward), and their call counts; the originals come back on exit."""

    def __init__(self, torch, targets):
        self.torch, self.targets = torch, targets  # {label: (owner, attr, sync)}
        self.seconds = {k: 0.0 for k in targets}
        self.calls = {k: 0 for k in targets}

    def __enter__(self):
        self.saved = {}
        for label, (owner, attr, sync) in self.targets.items():
            orig = getattr(owner, attr)
            self.saved[label] = orig

            def wrapped(*a, _orig=orig, _label=label, _sync=sync, **kw):
                t0 = time.perf_counter()
                out = _orig(*a, **kw)
                if _sync:
                    self.torch.cuda.synchronize()
                self.seconds[_label] += time.perf_counter() - t0
                self.calls[_label] += 1
                return out
            setattr(owner, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for label, (owner, attr, _) in self.targets.items():
            setattr(owner, attr, self.saved[label])


def make_clinical_table(path):
    """The phase's synthetic clinical table: make_table's draws at the
    reference's shape, then seeded blanks (7.3 % of the numeric feature
    cells, two columns 95 % blank), written as CSV."""
    from multimodal_ad_tpu_torch.data.synthetic import make_table
    from multimodal_ad_tpu_torch.data.tabular import write_table

    cols = make_table(n=TAB_ROWS, n_features=TAB_FEATURES, classes=tuple(TAB_CLASSES),
                      seed=SEED, n_categorical=TAB_CATEGORICAL)
    rng = np.random.default_rng(SEED + 15)
    numeric = [c for c in cols if c.startswith("feat")]
    sparse = numeric[:2]
    # the rest blank at the rate that brings the whole to TAB_BLANK
    rate = (TAB_BLANK * len(numeric) - TAB_SPARSE_BLANK * len(sparse)) / (
        len(numeric) - len(sparse))
    blanks = 0
    for c in numeric:
        v = cols[c].astype(np.float32)
        hole = rng.random(TAB_ROWS) < (TAB_SPARSE_BLANK if c in sparse else rate)
        v[hole] = np.nan
        cols[c] = v
        blanks += int(hole.sum())
    write_table(path, cols)
    return blanks / (len(numeric) * TAB_ROWS)


def tabular_phase(torch, dev, card, work):
    """Phase 15: tabular in-context inference (the classifier, regressor and
    embedder assets at full width) on the card against the host."""
    from multimodal_ad_tpu_torch.data.tabular import load_adni_table
    from multimodal_ad_tpu_torch.tabular import pipeline
    from multimodal_ad_tpu_torch.tabular.estimator import train_test_split
    from multimodal_ad_tpu_torch.tabular.flax_msgpack import read_state, tree_leaves
    from multimodal_ad_tpu_torch.tabular.icl import (ICLClassifier, ICLConfig,
                                                     ICLTransformer, _zscore_by_ctx,
                                                     attention_mask, default_asset_path,
                                                     masked_attention)
    from multimodal_ad_tpu_torch.tabular.embedding import embedder_asset_path
    from multimodal_ad_tpu_torch.tabular.icl_regression import default_reg_asset_path
    from multimodal_ad_tpu_torch.tabular.regression import ICLRegressor
    from multimodal_ad_tpu_torch.train.metrics import calculate_metrics_multiclass
    from multimodal_ad_tpu_torch.utils.torch_weights import icl_state_dict_from_flax

    import torch.nn.functional as F

    # the card's machine has none of these; hold the path to that here too
    for name in ("sklearn", "pandas", "flax", "msgpack"):
        sys.modules[name] = None
    out = {}
    t_phase = time.time()
    log("== 15. tabular in-context inference")
    tab_dir = os.path.join(work, "tabular")
    os.makedirs(tab_dir, exist_ok=True)
    table = os.path.join(tab_dir, "ADNI_Tabel.csv")
    blank = make_clinical_table(table)
    log(f"table: {TAB_ROWS} rows, 14 leading columns + {TAB_FEATURES} features "
        f"({TAB_CATEGORICAL} string categoricals), classes {TAB_CLASSES}; "
        f"{blank:.2%} of the numeric feature cells blank, two columns "
        f"{TAB_SPARSE_BLANK:.0%} blank")

    # (a) the assets
    trees = {}
    for label, path, leaves, n_params in (
            ("classifier", default_asset_path(), 107, 4_892_426),
            ("embedder", embedder_asset_path(), 107, 4_892_426),
            ("regression", default_reg_asset_path(), 105, 4_797_472)):
        t0 = time.perf_counter()
        tree = read_state(path)
        s = time.perf_counter() - t0
        lv = tree_leaves(tree)
        count = sum(v.size for _, v in lv)
        dtypes = sorted({str(v.dtype) for _, v in lv})
        log(f"  (a) {label:10s} {os.path.basename(path)}: {len(lv)} leaves, "
            f"{count:,} parameters, {dtypes}, read in {s * 1e3:.1f} ms")
        check(len(lv) == leaves and count == n_params,
              f"{label} asset: {len(lv)} leaves / {count} parameters")
        out[f"asset_{label}_read_ms"] = s * 1e3
        trees[label] = tree

    # (b) the full-width forward, card against host
    cfg = ICLConfig()
    sd = icl_state_dict_from_flax(trees["classifier"], cfg)
    nets = {}
    for where in ("cpu", "card"):
        net = ICLTransformer(cfg).eval()
        net.load_state_dict(sd)
        nets[where] = net.to("cpu" if where == "cpu" else dev)
    g = np.random.default_rng(SEED + 16)
    n_test = math.ceil(0.2 * TAB_ROWS)
    n_valid = min(TAB_ROWS - n_test, TAB_BUCKET)  # the training rows of the split
    x_ctx = g.normal(size=(TAB_VIEWS, TAB_BUCKET, cfg.max_features)).astype(np.float32)
    x_ctx[:, n_valid:] = 0
    x_ctx[:, :, TAB_FEATURES:] = 0  # the padded feature columns
    y_ctx = g.integers(0, 4, (TAB_VIEWS, TAB_BUCKET))
    mask = np.zeros((TAB_VIEWS, TAB_BUCKET), np.float32)
    mask[:, :n_valid] = 1
    x_qry = g.normal(size=(TAB_VIEWS, TAB_QUERIES, cfg.max_features)).astype(np.float32)
    x_qry[:, :, TAB_FEATURES:] = 0
    cat = np.zeros((TAB_VIEWS, cfg.max_features), np.float32)
    cat[:, [3, 40, 77, 100, 121, 150]] = 1.0
    host_in = [torch.from_numpy(a) for a in (x_ctx, y_ctx, mask, x_qry, cat)]
    card_in = [a.to(dev) for a in host_in]

    def fwd(net, ins):
        xc, yc, m, xq, c = ins
        xc, xq = _zscore_by_ctx(xc, xq, m)
        return net(xc, yc, m, xq, c, return_penult=True)

    with torch.inference_mode():
        ref = fwd(nets["cpu"], host_in)
        got = [t.cpu() for t in fwd(nets["card"], card_in)]
    errs = {}
    for name, a, b in zip(("logits", "qry_emb", "ctx_emb", "h_penult"), got, ref):
        spread = float(b.abs().max())
        errs[name] = float((a - b).abs().max())
        log(f"  (b) {name:8s} {tuple(b.shape)} card vs host max |d| {errs[name]:.3g}, "
            f"spread {spread:.4g} (bound 1e-4 of the spread)")
        check(errs[name] <= 1e-4 * spread, f"full-width forward {name}: {errs[name]}")
    out["forward_card_vs_host"] = errs
    flops = icl_forward_flops(cfg, TAB_VIEWS, TAB_BUCKET, TAB_QUERIES)
    bound_ms = flops / F32_OPS_PER_S * 1e3
    with torch.inference_mode():
        fwd_ms = time_cuda(torch, lambda: fwd(nets["card"], card_in))
    log(f"  (b) forward V={TAB_VIEWS}, N={TAB_BUCKET}, M={TAB_QUERIES}: {fwd_ms:.3f} ms "
        f"(CUDA events, median of 25) against {flops / 1e9:.2f} GFLOP / 67 TFLOP/s "
        f"= {bound_ms:.3f} ms: {bound_ms / fwd_ms:.1%} of the fp32 bound")
    out.update(forward_ms=fwd_ms, forward_gflop=flops / 1e9, forward_bound_ms=bound_ms)
    # the attention alone, explicit (the port's) against SDPA, at one layer's shape
    blk = nets["card"].blocks[0]
    with torch.inference_mode():
        h = torch.randn((TAB_VIEWS, TAB_BUCKET + TAB_QUERIES, cfg.d_model), device=dev)
        q, k, v = blk.attn.heads(h)
        allowed = attention_mask(card_in[2], TAB_QUERIES)
        explicit = masked_attention(q, k, v, allowed)
        sdpa = F.scaled_dot_product_attention(q, k, v, attn_mask=allowed[:, None], scale=1.0)
        att_err = float((explicit - sdpa).abs().max())
        att_ms = time_cuda(torch, lambda: masked_attention(q, k, v, allowed))
        sdpa_ms = time_cuda(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=allowed[:, None], scale=1.0))
    log(f"  (b) attention of one layer (8 heads, T={TAB_BUCKET + TAB_QUERIES}): explicit "
        f"{att_ms:.4f} ms, SDPA {sdpa_ms:.4f} ms (comparison only; max |d| {att_err:.3g})")
    out.update(attention_ms=att_ms, attention_sdpa_ms=sdpa_ms, attention_sdpa_max_d=att_err)
    with torch.inference_mode():
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fwd(nets["card"], card_in)
            torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if device_us(e) > 0]
    n_kernels = sum(e.count for e in rows)
    dev_ms = sum(device_us(e) for e in rows) / 1e3
    log(f"  (b) one forward launches {n_kernels} device kernels, {dev_ms:.3f} ms of device "
        "time; by kernel:")
    for e in sorted(rows, key=device_us, reverse=True)[:8]:
        log(f"      {device_us(e) / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}")
    out.update(forward_kernels=n_kernels, forward_device_ms=dev_ms)
    del nets, card_in

    # (c) ICLClassifier() with every default on the 464/116 split
    X, y, _ = load_adni_table(table, label_col="Group", classes=TAB_CLASSES, start_col=14)
    X_tr, X_te, y_tr, y_te = train_test_split(X, y, test_size=0.2, random_state=42,
                                              stratify=y)
    log(f"  (c) X {X.shape}, {np.isnan(X).mean():.2%} NaN; split {len(X_tr)} / {len(X_te)}")
    t0 = time.perf_counter()
    clf = ICLClassifier().fit(X_tr, y_tr)
    fit_s = time.perf_counter() - t0
    proba = clf.predict_proba(X_te)
    pred_ms = statistics.median(
        _timed_ms(lambda: clf.predict_proba(X_te)) for _ in range(5))
    m = calculate_metrics_multiclass(y_te, clf.classes_[proba.argmax(1)], proba)
    t0 = time.perf_counter()
    host = ICLClassifier(device="cpu").fit(X_tr, y_tr)
    host_fit_s = time.perf_counter() - t0
    hproba = host.predict_proba(X_te)
    d_proba = float(np.abs(proba - hproba).max())
    top2 = np.sort(hproba, 1)
    clear = (top2[:, -1] - top2[:, -2]) > 1e-3
    same = (proba.argmax(1) == hproba.argmax(1))
    log(f"  (c) fit {fit_s:.2f} s (the asset read and uploaded once included), "
        f"predict_proba {pred_ms:.2f} ms for {len(X_te)} rows, preprocess_ "
        f"{clf.preprocess_!r}; test ACC {m['ACC']:.4f}, macro AUC {m['AUC']:.4f}")
    log(f"  (c) host CPU fit {host_fit_s:.2f} s, preprocess_ {host.preprocess_!r}; "
        f"card vs host probabilities max |d| {d_proba:.3g} (bound 1e-4); predictions "
        f"equal on {int(same[clear].sum())} of the {int(clear.sum())} rows whose top two "
        f"differ by more than 1e-3 ({int(same.sum())} of {len(same)} in all)")
    check(clf.preprocess_ == host.preprocess_, "classifier preprocess_ card != host")
    check(d_proba <= 1e-4, f"classifier card vs host {d_proba}")
    check(bool(same[clear].all()), "classifier predictions differ on a clear row")
    check(np.isfinite(m["AUC"]), "classifier AUC not finite")
    out.update(clf_fit_s=fit_s, clf_predict_ms=pred_ms, clf_preprocess=clf.preprocess_,
               clf_test_acc=m["ACC"], clf_test_auc=m["AUC"], clf_host_fit_s=host_fit_s,
               clf_card_vs_host=d_proba)

    # (d) ICLRegressor on a target drawn from the same table
    # y = 0.8 a - 0.5 b + 0.3 a c + noise over three numeric feature columns
    # (their blanks at the column median), which stay in X with their blanks
    g = np.random.default_rng(SEED + 17)
    source_cols = [j for j in range(X.shape[1]) if np.isnan(X[:, j]).mean() < 0.5
                   and len(np.unique(X[np.isfinite(X[:, j]), j])) > 10][:3]
    ya, yb, yc = (np.where(np.isnan(X[:, j]), np.nanmedian(X[:, j]), X[:, j])
                  .astype(np.float64) for j in source_cols)
    target = 0.8 * ya - 0.5 * yb + 0.3 * ya * yc + 0.2 * g.normal(size=len(X))
    tr, te = train_test_split(np.arange(len(X)), test_size=0.2, random_state=42)
    Xr_tr, Xr_te = X[tr], X[te]
    t0 = time.perf_counter()
    reg = ICLRegressor().fit(Xr_tr, target[tr])
    reg_fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    card_pred = {k: reg.predict(Xr_te, k) for k in ("mean", "median", "quantiles")}
    reg_pred_ms = (time.perf_counter() - t0) / 3 * 1e3
    hreg = ICLRegressor(device="cpu").fit(Xr_tr, target[tr])
    spread = float(target.max() - target.min())
    d_reg = {}
    for k, v in card_pred.items():
        hv = hreg.predict(Xr_te, k)
        d_reg[k] = float(np.abs(np.asarray(v) - np.asarray(hv)).max())
    r2 = 1 - np.mean((card_pred["mean"] - target[te]) ** 2) / np.var(target[te])
    log(f"  (d) regressor on y = 0.8 a - 0.5 b + 0.3 a c + noise (a, b, c: feature "
        f"columns {source_cols}): fit {reg_fit_s:.2f} s, predict {reg_pred_ms:.2f} ms a call, "
        f"preprocess_ {reg.preprocess_!r} (host {hreg.preprocess_!r}), test R^2 {r2:.4f}; "
        f"card vs host max |d| {d_reg} against a target spread of {spread:.4g} "
        "(bound 1e-4 of it)")
    check(reg.preprocess_ == hreg.preprocess_, "regressor preprocess_ card != host")
    for k, v in d_reg.items():
        check(v <= 1e-4 * spread, f"regressor {k} card vs host {v}")
    out.update(reg_fit_s=reg_fit_s, reg_predict_ms=reg_pred_ms, reg_test_r2=float(r2),
               reg_card_vs_host=d_reg, reg_target_spread=spread)

    # (e) the embedding path: tabel_encoder_multi, the default EnsembleICLEmbedder
    runs = []
    for run in range(2):
        tr_csv = os.path.join(tab_dir, f"train_embeddings_{run}.csv")
        te_csv = os.path.join(tab_dir, f"test_embeddings_{run}.csv")
        timer = _PathTimer(torch, {"forward": (ICLTransformer, "forward", True),
                                   "csv": (pipeline, "write_embeddings", False)})
        prof = None
        with timer:
            t0 = time.perf_counter()
            if run == 1:
                prof = torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
            pipeline.tabel_encoder_multi(
                table, start_col=14, label_col="Group", classes=TAB_CLASSES, n_fold=5,
                test_size=0.2, train_out=tr_csv, test_out=te_csv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if prof is not None:
                prof.__exit__(None, None, None)
        runs.append((tr_csv, te_csv, wall, dict(timer.seconds), dict(timer.calls), prof))
    (tr0, te0, wall, secs, calls, _), (tr1, te1, wall1, secs1, _, prof) = runs
    shapes = []
    for path in (tr0, te0):
        with open(path, newline="") as f:
            rows = list(csv.reader(f))
        vals = np.array([[float(v) for v in r[1:]] for r in rows[1:]])
        check(rows[0] == ["label"] + [str(j) for j in range(len(rows[0]) - 1)],
              f"{path}: header")
        check(np.isfinite(vals).all(), f"{path}: values not finite")
        check(set(r[0] for r in rows[1:]) <= set(TAB_CLASSES), f"{path}: labels")
        shapes.append((len(rows) - 1, len(rows[0])))
    identical = all(open(a, "rb").read() == open(b, "rb").read()
                    for a, b in ((tr0, tr1), (te0, te1)))
    host_s = wall - secs["forward"] - secs["csv"]
    dev_rows = [e for e in prof.key_averages() if device_us(e) > 0]
    dev_s = sum(device_us(e) for e in dev_rows) / 1e6
    idle = 1 - dev_s / wall1
    log(f"  (e) tabel_encoder_multi, 6 members x 4 views, n_fold 5, test 0.2: "
        f"{wall:.2f} s wall, {calls['forward']} forwards; train CSV {shapes[0]}, test CSV "
        f"{shapes[1]} (label + 6 x (256 + 10 + 10 + 20) = 1,776 columns), finite; "
        f"a second run byte-identical: {identical}")
    log(f"  (e) wall split: host preprocessing and embedding blocks {host_s:.2f} s, card "
        f"forward (to its sync) {secs['forward']:.2f} s, CSV writing {secs['csv']:.2f} s; "
        f"the profiled second run {wall1:.2f} s with {dev_s * 1e3:.1f} ms of device time: "
        f"the card idles {idle:.1%}")
    check(calls["forward"] == 36, f"{calls['forward']} forwards (expected 6 x (5 + 1))")
    check(shapes == [(TAB_ROWS - n_test, 1777), (n_test, 1777)], f"CSV shapes {shapes}")
    check(identical, "the second embedding run's CSVs differ")
    out.update(embed_wall_s=wall, embed_forwards=calls["forward"], embed_split_s={
        "host": host_s, "forward": secs["forward"], "csv": secs["csv"]},
        embed_profiled_wall_s=wall1, embed_device_s=dev_s, embed_idle=idle,
        embed_csv_shapes=shapes)
    out["seconds"] = time.time() - t_phase
    log(f"  phase 15 took {out['seconds']:.1f} s ({card})")
    return out


def _timed_ms(fn):
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


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
    from multimodal_ad_tpu_torch.ops import int8_conv as k3
    from multimodal_ad_tpu_torch.ops import roi_pool as rp
    from multimodal_ad_tpu_torch.ops.augment import augment_batch
    from multimodal_ad_tpu_torch.ops.normalize import scale_intensity
    from multimodal_ad_tpu_torch.serve import EnsemblePredictor
    from multimodal_ad_tpu_torch.train import checkpoint as ckpt
    from multimodal_ad_tpu_torch.train import loop
    from multimodal_ad_tpu_torch.utils import native_loader, nifti

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
    _build.build(["fused_gather", "roi_pool", "int8_conv"])  # one nvcc each, in parallel
    fg._lib()
    rp._lib()
    k3._lib()
    build_s = time.time() - t0
    log(f"K1, K2 and K3 built and loaded in {build_s:.2f} s "
        f"({_build.library_path('fused_gather').name}, "
        f"{_build.library_path('roi_pool').name}, {_build.library_path('int8_conv').name})")
    for name in ("fused_gather", "roi_pool", "int8_conv"):
        log(_build.build_log(name).strip())
    t0 = time.time()
    native_err = native_loader.build_error()  # g++, the host NIfTI decoder
    native_build_s = time.time() - t0
    check(native_err is None, f"the native NIfTI decoder did not build: {native_err}")
    log(f"native NIfTI decoder built with g++ and loaded in {native_build_s:.2f} s "
        f"({native_loader.library_path().name})")

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
    native = native_decoder_check(torch, mri_dir)
    argv = ["--atlas", atlas_nii, "--atlas-json", atlas_lut,
            f"label_file={label_csv}", f"mri_dir={mri_dir}", f"batch_size={BATCH}"]
    fg.gather_normalize.launches = 0
    rp.roi_pool.launches = 0
    rp.roi_pool.path_launches = dict.fromkeys(rp.PATHS, 0)
    torch.cuda.reset_peak_memory_stats()
    walls = []
    before = reads_now()
    for run in (1, 2):
        t0 = time.time()
        feat_csv, roi_csv = cli_extract.main(argv + ["--out", os.path.join(work, f"out{run}")])
        walls.append(time.time() - t0)
        if run == 1:
            ext_k1 = fg.gather_normalize.launches
            ext_k2 = rp.roi_pool.launches
            ext_k2_paths = dict(rp.roi_pool.path_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    native["extraction_reads"] = reads_since(before)
    check_native_reads(native["extraction_reads"], "cli.extract_features")
    log(f"extraction K1 launches {ext_k1}, K2 launches {ext_k2} (first run; K2 by "
        f"path {ext_k2_paths}); decodes by reader over both runs "
        f"{native['extraction_reads']}")
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

    # fp32, TF32 off: three steps of a ResNet-10, card against host CPU
    fp32_rows = card_vs_host_steps(
        torch, dev, lambda: generate_model(model_depth=10, dropout_rate=0.0,
                                           compute_dtype=torch.float32,
                                           generator=torch.Generator().manual_seed(SEED)),
        (32, 38, 32))
    log_card_vs_host_steps(fp32_rows, "ResNet-10")

    # ---- 9. U-Net classifier training ------------------------------------
    unet = unet_classifier_phase(torch, dev, card, work, train_csv, train_mri, records)

    # ---- 10. autoencoder -> trained extraction ---------------------------
    ext_records = stratified_test_split(
        ADNIManifest(label_csv, mri_dir, verbose=False).data_dict, 0.2, 42)[1]
    ae = autoencoder_phase(torch, dev, card, work, train_csv, train_mri, records, ext_records,
                           labels, roi_names, os.path.join(work, "out1", "roi_features.csv"))

    # ---- 11. int8 serving -------------------------------------------------
    q8 = int8_phase(torch, dev, card, work, ckpt_dir, vols, train_ckpt, tr_val, test_recs)

    # ---- 12. DenseNet-3D training ------------------------------------------
    dense = densenet_phase(torch, dev, card, work, train_csv, train_mri, tr_val, test_recs)

    # ---- 13. encoder features and the seg head ------------------------------
    enc = encoder_phase(torch, dev, card, work, ext_records)

    # ---- 14. MSHyper and the host tools -------------------------------------
    tools = mshyper_and_tools_phase(torch, dev, card, work, atlas_nii, atlas_lut)

    # ---- 15. tabular in-context inference -----------------------------------
    tab = tabular_phase(torch, dev, card, work)
    shutil.rmtree(work, ignore_errors=True)

    # ---- 16. result ----------------------------------------------------
    ms, plain_ms, bound, bound_by = timings["serving f32->bf16 B=8"]
    k3_top = q8["k3_shapes"][-1]  # stage 4, 3^3 d4, 512->512 (the last block's conv2)
    kernels = {"kernels": [{
        "name": "fused_gather_normalize",
        "route": "cuda",
        "source": K1_SOURCE,
        "replaces": K1_REPLACES,
        "launches": (serve_launches + resident_launches + ext_k1 + train_launches
                     + unet["k1_launches"] + ae["k1_launches"] + ae["extraction_k1"]
                     + q8["k1_launches"] + dense["k1_launches"] + enc["k1_launches"]),
        "launches_serving": serve_launches,
        "launches_resident": resident_launches,
        "launches_extraction": ext_k1,
        "launches_training": train_launches,
        "launches_unet_training": unet["k1_launches"],
        "launches_autoencoder": ae["k1_launches"],
        "launches_trained_extraction": ae["extraction_k1"],
        "launches_int8_serving": q8["k1_launches"],
        "launches_densenet_training": dense["k1_launches"],
        "launches_encoder_extraction": enc["k1_launches"],
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
        "launches": ext_k2 + ae["extraction_k2"],
        "launches_extraction": ext_k2,
        "launches_trained_extraction": ae["extraction_k2"],
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
    }, {
        "name": "int8_conv",
        "route": "cuda",
        "source": K3_SOURCE,
        "replaces": K3_REPLACES,
        "not_pallas": "an XLA int8 conv_general_dilated (no stock CUDA int8 Conv3d)",
        "launches": q8["k3_launches"],
        "launches_per_batch": q8["k3_launches_per_batch"],
        "max_abs_err": q8["k3_max_abs_err"],
        "ms": k3_top["ms"],
        "plain_ms": k3_top["plain_ms"],
        "bound_ms": k3_top["bound_ms"],
        "bound_by": k3_top["bound_by"],
        "library_ms": k3_top["int_mm_ms"],
        "library_call": "torch._int_mm on a pre-built im2col (M, K) int8 matrix",
        "cudnn_bf16_ms": k3_top["cudnn_bf16_ms"],
        "shape": f"{k3_top['shape']}, B={BATCH}, {k3_top['epilogue']} epilogue",
        "executed_taps": k3_top["executed_taps"],
        "in_volume_taps": k3_top["in_volume_taps"],
        "forward_19_convs": q8["k3_forward"],
        "per_shape": q8["k3_shapes"],
        "design_pr": 7,
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
                    "unet_classifier": unet, "autoencoder": ae,
                    "int8": {k: v for k, v in q8.items() if k not in ("k3_shapes",)},
                    "native_decoder": dict(native, build_s=native_build_s),
                    "densenet": dense, "encoder": enc,
                    "mshyper_and_tools": tools, "tabular": tab,
                    "build_s": build_s,
                    "card": card, "seconds": time.time() - t_start}))
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
