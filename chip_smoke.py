#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (multimodal_ad_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit, nothing is caught):

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build K1 (csrc/fused_gather.cu), K2 (csrc/roi_pool.cu), K3
   (csrc/int8_conv.cu) and K4 (csrc/max_pool.cu) with nvcc for sm_90a, in
   parallel, timed, and the native NIfTI decoder (native/nifti_reader.cpp)
   with g++, timed; the run fails if either does not build;
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
   `predict_proba` vols/s, the int8 model's s2d bf16 stem's time against
   the bf16 model's stem's, a profile of one int8 batch split into K3, stem, quantize and
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
16. ICL meta-training at the default config (d_model 256, 6 layers, 192
   features, 10 classes, cat_input; batch 32, n_ctx 128, n_qry 32, both
   auxiliary losses at 0.5): (a) `cli.pretrain_icl` on the card, 300 steps
   with `--device-prior` and 40 with the host prior (meta-steps/s), each
   step at steady state (CUDA events, and a profile: the card's idle share
   and device kernels a step, against the unprofiled step), the sampler's
   share of a device-prior step
   and the step's fp32 FLOP bound; (b) the written msgpack read back by the
   port's loader and converter and by `merge_compatible_params`, and used by
   `ICLClassifier(params=...)`; (c) the JAX package's device-prior learning
   proof (TINY, 300 steps, chunk 50: accuracy >= 0.8); (d)
   `ICLClassifier(cfg=TINY)` and `ICLRegressor(cfg=<TINY RegICLConfig>)`
   with no params meta-train on the card and predict; (e) `--regression`,
   40 steps;
17. fusion: 40 subjects with MRI and PET at 91x109x91 and a 20-feature
   table keyed by subject: (a) `cli.train_fusion --use-pet --use-table`
   (dim 128, depth 2, heads 4, dim_head 32, mlp 256; batch 8, bf16, 2
   folds x 3 epochs, the default `ICLClassifier()` embedder on the card):
   K1 launched for the MRI and the PET of every batch, the CSV, the
   checkpoints; the train step's rate on a resident batch (vols/s counting
   MRI and PET volumes, and subjects/s), its idle share, kernels a step and
   top kernels, and a streamed epoch's rate and idle share; (b) `--arch
   daft --use-table`, one epoch; (c) the JAX package's TestFusionLearning
   recipe at 16^3 with cuDNN deterministic (every fold's best score >= 0.8,
   held-out AUC >= 0.85; the table embedder `ICLClassifier()` in place of
   sklearn's logistic regression); (d) `MultimodalClassifier` (MRI + PET + table) and
   `DAFTResNet` fp32 forwards on the card against the host on the same
   weights and inputs (1e-3 of the logits' spread);
18. the tabular meta-estimators over the classifier asset on phase 15's
   table (464 / 116), with sklearn, pandas, matplotlib, flax and msgpack
   blocked: (a) exact `shapley_values` of P(AD) over 12 numeric features
   (2^12 = 4,096 coalitions, one predict_proba chunk a sample) for 4
   samples: seconds a sample, device kernels a chunk and the card's idle
   share (a profile), efficiency (the values sum to f(x) - f(background)
   within 1e-5), one sample on the host CPU within 1e-4 of the values'
   spread; a Monte-Carlo run at F = 20, 16 permutations; (b)
   `TunedICLClassifier(n_trials=8, n_splits=3)`: wall time, fits and
   fits/s, the trials, `best_params_`, `best_score_`, test macro AUC, one
   CV run's idle share; at n_trials=2 on the card and on the host: the
   same trials and seeds, the same pick, probabilities within 1e-4; (c)
   `AutoICLClassifier(n_configs=4)` and `SeedEnsembleICL(n_members=4)`:
   times, the greedy weights, test AUC; (d) `ManyClassClassifier` over
   `ICLClassifier()` on a seeded 14-class table (ECOC, a (14, 4) codebook):
   fit and predict times, accuracy, the host's codebook equal and its
   probabilities within 1e-4; `TunedICLRegressor(n_trials=4)` on phase 15
   (d)'s target: time and R²;
19. data parallelism over a device mesh (parallel/mesh.py), ResNet-18 at
   91x109x91, global batch 8: (a) at W = 1 on NCCL in this process, one
   fp32 DDP train step against the plain step on the same weights and the
   same K1-gathered batch (loss rel 1e-6; Adam's first moments within 1e-5
   of their norm, the parameters by the element rule of `adam_rule`), both
   steps' times and DDP's overhead (CUDA events, median of 14), the bf16
   step's too beside phase 8's rate; (d) `EnsemblePredictor(mesh=)` over
   phase 4's five folds, bf16 and then int8 (K3): probabilities bit-equal
   to the mesh-less predictor's; (e) `extract_unet_features(mesh=)` over
   phase 7's first 8 test subjects: the CSV rows byte-identical to phase
   7's; then two gloo ranks, both on the card (spawned): (b) the fp32 step
   at 4 rows a rank, a full and a ragged batch (5 real rows of 8), against
   the one-process step at 8 rows (the same rule, the first moments within
   `W2_U_BOUND` of their norm), both ranks' parameters and buffers equal,
   each rank's K1 once on its 4 rows, the W = 2 step's time; (e) the same
   extraction (rows and order as phase 7's, values within 1e-4, K1 and K2
   once a rank); (d) the bf16 and int8 ensembles (5e-3, K3 19 x 5 a batch
   a rank); (c) `python -m torch.distributed.run --standalone
   --nproc_per_node=1 -m multimodal_ad_tpu_torch.cli.train_resnet3d
   --device cuda` on phase 8's data, 2 folds x 1 epoch: exit 0, the config
   printed once, the CSV and checkpoints, K1 launches (read from the
   launched process, `MAD_LAUNCH_COUNTS_DIR`) = batches, the rate beside
   phase 8's CLI run; (f) `entry.dryrun_multichip(2)` (two gloo ranks on
   the card), `entry.entry()`'s forward and the six port examples on the
   card;
20. spatial sharding (parallel/spatial.py), ResNet-18 B at 91x109x91 with
   the volume's X over a 'space' axis, gloo ranks on the card (spawned):
   (a) two ranks on {"space": 2}, the fp32 eval forward at B = 2 (slabs
   of 46 + 45 planes, halo exchanges): logits within 1e-4 of their spread
   from the unsharded forward, the 'none' head's slabs gathered within
   1e-4 of the layer-4 map's spread, the bf16 probabilities within 5e-3;
   (e) `EnsemblePredictor(mesh={"data": 1, "space": 2})` over phase 4's
   five folds, bf16 then int8 (K3): rank 0's bit-equal to the mesh-less
   predictor in the same process, rank 1's within 5e-3; (b) four ranks on {"data": 2, "space": 2}, one
   fp32 step on a global batch of 8 from the resident corpus (each rank's
   K1 once on its data row's 4 rows whole, then its slab) against the
   one-process step (loss rel 1e-6, the first moments within `W2_U_BOUND`
   of their norm, `adam_rule`'s element rule), the four ranks' parameters
   and buffers equal, then the bf16 step's time (median of 3 after 1) with
   its exchanges and halo MB a step; (c) the same on a ragged batch (5 real
   rows); (d) `entry.dryrun_multichip(4)` over four gloo ranks on the card;
   the slab stem and remat (slice 17): (f) on (a)'s two ranks the fp32 and
   bf16 forwards with the plain 7^3 halo stem beside (a)'s space-to-depth
   stem on slabs, each against the one-process model of its form (1e-4 of
   the logits' spread, 5e-3 in probability), and each form's stem (conv1 to
   the max pool) and stem conv device time on each rank (torch.profiler,
   ranges as in phase 22); (g) on (b)'s four ranks the fp32 step of a
   ``remat=True`` model against a ``remat=False`` one from the same
   weights, both on cuDNN's deterministic algorithms: the loss equal to
   the bit, every BatchNorm statistic equal (``num_batches_tracked`` 1),
   the clipped gradients within 1.5e-6 of max |g|, the ranks' parameters
   equal, the one-process rule of (b), its exchanges the plain step's plus
   the blocks' forward ones; (h) the bf16 step with and without `remat`:
   ms (median of 3 after 1), exchanges and halo MB a step, each rank's
   peak memory over a step;
21. K4 (csrc/max_pool.cu), the backward of `ops/pool.py::max_pool_3d_fast`
   (each window's cotangent split equally among its tied maxima), which no
   model routes: driven through `max_pool_3d_fast(x).backward(g)` at the
   ResNet-18 stem pool (8, 46, 55, 46, 64), 3^3/s2/p1, in the dtype the
   ResNet train step hands its max pool and in float32, and at the U-Net's
   first encoder pool (2, 96, 112, 96, 64) bf16, 2^3/s2/p0 (the launches);
   (a) at the stem shape, a normal (in float32 59.6 M distinct values,
   tie-free) and ReLU(normal - 2) (about half the windows all zero, so
   tied): the forward bit-equal to `F.max_pool3d`, K4 against its plain
   version (float32 within 1e-6 * max|g|; bf16 equal to the plain version
   computed in float32 and rounded once, and within 1e-2 * max|dx| of the
   bf16 plain version), on the tie-free float32 input against ATen's
   max-pool backward (1e-6 * max|g|), each window's mass kept, two
   launches bit-identical; (b) at the U-Net shape, an all-zero input gives
   exactly g / 8 repeated, and an input without ties in any window (each
   window a permutation of 0..7) gives K4 = plain = ATen bit for bit; (c)
   times (medians of 25, L2 flushed) of K4's backward, the plain
   version's, ATen's backward from saved indices, and forward + backward
   through autograd for K4 and for ATen, beside the byte bound, K4's
   achieved GB/s, its launch geometry (with the blocks an SM holds as the
   card counts them), and its one kernel's device time (torch.profiler);
   K4's ptxas lines (registers, spills) first;
22. the ResNet's two stems and `remat` (the JAX default stem, ported in
   slice 16): (a) phase 4's five folds built with ``s2d_stem`` True and
   False, resident bf16 serving of 8 of phase 4's volumes through each
   (K1), the probabilities within 5e-3; fold 1's stem conv in fp32 (TF32
   off), s2d against plain, within 1e-4 of the output's spread; phase 4's
   card-vs-host fp32 logits (the s2d stem) recalled; (b) the stem alone,
   both forms, bf16 (autocast over fp32 parameters) and fp32, the conv and
   conv + BN + ReLU + max pool, forward (eval, no gradients) and forward +
   backward (train), at B = 8 and 32 (medians of 25, L2 flushed); resident
   bf16 serving at B = 32 through each form: the 5-fold forward's time and
   a profile of 2 batches with each fold's stem and its conv in ranges,
   their shares of device time; (c) a resident train step at B = 8 (K1,
   augmentation, forward, backward, Adam) of a fresh ResNet-18 with and
   without `remat` from the same weights, fp32 and bf16: the first step on
   one fixed batch (loss within 1e-6 relative and the BatchNorm statistics
   equal in fp32), then the step's time (median of 6) and peak memory;
   the bf16 step at B = 32 (K1 gathers, no augmentation) with and without
   `remat`: time (median of 4) and peak memory;
23. one JSON line {"kernels": [...]} (with each kernel's launches in phase
   19 by rank and run, `launches_data_parallel`, and in phase 20,
   `launches_spatial`) and, last, the device line.

Every streamed path of phases 7, 9 (cli.train_unet3d), 10, 13 and 17 prints
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
K4_REPLACES = "multimodal_ad_tpu/ops/pool.py:63"
K4_SOURCE = "multimodal_ad_tpu_torch/csrc/max_pool.cu"
# K4's two shapes: the ResNet-18 stem's output at B = 8 (91 -> 46 -> 23),
# its 3^3/s2/p1 pool; the U-Net's first encoder pool, configs/config_unet.json's
# batch 2 with the volume padded to a multiple of 8 and 64 channels, 2^3/s2/p0
POOL_STEM = (BATCH, 46, 55, 46, 64)
POOL_UNET = (2, 96, 112, 96, 64)
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
    from multimodal_ad_tpu_torch.serve import EnsemblePredictor, bucket_sizes, evaluate_records

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
    # the first call also runs each bucket below the batch once through one fold
    warm = len(bucket_sizes(BATCH)) - 1 + (len(vols) < BATCH)
    out["k3_launches_per_batch"] = (out["k3_launches"] - 19 * warm) // n_chunks
    log(f"quantize_int8 (4 calibration volumes, {N_FOLDS} folds: export, folded bf16 forward, "
        f"scales) "
        f"{out['calibration_s']:.2f} s; predict_proba of {len(vols)} volumes (first call) "
        f"{out['first_predict_s']:.2f} s: K3 launches {out['k3_launches']} (expected "
        f"{n_chunks} x 19 x {N_FOLDS} + 19 x {warm} warming the buckets), K1 launches "
        f"{out['k1_launches']}")
    check(out["k3_launches"] == (n_chunks * N_FOLDS + warm) * 19,
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

    # the int8 model's s2d bf16 stem against the bf16 model's stem (StemConv, s2d by
    # default) under bf16 autocast
    x8 = ds.gather_normalized(np.arange(BATCH) % len(vols), torch.bfloat16)["image"]
    net, fold = pred8.int8_folds[0], pred16.folds[0]
    with torch.inference_mode():
        s2d_ms = time_cuda(torch, lambda: net.stem(x8), flush=flush)
        x_ncdhw = x8.permute(0, 4, 1, 2, 3)

        def stem_bf16_model():
            with torch.autocast(x_ncdhw.device.type, dtype=torch.bfloat16):
                return fold.maxpool(torch.relu(fold.bn1(fold.conv1(x_ncdhw))))

        model_stem_ms = time_cuda(torch, stem_bf16_model, flush=flush)
    out["stem_s2d_bf16_ms"], out["stem_bf16_model_ms"] = s2d_ms, model_stem_ms
    log(f"stem of one fold at B={BATCH}: the int8 model's s2d bf16 (conv 4^3 over 8 phases + "
        f"affine + ReLU + max pool) {s2d_ms:.3f} ms; the bf16 model's stem (s2d: "
        f"{fold.conv1.s2d}; conv + BN + ReLU + max pool, autocast) {model_stem_ms:.3f} ms")

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


def numeric_columns(X):
    """The table's numeric feature columns that are at most half blank and
    take more than 10 values, in order."""
    return [j for j in range(X.shape[1]) if np.isnan(X[:, j]).mean() < 0.5
            and len(np.unique(X[np.isfinite(X[:, j]), j])) > 10]


def regression_target(X):
    """(source columns, target): y = 0.8 a - 0.5 b + 0.3 a c + noise over the
    first three numeric feature columns (their blanks at the column
    median), which stay in X with their blanks."""
    g = np.random.default_rng(SEED + 17)
    source_cols = numeric_columns(X)[:3]
    ya, yb, yc = (np.where(np.isnan(X[:, j]), np.nanmedian(X[:, j]), X[:, j])
                  .astype(np.float64) for j in source_cols)
    return source_cols, 0.8 * ya - 0.5 * yb + 0.3 * ya * yc + 0.2 * g.normal(size=len(X))


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
    source_cols, target = regression_target(X)
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


META_BATCH, META_CTX, META_QRY = 32, 128, 32  # cli.pretrain_icl's defaults
META_DEVICE_STEPS, META_HOST_STEPS, META_REG_STEPS = 300, 40, 40


def _separable_data(n=90, f=6, seed=5):
    """The JAX package's tests/test_tabular.py::separable_data."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n)
    X = rng.normal(size=(n, f)).astype(np.float32) + 2.5 * y[:, None]
    return X, y


def _profiled_steps(torch, fn, n, tries=3):
    """(device ms a step, device kernels and copies a step, the profiler)
    over `n` calls of `fn()` back to back under torch.profiler. A profile
    that loses events counts fewer kernels and less device time, so the
    result is taken only from a profile whose kernel count the one before
    it confirms within 2 %; after `tries` profiles with no such pair the
    phase fails. The idle shares below set this device time against the
    step's unprofiled time (CUDA events): the profiler slows the host's
    launches."""
    counts = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        dev_ms, launches = profile_split(torch, prof, n)
        if counts and abs(launches - counts[-1]) <= 0.02 * max(launches, counts[-1]):
            return dev_ms, launches, prof
        counts.append(launches)
    check(False, f"profiles of the same step count {counts} device kernels a step: the "
                 "profiler lost events, so no idle share is measured")


def metatrain_phase(torch, dev, card, work):
    """Phase 16: ICL meta-training on the card (the default config through
    cli.pretrain_icl, device and host prior; the regressor; the TINY
    learning proof; the estimators meta-training where no asset applies)."""
    from multimodal_ad_tpu_torch.cli import pretrain_icl as cli_pretrain
    from multimodal_ad_tpu_torch.tabular import icl as ticl
    from multimodal_ad_tpu_torch.tabular.flax_msgpack import read_state, tree_leaves
    from multimodal_ad_tpu_torch.tabular.icl_prior import sample_tasks_device
    from multimodal_ad_tpu_torch.tabular.icl_regression import RegICLConfig, _load_reg_params_file
    from multimodal_ad_tpu_torch.tabular.meta_train import MetaTrainer
    from multimodal_ad_tpu_torch.tabular.regression import ICLRegressor
    from multimodal_ad_tpu_torch.utils.torch_weights import icl_state_dict_from_flax

    out = {}
    t_phase = time.time()
    cfg = ticl.ICLConfig()
    log(f"== 16. ICL meta-training: d_model {cfg.d_model}, {cfg.n_layers} layers, "
        f"{cfg.max_features} features, {cfg.max_classes} classes, cat_input; batch "
        f"{META_BATCH}, n_ctx {META_CTX}, n_qry {META_QRY}")
    mdir = os.path.join(work, "metatrain")
    os.makedirs(mdir, exist_ok=True)
    base = ["--batch", str(META_BATCH), "--n-ctx", str(META_CTX), "--n-qry", str(META_QRY),
            "--cat-input", "--aux-embed", "0.5", "--aux-qc", "0.5", "--device", "cuda"]

    # (a) the CLI, device prior and host prior
    files = {}
    for label, steps, extra in (("device", META_DEVICE_STEPS, ["--device-prior", "--chunk", "100"]),
                                ("host", META_HOST_STEPS, [])):
        files[label] = os.path.join(mdir, f"icl_{label}.msgpack")
        torch.cuda.synchronize()
        t0 = time.time()
        cli_pretrain.main(["--steps", str(steps), "--out", files[label]] + base + extra)
        torch.cuda.synchronize()
        wall = time.time() - t0
        out[f"cli_{label}_s"] = wall
        out[f"cli_{label}_steps_per_s"] = steps / wall
        log(f"  (a) cli.pretrain_icl, {label} prior, {steps} steps (aux_embed 0.5, aux_qc 0.5): "
            f"{wall:.2f} s, {steps / wall:.2f} meta-steps/s (network build and file write "
            f"included)")

    # the same step at steady state: CUDA events, and a profile for the idle share
    net = ticl.ICLTransformer(cfg)
    net.load_state_dict(icl_state_dict_from_flax(ticl.init_icl_params(cfg, SEED), cfg))
    trainer = MetaTrainer(net.to(dev).train(), 3e-4, 1000, lambda m, t: ticl.icl_meta_loss(
        m, t, aux_embed=0.5, aux_qc=0.5))
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def draw():
        return sample_tasks_device(gen, META_BATCH, cfg, META_CTX, META_QRY)

    rng = np.random.default_rng(SEED)

    def host_task():
        return {k: torch.from_numpy(v).to(dev) for k, v in
                ticl.sample_tasks(rng, META_BATCH, cfg, META_CTX, META_QRY).items()}

    flops = 3 * icl_forward_flops(cfg, META_BATCH, META_CTX, META_QRY)
    out["step_bound_ms"] = flops / F32_OPS_PER_S * 1e3
    sampler_ms, _ = step_events(torch, draw, 20)
    for label, fn in (("device", lambda: trainer.step(draw())),
                      ("host", lambda: trainer.step(host_task()))):
        step_ms, _ = step_events(torch, fn, 20)
        d_ms, kernels, prof = _profiled_steps(torch, fn, 10)
        out.update({f"{label}_prior_step_ms": step_ms,
                    f"{label}_prior_steps_per_s": 1e3 / step_ms,
                    f"{label}_prior_device_ms": d_ms, f"{label}_prior_kernels": kernels,
                    f"{label}_prior_idle": 1 - d_ms / step_ms})
        log(f"  (a) {label} prior, steady state: {step_ms:.2f} ms a step (CUDA events, median "
            f"of 20: {1e3 / step_ms:.2f} meta-steps/s), {d_ms:.2f} ms of it device time (a "
            f"profile of 10 steps): the card idles {1 - d_ms / step_ms:.1%}; {kernels:.0f} "
            f"device kernels and copies a step")
        if label == "device":
            log(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=10,
                                          max_name_column_width=70))
    out.update(sampler_ms=sampler_ms, sampler_share=sampler_ms / out["device_prior_step_ms"])
    log(f"  (a) device prior: sampler {sampler_ms:.2f} ms of a {out['device_prior_step_ms']:.2f} "
        f"ms step (CUDA events, median of 20): {out['sampler_share']:.1%} of the step; the "
        f"step's fp32 bound {out['step_bound_ms']:.2f} ms ({flops / 1e9:.1f} GFLOP forward + "
        f"backward at 67 TFLOP/s) on {card}")
    del trainer, net

    # (b) the written files read back
    tree = ticl._load_params_file(cfg, files["device"])
    stored = dict(tree_leaves(read_state(files["device"])))
    merged = ticl.merge_compatible_params(ticl.init_icl_params(cfg, 1), files["device"],
                                          verbose=True)
    same = all(np.array_equal(v, stored[k]) for k, v in tree_leaves(merged))
    log(f"  (b) {files['device']}: {len(stored)} leaves, read by the port's loader and "
        f"converter; merge_compatible_params takes every leaf from the file: {same}")
    check(len(stored) == 107 and same, "the meta-trained file does not read back whole")
    X, y = _separable_data()
    clf = ticl.ICLClassifier(params=tree, device="cuda").fit(X[:60], y[:60])
    acc_full = float((clf.predict(X[60:]) == y[60:]).mean())
    log(f"  (b) ICLClassifier(params=<the {META_DEVICE_STEPS}-step file>) on the separable "
        f"table: accuracy {acc_full:.3f}")
    out["full_width_file_acc"] = acc_full

    # (c) the JAX package's device-prior learning proof, its config and bar
    tiny = ticl.ICLConfig(d_model=32, n_heads=2, n_layers=2, d_ff=64, max_features=16,
                          max_classes=4, max_context=64)
    torch.cuda.synchronize()
    t0 = time.time()
    params, _ = ticl.pretrain_icl(tiny, steps=300, batch=16, n_ctx=48, n_qry=16, lr=1e-3,
                                  seed=0, device_prior=True, chunk=50, device="cuda")
    proof_s = time.time() - t0
    clf = ticl.ICLClassifier(params=params, cfg=tiny, device="cuda").fit(X[:60], y[:60])
    acc = float((clf.predict(X[60:]) == y[60:]).mean())
    out.update(tiny_proof_s=proof_s, tiny_proof_acc=acc)
    log(f"  (c) TINY, 300 steps, device prior, chunk 50: {proof_s:.2f} s; accuracy {acc:.3f} "
        "(bar 0.8)")
    check(acc >= 0.8, f"device-prior meta-trained accuracy {acc} < 0.8")

    # (d) the estimators meta-train where no asset applies
    t0 = time.time()
    est = ticl.ICLClassifier(cfg=tiny).fit(X[:60], y[:60])
    acc_d = float((est.predict(X[60:]) == y[60:]).mean())
    clf_s = time.time() - t0
    rc = RegICLConfig(d_model=32, n_heads=2, n_layers=2, d_ff=64, max_features=16,
                      max_context=64)
    target = X[:, 0] * 2.0 - X[:, 1]
    t0 = time.time()
    reg = ICLRegressor(cfg=rc).fit(X[:60], target[:60])
    pred = reg.predict(X[60:])
    reg_s = time.time() - t0
    r2 = 1 - float(np.mean((pred - target[60:]) ** 2) / np.var(target[60:]))
    out.update(est_clf_s=clf_s, est_clf_acc=acc_d, est_reg_s=reg_s, est_reg_r2=r2)
    log(f"  (d) ICLClassifier(cfg=TINY) with no params: meta-trained (300 host-prior steps) "
        f"and fitted in {clf_s:.2f} s, accuracy {acc_d:.3f}; ICLRegressor(cfg=<TINY "
        f"RegICLConfig>): 300 device-prior steps and fit in {reg_s:.2f} s, R^2 {r2:.3f}")
    # the classifier is held to the TINY proof's bar; the regressor only to
    # finite predictions, since the JAX package's TINY regressor after 300
    # steps does not fit this table either (R^2 below 0 on the CPU:
    # scripts/port_parity_cpu.py --only pretrain)
    check(acc_d >= 0.8, f"ICLClassifier(cfg=TINY) meta-trained without an asset: accuracy "
                        f"{acc_d} < 0.8")
    check(pred.shape == target[60:].shape and np.isfinite(pred).all(),
          "ICLRegressor(cfg=<TINY RegICLConfig>) without an asset did not predict finite values")
    log("  (d) checks: the classifier's accuracy >= 0.8; the regressor's R^2 is printed, not "
        "checked (its predictions finite and of the table's length)")

    # (e) the regression network through the CLI
    reg_file = os.path.join(mdir, "icl_reg.msgpack")
    torch.cuda.synchronize()
    t0 = time.time()
    cli_pretrain.main(["--regression", "--steps", str(META_REG_STEPS), "--chunk", "20",
                       "--batch", str(META_BATCH), "--n-ctx", str(META_CTX), "--n-qry",
                       str(META_QRY), "--device", "cuda", "--out", reg_file])
    wall = time.time() - t0
    _load_reg_params_file(RegICLConfig(), reg_file)
    out.update(cli_reg_s=wall, cli_reg_steps_per_s=META_REG_STEPS / wall)
    log(f"  (e) cli.pretrain_icl --regression, {META_REG_STEPS} steps: {wall:.2f} s, "
        f"{META_REG_STEPS / wall:.2f} meta-steps/s; the file reads back")
    out["seconds"] = time.time() - t_phase
    log(f"  phase 16 took {out['seconds']:.1f} s ({card})")
    return out


FUSION_PER_CLASS = 20  # 40 subjects: 8 test, 2 folds of 16 train / 16 validation
FUSION_EPOCHS = 3
FUSION_FEATURES = 20


def write_fusion_table(path, records, seed):
    """A clinical table keyed by the manifest's subjects: Subject_ID,
    Group, 12 filler columns, then FUSION_FEATURES numeric features shifted
    by 0.8 x the label (features from column 14)."""
    from multimodal_ad_tpu_torch.data.tabular import write_table

    rng = np.random.default_rng(seed)
    y = np.array([r["label"] for r in records])
    cols = {"Subject_ID": np.array([r["Subject"] for r in records], dtype=object),
            "Group": np.array([("AD", "CN")[v] for v in y], dtype=object)}
    for j in range(12):
        cols[f"meta{j}"] = rng.normal(size=len(y)).round(3)
    for j in range(FUSION_FEATURES):
        cols[f"feat{j}"] = (rng.normal(size=len(y)) + 0.8 * y).astype(np.float32)
    return write_table(path, cols)


def fusion_phase(torch, dev, card, work):
    """Phase 17: multimodal fusion training on the card (cli.train_fusion
    with MRI + PET + table at the CLI's widths, the DAFT arch, the JAX
    package's learning bars, card against host)."""
    from multimodal_ad_tpu_torch.cli import train_fusion as cli_fusion
    from multimodal_ad_tpu_torch.core.config import Config
    from multimodal_ad_tpu_torch.data.adni import ADNIManifest
    from multimodal_ad_tpu_torch.data.pipeline import VolumeBatcher
    from multimodal_ad_tpu_torch.data.splits import stratified_kfold, stratified_test_split
    from multimodal_ad_tpu_torch.data.synthetic import make_adni_dir
    from multimodal_ad_tpu_torch.models.daft import DAFTResNet
    from multimodal_ad_tpu_torch.models.transformer import MultimodalClassifier
    from multimodal_ad_tpu_torch.ops import fused_gather as fg
    from multimodal_ad_tpu_torch.eval.features import deterministic_cudnn
    from multimodal_ad_tpu_torch.tabular import ICLClassifier
    from multimodal_ad_tpu_torch.train import fusion
    from multimodal_ad_tpu_torch.train import loop
    from multimodal_ad_tpu_torch.train.cv import _run_epoch as run_epoch

    out = {}
    t_phase = time.time()
    log(f"== 17. fusion training: MRI + PET + table, 91x109x91, batch {BATCH}, bf16")
    root = os.path.join(work, "fusion")
    t0 = time.time()
    csv_path, mri, pet = make_adni_dir(root, n_per_class=FUSION_PER_CLASS, classes=("AD", "CN"),
                                       shape=VOL_SHAPE, seed=SEED + 60, pet=True,
                                       extent_jitter=0.3, center_jitter=0.04, noise=0.25)
    recs = ADNIManifest(csv_path, mri, pet_dir=pet, verbose=False).data_dict
    table = write_fusion_table(os.path.join(root, "table.csv"), recs, SEED + 61)
    log(f"wrote {len(recs)} subjects (MRI and PET) and a {FUSION_FEATURES}-feature table in "
        f"{time.time() - t0:.1f} s")
    tr_val, test_recs = stratified_test_split(recs, 0.2, 42)
    folds = list(stratified_kfold(tr_val, 2, 42))
    batches = sum(-(-len(d) // BATCH) for _, tr, vl in folds for d in (tr, vl))

    # (a) the main path: cli.train_fusion --use-pet --use-table at the CLI's widths
    ckpt_dir = os.path.join(root, "ckpt")
    cfg_args = [f"label_file={csv_path}", f"mri_dir={mri}", f"pet_dir={pet}",
                f"batch_size={BATCH}", "compute_dtype=bfloat16", "n_splits=2", "lr=1e-3",
                "normalizer=scale_intensity",
                f"checkpoint_dir={ckpt_dir}"]
    fg.gather_normalize.launches = 0
    before = reads_now()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    best = cli_fusion.main(["--use-pet", "--use-table", "--table", table, "--dim", "128",
                            "--depth", "2", "--device", "cuda", f"num_epochs={FUSION_EPOCHS}"]
                           + cfg_args)
    torch.cuda.synchronize()
    out["cli_s"] = time.time() - t0
    out["k1_launches"] = fg.gather_normalize.launches
    out["cli_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    reads = reads_since(before)
    expect = FUSION_EPOCHS * batches * 2
    log(f"  (a) cli.train_fusion --use-pet --use-table (dim 128, depth 2, heads 4, dim_head "
        f"32, mlp 256), 2 folds x {FUSION_EPOCHS} epochs: {out['cli_s']:.1f} s (the ICL "
        f"embedder's fits included); best fold scores {[round(b, 4) for b in best]}; K1 "
        f"launches {out['k1_launches']} (expected {expect}: MRI and PET of every batch); "
        f"reads {reads}; peak memory {out['cli_peak_gb']:.2f} GB")
    check(out["k1_launches"] == expect, f"fusion ran K1 {out['k1_launches']} times, "
          f"expected {expect}")
    check_native_reads(reads, "phase 17 (a)")
    with open(os.path.join(ckpt_dir, "fusion_results.csv")) as f:
        rows = list(csv.reader(f))
    il, vl = rows[0].index("tr_loss"), rows[0].index("vl_loss")
    losses = [(float(r[il]), float(r[vl])) for r in rows[1:]]
    check(len(rows) == 1 + 2 * FUSION_EPOCHS and bool(np.isfinite(losses).all())
          and all(np.isfinite(best)), f"fusion_results.csv {rows}")
    for k in (1, 2):
        check(os.path.isfile(os.path.join(ckpt_dir, f"fusion_best_fold{k}", "model.pt")),
              f"fusion_best_fold{k} missing")
    log(f"  (a) fusion_results.csv (tr_loss, vl_loss): {losses}")
    out["best"] = best

    # the step's rate at steady state: one batch of 8 subjects (8 MRI + 8 PET
    # volumes) resident, K1 on each modality + the train step
    cfg = Config(batch_size=BATCH, compute_dtype="bfloat16", dropout_rate=0.5)
    table_dim = 296  # the rich embedding of the default ICLClassifier
    model = fusion.make_fusion_model(cfg, "cross_transformer", True, True, table_dim,
                                     dict(dim=128, depth=2), seed=SEED).to(dev)
    state = loop.create_train_state(model, loop.make_epoch_schedule(1e-3, 20), dropout_seed=1)
    step, _ = fusion.make_fusion_steps("cross_transformer", True, True)
    loader = VolumeBatcher(tr_val[:BATCH], batch_size=BATCH, image_keys=("MRI", "PET"),
                           table_lookup={r["Subject"]: np.random.default_rng(i).normal(
                               size=table_dim).astype(np.float32)
                               for i, r in enumerate(tr_val)})
    raw = next(iter(loader))
    raw = {k: torch.from_numpy(v).to(dev) for k, v in raw.items() if isinstance(v, np.ndarray)}
    cw = torch.tensor([0.5, 0.5], device=dev)
    from multimodal_ad_tpu_torch.ops.normalize import scale_intensity

    def one_step():
        b = dict(raw, image=scale_intensity(raw["image"]), pet=scale_intensity(raw["pet"]))
        return step(state, b, cw)

    step_ms, first_s = step_events(torch, one_step, 10)
    out.update(step_ms=step_ms, first_step_s=first_s,
               vols_per_s=2 * BATCH / (step_ms / 1e3), subjects_per_s=BATCH / (step_ms / 1e3))
    d_ms, kernels, prof = _profiled_steps(torch, one_step, 5)
    out.update(device_ms=d_ms, kernels_per_step=kernels, idle_resident=1 - d_ms / step_ms)
    log(f"  (a) train step, resident batch of {BATCH} subjects: {step_ms:.2f} ms (CUDA events, "
        f"median of 10; the first {first_s:.2f} s with cuDNN's autotune): "
        f"{out['vols_per_s']:.1f} vols/s counting MRI and PET volumes "
        f"({out['subjects_per_s']:.1f} subjects/s); {d_ms:.2f} ms of it device time (a "
        f"profile of 5 steps): the card idles {out['idle_resident']:.1%}; {kernels:.0f} device "
        f"kernels and copies a step; on {card}")
    log(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=12,
                                  max_name_column_width=70))
    # the streamed epoch as the CLI runs it: decode on host threads, upload, K1, step
    lookup = {r["Subject"]: np.zeros(table_dim, np.float32) for r in tr_val}
    stream = VolumeBatcher(tr_val, batch_size=BATCH, image_keys=("MRI", "PET"),
                           table_lookup=lookup, num_threads=8)
    run_epoch(step, state, stream, dev, train=True, class_weights=cw)  # warm
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run_epoch(step, state, stream, dev, train=True, class_weights=cw)
        torch.cuda.synchronize()
        wall = time.time() - t0
    n_steps = len(stream)
    d_ms, kernels = profile_split(torch, prof, n_steps)
    out.update(stream_wall_s=wall, stream_idle=1 - d_ms * n_steps / 1e3 / wall,
               stream_vols_per_s=2 * len(tr_val) / wall)
    log(f"  (a) streamed epoch of {len(tr_val)} subjects ({n_steps} steps, 8 decode threads): "
        f"{wall:.2f} s, {out['stream_vols_per_s']:.1f} vols/s (MRI + PET); the card idles "
        f"{out['stream_idle']:.1%} (profiler on over the epoch)")
    del state, model, raw

    # (b) --arch daft --use-table, one epoch
    daft_dir = os.path.join(root, "daft")
    fg.gather_normalize.launches = 0
    t0 = time.time()
    best_d = cli_fusion.main(["--arch", "daft", "--use-table", "--table", table, "--device",
                              "cuda", "num_epochs=1", f"label_file={csv_path}",
                              f"mri_dir={mri}", f"batch_size={BATCH}", "compute_dtype=bfloat16",
                              "n_splits=2", "lr=1e-3", f"checkpoint_dir={daft_dir}"])
    torch.cuda.synchronize()
    out.update(daft_cli_s=time.time() - t0, daft_k1_launches=fg.gather_normalize.launches,
               daft_best=best_d)
    log(f"  (b) cli.train_fusion --arch daft --use-table, 2 folds x 1 epoch: "
        f"{out['daft_cli_s']:.1f} s, best fold scores {[round(b, 4) for b in best_d]}, K1 "
        f"launches {out['daft_k1_launches']} (expected {batches})")
    check(out["daft_k1_launches"] == batches and all(np.isfinite(best_d)),
          "the DAFT run did not complete")

    # (c) the JAX package's TestFusionLearning at its small widths and 16^3
    sep = os.path.join(root, "sep")
    c_csv, c_mri, c_pet = make_adni_dir(sep, n_per_class=24, classes=("AD", "CN"),
                                        shape=(16, 16, 16), seed=9, pet=True,
                                        extent_jitter=0.3, center_jitter=0.04, noise=0.25)
    m = ADNIManifest(c_csv, c_mri, "ADCN", pet_dir=c_pet, verbose=False).data_dict
    rng = np.random.default_rng(0)
    y = np.asarray([r["label"] for r in m])
    tX = (rng.normal(size=(len(m), 6)) + 1.5 * y[:, None]).astype(np.float32)
    lcfg = Config(label_file=c_csv, mri_dir=c_mri, pet_dir=c_pet, task="ADCN", num_epochs=20,
                  batch_size=4, lr=1e-3, n_splits=2, checkpoint_dir=os.path.join(sep, "ckpt"),
                  compute_dtype="float32", loader_threads=2)
    kw = dict(use_pet=True, use_table=True, table_data=(tX, y, [r["Subject"] for r in m]),
              model_kw=dict(dim=16, depth=1, heads=2, dim_head=8, mlp_dim=32),
              embedder=ICLClassifier(), device="cuda", verbose=False)
    t0 = time.time()
    with deterministic_cudnn():  # the same result in every run on this card
        lbest, _ = fusion.train_fusion_cv(lcfg, records=m, **kw)
        l_tr, l_te = stratified_test_split(m, lcfg.split_ratio, lcfg.seed)
        res = fusion.test_fusion_models(lcfg, l_te, train_subjects=[r["Subject"] for r in l_tr],
                                        **kw)
    out.update(learn_best=lbest, learn_test_auc=res["avg"]["AUC"], learn_s=time.time() - t0)
    log(f"  (c) TestFusionLearning's recipe (48 subjects at 16^3, dim 16, 20 epochs, batch 4, "
        f"fp32, cuDNN deterministic; the table embedder ICLClassifier() on the bundled asset "
        f"in place of the JAX test's sklearn LogisticRegression): best fold scores "
        f"{[round(b, 4) for b in lbest]} (bar 0.8 each), held-out fold-mean AUC "
        f"{res['avg']['AUC']:.4f} (bar 0.85); {out['learn_s']:.1f} s")
    check(all(b >= 0.8 for b in lbest), f"fusion fold scores {lbest} below 0.8")
    check(res["avg"]["AUC"] >= 0.85, f"fusion held-out AUC {res['avg']['AUC']} below 0.85")

    # (d) card against host, fp32, the same weights and inputs at full size
    g = torch.Generator().manual_seed(SEED + 62)
    inputs = {"image": torch.randn((2, *VOL_SHAPE, 1), generator=g) * 50 + 100,
              "pet": torch.randn((2, *VOL_SHAPE, 1), generator=g) * 20 + 40,
              "table": torch.randn((2, table_dim), generator=g)}
    for name, make, args in (
            ("MultimodalClassifier (MRI + PET + table, dim 128, depth 2)",
             lambda: MultimodalClassifier(dim=128, depth=2, use_pet=True, use_table=True,
                                          table_dim=table_dim, compute_dtype=torch.float32,
                                          generator=torch.Generator().manual_seed(SEED)),
             lambda d: ((inputs["image"].to(d),),
                        {"pet": inputs["pet"].to(d), "table": inputs["table"].to(d)})),
            ("DAFTResNet (layers 1/1/1/1)",
             lambda: DAFTResNet(table_dim=table_dim, compute_dtype=torch.float32,
                                generator=torch.Generator().manual_seed(SEED)),
             lambda d: ((inputs["image"].to(d), inputs["table"].to(d)), {}))):
        host = make().eval()
        card_m = make().to(dev).eval()
        with torch.no_grad():
            a, k = args("cpu")
            ref = host(*a, **k)
            a, k = args(dev)
            got = card_m(*a, **k).cpu()
        spread = float(ref.max() - ref.min())
        err = float((got - ref).abs().max())
        log(f"  (d) {name}, fp32, B=2 at {'x'.join(map(str, VOL_SHAPE))}, eval: card vs host "
            f"max |d| {err:.3g} "
            f"against a logits spread of {spread:.4g} (bound 1e-3 of the spread)")
        check(err <= 1e-3 * max(spread, 1e-6), f"{name} card vs host {err}")
        out[f"card_vs_host_{name.split()[0]}"] = (err, spread)
    out["seconds"] = time.time() - t_phase
    log(f"  phase 17 took {out['seconds']:.1f} s ({card})")
    return out


META_SHAP_FEATURES, META_SHAP_SAMPLES = 12, 4  # 2^12 = 4,096 coalitions: one chunk a sample
META_MC_FEATURES, META_MC_DRAWS, META_MC_SAMPLES = 20, 16, 2
META_TRIALS, META_SPLITS, META_HOST_TRIALS = 8, 3, 2
META_ECOC_CLASSES, META_ECOC_ROWS, META_ECOC_FEATURES = 14, 700, 20
META_REG_TRIALS = 4
AD = TAB_CLASSES.index("AD")  # the class whose probability is attributed


def _agreeing_profile(torch, fn, n, tries=5):
    """(device ms a call, device kernels and copies a call) over `n` calls of
    `fn()` under torch.profiler, taken from a profile whose
    device time the one before it confirms within 10 %; after `tries`
    profiles with no such pair the phase fails. Device time, not the kernel
    count, is compared: on the card the count of one Shapley chunk read 142,
    162 and 199 across runs while its device time stayed at 116-122 ms."""
    seen = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        dev_ms, launches = profile_split(torch, prof, n)
        if seen and abs(dev_ms - seen[-1]) <= 0.1 * max(dev_ms, seen[-1]):
            return dev_ms, launches
        seen.append(dev_ms)
    check(False, f"profiles of the same call read {seen} ms of device time: the profiler "
                 "lost events, so no idle share is measured")


class _LoggedTuned:
    """Mixin over a tuned estimator: records each CV call's (trial, seed,
    fold scores) in `calls_` (the search's trials first, then the guard's
    re-scores)."""

    def _cv_scores(self, X, y, trial, seed):
        scores = super()._cv_scores(X, y, trial, seed)
        self.__dict__.setdefault("calls_", []).append((trial, seed, list(scores)))
        return scores


def meta_estimators_phase(torch, dev, card, work):
    """Phase 18: the tabular meta-estimators over the classifier asset on the
    card (Shapley values, TPE-guarded tuning, the greedy and seed ensembles,
    ECOC, the tuned regressor), each against the host."""
    from multimodal_ad_tpu_torch.data.tabular import load_adni_table
    from multimodal_ad_tpu_torch.tabular import (AutoICLClassifier, ICLClassifier,
                                                 ManyClassClassifier, SeedEnsembleICL,
                                                 TunedICLClassifier, TunedICLRegressor)
    from multimodal_ad_tpu_torch.tabular.estimator import train_test_split
    from multimodal_ad_tpu_torch.tabular.icl import ICLTransformer
    from multimodal_ad_tpu_torch.tabular.interpretability import shapley_values
    from multimodal_ad_tpu_torch.tabular.scoring import safe_roc_auc_score, score_regression

    # the card's machine has none of these; hold the path to that here too
    for name in ("sklearn", "pandas", "matplotlib", "flax", "msgpack"):
        sys.modules[name] = None
    out = {}
    t_phase = time.time()
    log(f"== 18. tabular meta-estimators over the classifier asset (d_model 256, 6 layers, "
        f"192 features, 10 classes, 512 context rows) on phase 15's table")
    tab_dir = os.path.join(work, "tabular")
    os.makedirs(tab_dir, exist_ok=True)
    table = os.path.join(tab_dir, "ADNI_Tabel_meta.csv")
    make_clinical_table(table)
    X, y, _ = load_adni_table(table, label_col="Group", classes=TAB_CLASSES, start_col=14)
    X_tr, X_te, y_tr, y_te = train_test_split(X, y, test_size=0.2, random_state=42,
                                              stratify=y)
    numeric = numeric_columns(X)

    def filled(cols):
        """Train and test columns with their blanks at the train median:
        a coalition's absent features take the background mean."""
        med = np.nanmedian(X_tr[:, cols], axis=0)
        return [np.where(np.isnan(a[:, cols]), med, a[:, cols]).astype(np.float32)
                for a in (X_tr, X_te)]

    # (a) Shapley values: exact over 12 features, one 4,096-row chunk a sample
    S_tr, S_te = filled(numeric[:META_SHAP_FEATURES])
    clf = ICLClassifier().fit(S_tr, y_tr)
    rows = S_te[:META_SHAP_SAMPLES]
    shap = lambda est, r: shapley_values(est, r, background=S_tr, class_index=AD)  # noqa: E731
    shap(clf, rows[:1])  # the first 4,096-query forward: allocations, cuBLAS plans
    t0 = time.perf_counter()
    phi = shap(clf, rows)
    per_sample = (time.perf_counter() - t0) / len(rows)
    gap = clf.predict_proba(rows)[:, AD] - clf.predict_proba(
        S_tr.mean(axis=0, keepdims=True))[0, AD]
    eff = float(np.abs(phi.sum(axis=1) - gap).max())
    dev_ms, kernels = _agreeing_profile(torch, lambda: shap(clf, rows[:1]), 2)
    idle = 1 - dev_ms / (per_sample * 1e3)
    t0 = time.perf_counter()
    host = ICLClassifier(device="cpu").fit(S_tr, y_tr)
    hphi = shap(host, rows[:1])
    host_s = time.perf_counter() - t0
    spread = float(hphi.max() - hphi.min())
    d_phi = float(np.abs(phi[:1] - hphi).max())
    log(f"  (a) exact Shapley values of P({TAB_CLASSES[AD]}) over {META_SHAP_FEATURES} "
        f"numeric features, {META_SHAP_SAMPLES} samples, preprocess_ {clf.preprocess_!r}: "
        f"{per_sample:.3f} s a sample (2^{META_SHAP_FEATURES} = "
        f"{1 << META_SHAP_FEATURES} coalitions, one predict_proba chunk of 8 views x "
        f"{1 << META_SHAP_FEATURES} queries); {kernels:.0f} device kernels and copies a chunk, "
        f"{dev_ms:.1f} ms of device time: the card idles {idle:.1%}")
    log(f"  (a) efficiency: |sum phi - (f(x) - f(background))| <= {eff:.3g} (bound 1e-5); "
        f"the host CPU on sample 0 ({host_s:.1f} s with its fit): max |d| {d_phi:.3g} "
        f"against a spread of {spread:.4g} (bound 1e-4 of it)")
    check(eff <= 1e-5, f"Shapley efficiency {eff}")
    check(host.preprocess_ == clf.preprocess_, "Shapley classifier preprocess_ card != host")
    check(d_phi <= 1e-4 * spread, f"Shapley values card vs host {d_phi}")
    M_tr, M_te = filled(numeric[:META_MC_FEATURES])
    mclf = ICLClassifier().fit(M_tr, y_tr)
    t0 = time.perf_counter()
    mphi = shapley_values(mclf, M_te[:META_MC_SAMPLES], background=M_tr, class_index=AD,
                          n_draws=META_MC_DRAWS)
    mc_s = time.perf_counter() - t0
    mgap = mclf.predict_proba(M_te[:META_MC_SAMPLES])[:, AD] - mclf.predict_proba(
        M_tr.mean(axis=0, keepdims=True))[0, AD]
    meff = float(np.abs(mphi.sum(axis=1) - mgap).max())
    log(f"  (a) Monte-Carlo at F = {META_MC_FEATURES}, {META_MC_DRAWS} permutations a sample "
        f"(one call of {META_MC_FEATURES + 1} coalitions each), {META_MC_SAMPLES} samples: "
        f"{mc_s:.2f} s; efficiency {meff:.3g} (bound 1e-5)")
    check(meff <= 1e-5, f"Monte-Carlo Shapley efficiency {meff}")
    out.update(shap_s_per_sample=per_sample, shap_kernels_per_chunk=kernels,
               shap_device_ms_per_chunk=dev_ms, shap_idle=idle, shap_efficiency=eff,
               shap_card_vs_host=d_phi, shap_spread=spread, shap_host_s=host_s,
               shap_mc_s=mc_s, shap_mc_efficiency=meff)

    # (b) TunedICLClassifier on the 464 / 116 split
    class Tuned(_LoggedTuned, TunedICLClassifier):
        pass

    timer = _PathTimer(torch, {"fit": (ICLClassifier, "fit", False),
                               "forward": (ICLTransformer, "forward", True)})
    with timer:
        t0 = time.perf_counter()
        tuned = Tuned(n_trials=META_TRIALS, n_splits=META_SPLITS).fit(X_tr, y_tr)
        tuned_s = time.perf_counter() - t0
    proba = tuned.predict_proba(X_te)
    auc = safe_roc_auc_score(y_te, proba)
    fits = timer.calls["fit"]
    n_cv = len(tuned.calls_)
    trials = [c[0] for c in tuned.calls_[:META_TRIALS + 1]]
    rescores = n_cv - (META_TRIALS + 1)
    prof_trial = trials[1]
    cv_ms = statistics.median(_timed_ms(lambda: tuned._cv_scores(
        X_tr, y_tr, prof_trial, 0)) for _ in range(2))
    cv_dev_ms, cv_kernels = _agreeing_profile(
        torch, lambda: tuned._cv_scores(X_tr, y_tr, prof_trial, 0), 2)
    cv_idle = 1 - cv_dev_ms / cv_ms
    log(f"  (b) TunedICLClassifier(n_trials={META_TRIALS}, n_splits={META_SPLITS}) on "
        f"{len(X_tr)} / {len(X_te)}: {tuned_s:.2f} s, {fits} ICLClassifier fits "
        f"({fits / tuned_s:.1f} fits/s; the auto preprocess's holdout fits included), "
        f"{timer.calls['forward']} forwards ({timer.seconds['forward']:.2f} s to their "
        f"syncs), {n_cv} CV runs ({rescores} of them the guard's re-scores)")
    for t, c in enumerate(tuned.calls_[:META_TRIALS + 1]):
        log(f"      trial {t}: {c[0]} -> {np.mean(c[2]):.4f}")
    log(f"  (b) best_params_ {tuned.best_params_}, best_score_ {tuned.best_score_:.4f}, "
        f"test macro AUC {auc:.4f}; one CV run of trial 1 ({META_SPLITS} fits + "
        f"predicts): {cv_ms:.0f} ms, {cv_kernels:.0f} device kernels and copies, "
        f"{cv_dev_ms:.1f} ms of device time: the card idles {cv_idle:.1%}")
    check(np.isfinite(auc) and np.isfinite(tuned.best_score_), "tuned classifier AUC")
    check(len(trials) == META_TRIALS + 1 and trials[0] is None, f"trials {trials}")
    small = {}
    for where in ("card", "cpu"):
        kw = {} if where == "card" else {"base_estimator": ICLClassifier(device="cpu")}
        t0 = time.perf_counter()
        est = Tuned(n_trials=META_HOST_TRIALS, n_splits=META_SPLITS, **kw).fit(X_tr, y_tr)
        small[where] = (est, time.perf_counter() - t0)
    (c2, c2_s), (h2, h2_s) = small["card"], small["cpu"]
    same_trials = [c[:2] for c in c2.calls_] == [c[:2] for c in h2.calls_]
    d_scores = float(max(np.abs(np.subtract(a[2], b[2])).max()
                         for a, b in zip(c2.calls_, h2.calls_)))
    d_tuned = float(np.abs(c2.predict_proba(X_te) - h2.predict_proba(X_te)).max())
    log(f"  (b) n_trials={META_HOST_TRIALS}, card {c2_s:.2f} s / host CPU {h2_s:.2f} s: the "
        f"same {len(c2.calls_)} CV runs (trials and seeds): {same_trials}; fold scores max "
        f"|d| {d_scores:.3g}; best_params_ {c2.best_params_} (host {h2.best_params_}); "
        f"probabilities max |d| {d_tuned:.3g} (bound 1e-4)")
    check(same_trials, "tuned classifier: trials differ card vs host")
    check(c2.best_params_ == h2.best_params_, "tuned classifier: the pick differs")
    check(d_tuned <= 1e-4, f"tuned classifier probabilities card vs host {d_tuned}")
    out.update(tuned_s=tuned_s, tuned_fits=fits, tuned_fits_per_s=fits / tuned_s,
               tuned_forwards=timer.calls["forward"], tuned_cv_runs=n_cv,
               tuned_rescores=rescores, tuned_trials=[str(t) for t in trials],
               tuned_best_params=str(tuned.best_params_), tuned_best_score=tuned.best_score_,
               tuned_test_auc=auc, tuned_cv_ms=cv_ms, tuned_cv_device_ms=cv_dev_ms,
               tuned_cv_kernels=cv_kernels, tuned_cv_idle=cv_idle,
               tuned_small_card_s=c2_s, tuned_small_host_s=h2_s,
               tuned_card_vs_host=d_tuned, tuned_scores_card_vs_host=d_scores)

    # (c) AutoICLClassifier and SeedEnsembleICL
    t0 = time.perf_counter()
    auto = AutoICLClassifier(n_configs=4).fit(X_tr, y_tr)
    auto_s = time.perf_counter() - t0
    auto_auc = safe_roc_auc_score(y_te, auto.predict_proba(X_te))
    t0 = time.perf_counter()
    seeds = SeedEnsembleICL(n_members=4).fit(X_tr, y_tr)
    seed_s = time.perf_counter() - t0
    seed_auc = safe_roc_auc_score(y_te, seeds.predict_proba(X_te))
    log(f"  (c) AutoICLClassifier(n_configs=4): {auto_s:.2f} s, greedy weights "
        f"{np.round(auto.ensemble_.weights_, 4).tolist()} over [default] + 4 configs, "
        f"{len(auto.members_)} members refit; test macro AUC {auto_auc:.4f}")
    log(f"  (c) SeedEnsembleICL(n_members=4): {seed_s:.2f} s, seeds "
        f"{[m.seed for m in seeds.members_]}; test macro AUC {seed_auc:.4f}")
    check(np.isfinite(auto_auc) and np.isfinite(seed_auc), "ensemble AUC not finite")
    out.update(auto_s=auto_s, auto_weights=auto.ensemble_.weights_.tolist(),
               auto_test_auc=auto_auc, seed_ensemble_s=seed_s, seed_ensemble_test_auc=seed_auc)

    # (d) ECOC beyond the asset's 10 classes, and the tuned regressor
    g = np.random.default_rng(SEED + 18)
    centers = g.normal(size=(META_ECOC_CLASSES, META_ECOC_FEATURES)) * 1.5
    ye = g.integers(0, META_ECOC_CLASSES, META_ECOC_ROWS)
    Xe = (centers[ye] + g.normal(size=(META_ECOC_ROWS, META_ECOC_FEATURES))).astype(np.float32)
    Xe_tr, Xe_te, ye_tr, ye_te = train_test_split(Xe, ye, test_size=0.2, random_state=42,
                                                  stratify=ye)
    t0 = time.perf_counter()
    ecoc = ManyClassClassifier(ICLClassifier()).fit(Xe_tr, ye_tr)
    ecoc_fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pe = ecoc.predict_proba(Xe_te)
    ecoc_pred_s = time.perf_counter() - t0
    ecoc_acc = float((ecoc.classes_[pe.argmax(1)] == ye_te).mean())
    t0 = time.perf_counter()
    hecoc = ManyClassClassifier(ICLClassifier(device="cpu")).fit(Xe_tr, ye_tr)
    hpe = hecoc.predict_proba(Xe_te)
    hecoc_s = time.perf_counter() - t0
    d_ecoc = float(np.abs(pe - hpe).max())
    log(f"  (d) ManyClassClassifier(ICLClassifier()) on {META_ECOC_CLASSES} classes "
        f"({len(Xe_tr)} / {len(Xe_te)} rows, {META_ECOC_FEATURES} features): codebook "
        f"{ecoc.code_book_.shape}, fit {ecoc_fit_s:.2f} s, predict {ecoc_pred_s * 1e3:.1f} ms, "
        f"accuracy {ecoc_acc:.4f}; host CPU {hecoc_s:.1f} s: the same codebook "
        f"{np.array_equal(ecoc.code_book_, hecoc.code_book_)}, probabilities max |d| "
        f"{d_ecoc:.3g} (bound 1e-4)")
    check(ecoc.code_book_ is not None and ecoc.code_book_.shape[0] == META_ECOC_CLASSES,
          "ECOC codebook")
    check(np.array_equal(ecoc.code_book_, hecoc.code_book_), "ECOC codebook card != host")
    check(d_ecoc <= 1e-4, f"ECOC probabilities card vs host {d_ecoc}")
    _, target = regression_target(X)
    tr, te = train_test_split(np.arange(len(X)), test_size=0.2, random_state=42)
    t0 = time.perf_counter()
    treg = TunedICLRegressor(n_trials=META_REG_TRIALS).fit(X[tr], target[tr])
    treg_s = time.perf_counter() - t0
    r2 = score_regression("r2", target[te], treg.predict(X[te]))
    log(f"  (d) TunedICLRegressor(n_trials={META_REG_TRIALS}) on phase 15 (d)'s target: "
        f"{treg_s:.2f} s, best_params_ {treg.best_params_}, best_score_ (RMSE) "
        f"{treg.best_score_:.4f}, test R^2 {r2:.4f}")
    check(np.isfinite(r2), "tuned regressor R^2 not finite")
    out.update(ecoc_codebook=list(ecoc.code_book_.shape), ecoc_fit_s=ecoc_fit_s,
               ecoc_predict_s=ecoc_pred_s, ecoc_acc=ecoc_acc, ecoc_host_s=hecoc_s,
               ecoc_card_vs_host=d_ecoc, tuned_reg_s=treg_s,
               tuned_reg_best_params=str(treg.best_params_), tuned_reg_test_r2=r2)
    out["seconds"] = time.time() - t_phase
    log(f"  phase 18 took {out['seconds']:.1f} s ({card})")
    return out


def adam_rule(torch, a, b, lr0, u_bound=1e-5):
    """`a` against `b`, two TrainStates after one step from the same weights
    (the rule of tests/test_torch_port_fusion.py::test_one_train_step_
    matches_jax): Adam's first update moves an element by lr u / (|u| +
    eps), u the clipped gradient plus wd p; the first moments / (1 - b1)
    must agree within `u_bound` of u's global norm; where |u| exceeds ten
    times both the disagreement and eps, the parameters within lr / 50,
    elsewhere within 2 lr, at most 10 % of the elements. Returns the
    numbers."""
    pa, pb = dict(a.model.named_parameters()), dict(b.model.named_parameters())
    ua = {k: a.optimizer.state[p]["exp_avg"].double() / 0.1 for k, p in pa.items()}
    ub = {k: b.optimizer.state[p]["exp_avg"].double() / 0.1 for k, p in pb.items()}
    u_norm = math.sqrt(sum(float((v ** 2).sum()) for v in ub.values()))
    du = max(float((ua[k] - ub[k]).abs().max()) for k in ub)
    big_max = loose_max = stats_max = 0.0
    n_loose = n_all = 0
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for k, ref in sb.items():
        if "num_batches" in k:
            continue
        d = (sa[k].double() - ref.double()).abs()
        if k not in ub:
            stats_max = max(stats_max, float(d.max()))
            continue
        big = ub[k].abs() > 10 * torch.clamp((ua[k] - ub[k]).abs(), min=1e-8)
        if big.any():
            big_max = max(big_max, float(d[big].max()))
        if (~big).any():
            loose_max = max(loose_max, float(d[~big].max()))
        n_loose += int((~big).sum())
        n_all += d.numel()
    out = {"du": du, "u_norm": u_norm, "du_rel": du / u_norm, "big_max_over_lr": big_max / lr0,
           "loose_max_over_lr": loose_max / lr0, "loose_share": n_loose / n_all,
           "bn_stats_max": stats_max}
    out["u_bound"] = u_bound
    out["ok"] = bool(du <= u_bound * u_norm and big_max <= lr0 / 50 and loose_max <= 2 * lr0
                     and n_loose <= 0.1 * n_all and stats_max <= 1e-4)
    return out


# Phase 19 (b)'s bound on the first moments of a W = 2 step against one
# process's, as a share of their norm. At full width the fp32 step itself is
# 1.2e-4 of the norm from a float64 step (the stem's weight gradient sums
# ~3.6 M products an element; scripts/dp_step_precision.py), and W = 2
# against one process measured 7.1e-5 to 8.5e-5: the CPU tests' 1e-5 holds
# only at their small sizes, so the card holds the W = 2 step within 8
# times the fp32 step's own error.
W2_U_BOUND = 1e-3

# The mesh-less predictor forwards a ragged chunk at its bucket, where cuDNN
# may take other algorithms than at the whole batch: its probabilities are
# held to the chunk padded to the batch within BUCKET_BOUND (phase 4's folds
# on an H100, phases 19 and 20 in two runs: 9.7e-5 and 3.8e-4, where the
# rows' probabilities span 0.011). The mesh path pads every chunk to the
# batch, so it is held to that answer bit for bit.
BUCKET_BOUND = 1e-3


def _padded_proba(torch, pred, vols):
    """The predictor's probabilities with every chunk padded to the whole
    batch and forwarded there, as before the buckets."""
    bs, out = pred.batch_size, []
    for i in range(0, len(vols), bs):
        chunk = torch.from_numpy(np.ascontiguousarray(vols[i:i + bs])).to(pred.device)
        out.append(pred.forward(pred._prep(chunk, True))[:len(chunk)].cpu().numpy())
    return np.concatenate(out, axis=0)


def _bucket_gaps(plain, padded, full):
    """Whether the full chunks equal the padded answer, and the ragged
    chunk's largest distance from it."""
    same = bool(np.array_equal(plain[:full], padded[:full]))
    return same, float(np.abs(plain[full:] - padded[full:]).max(initial=0.0))


def _dp_fresh_state(torch, dev, sd, mesh, spatial=False, remat=False):
    from multimodal_ad_tpu_torch.models.resnet3d import ResNet3D
    from multimodal_ad_tpu_torch.train import loop

    model = ResNet3D(depth=18, dropout_rate=0.0, compute_dtype=torch.float32, remat=remat)
    model.load_state_dict(sd)
    return loop.create_train_state(model.to(dev), loop.make_epoch_schedule(1e-3, 20), mesh=mesh,
                                   spatial=spatial)


def _timed_steps(torch, state, batch, cw, n=14, warmup=2):
    """Median ms of `n` train steps on one batch (CUDA events, after
    `warmup`)."""
    from multimodal_ad_tpu_torch.train import loop

    times = []
    for i in range(warmup + n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        loop.train_step(state, batch, cw)
        b.record()
        if i >= warmup:
            times.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in times)


def _dp_rank(rank, world, store, args_path, out_dir):
    """One of phase 19's two gloo ranks, both on cuda:0: (b) the fp32 DP
    step, full and ragged, against the one-process step (rank 0); (e) U-Net
    extraction; (d) the int8 ensemble. Saves its results."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from multimodal_ad_tpu_torch.data.device_cache import DeviceDataset, DeviceEpochIterator
    from multimodal_ad_tpu_torch.eval.features import extract_unet_features
    from multimodal_ad_tpu_torch.ops import fused_gather as fg
    from multimodal_ad_tpu_torch.ops import int8_conv as k3
    from multimodal_ad_tpu_torch.ops import roi_pool as rp
    from multimodal_ad_tpu_torch.parallel import mesh as pmesh
    from multimodal_ad_tpu_torch.serve import EnsemblePredictor
    from multimodal_ad_tpu_torch.train import loop

    dev = pmesh.init_distributed(backend="gloo", device="cuda:0",
                                 init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        a = torch.load(args_path, weights_only=False)
        mesh = pmesh.make_mesh()
        sd = torch.load(a["sd"], weights_only=False)
        vols8, labels8 = np.load(a["vols8"]), a["labels8"]
        cw = torch.tensor([0.5, 0.5], device=dev)
        lr0 = loop.make_epoch_schedule(1e-3, 20)(0)
        res = {"rank": rank, "mesh": pmesh.data_size(mesh)}
        ds = DeviceDataset(vols8, labels8, device=dev, store_dtype=np.float32, mesh=mesh)
        for name, idx in (("full", np.arange(BATCH)), ("ragged", np.arange(5))):
            fg.gather_normalize.launches = 0
            batch = next(iter(DeviceEpochIterator(ds, idx, BATCH)))  # this rank's rows, K1
            torch.cuda.synchronize()
            r = {"k1": fg.gather_normalize.launches, "rows": int(batch["image"].shape[0]),
                 "real": float(batch["mask"].sum())}
            state = _dp_fresh_state(torch, dev, sd, mesh)
            loss, _ = loop.train_step(state, batch, cw)
            r["loss"] = float(loss)
            r["param_sums"] = [float(p.detach().double().sum())
                               for p in state.model.parameters()]
            r["buffer_sums"] = [float(b.double().sum()) for b in state.model.buffers()]
            if rank == 0:  # the one-process step at the global batch
                ds1 = DeviceDataset(vols8, labels8, device=dev, store_dtype=np.float32)
                ref_state = _dp_fresh_state(torch, dev, sd, None)
                ref_loss, _ = loop.train_step(ref_state, next(iter(
                    DeviceEpochIterator(ds1, idx, BATCH))), cw)
                r["ref_loss"] = float(ref_loss)
                r["check"] = adam_rule(torch, state, ref_state, lr0, W2_U_BOUND)
                del ref_state, ds1
            if name == "full":
                r["step_ms"] = _timed_steps(torch, state, batch, cw, n=6, warmup=1)
            res[name] = r
            del state
            torch.cuda.empty_cache()

        fg.gather_normalize.launches = rp.roi_pool.launches = 0
        extract_unet_features(a["records8"], a["atlas_labels"], a["roi_names"], a["out_w2"],
                              batch_size=BATCH, num_threads=a["threads"], seed=a["seed"],
                              device=dev, mesh=mesh)
        torch.cuda.synchronize()
        res["extraction"] = {"k1": fg.gather_normalize.launches, "k2": rp.roi_pool.launches}
        torch.cuda.empty_cache()

        pred = EnsemblePredictor.from_checkpoint_dir(a["ckpt_dir"], batch_size=BATCH,
                                                     device=dev, mesh=mesh)
        vols = np.load(a["vols"])
        fg.gather_normalize.launches = 0
        bf16 = pred.predict_proba(vols)
        k1 = fg.gather_normalize.launches
        pred.quantize_int8(vols[:4])
        fg.gather_normalize.launches = k3.conv_i8.launches = 0
        q8 = pred.predict_proba(vols)
        torch.cuda.synchronize()
        res["predictor"] = {"bf16": bf16, "int8": q8, "k1_bf16": k1,
                            "k1_int8": fg.gather_normalize.launches,
                            "k3": k3.conv_i8.launches}
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def data_parallel_phase(torch, dev, card, work, ctx):
    """Phase 19: the mesh path at full width (see the module docstring)."""
    import importlib
    import re

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from multimodal_ad_tpu_torch import examples
    from multimodal_ad_tpu_torch.core.config import Config
    from multimodal_ad_tpu_torch.data.device_cache import DeviceDataset, DeviceEpochIterator
    from multimodal_ad_tpu_torch.data.pipeline import load_volume
    from multimodal_ad_tpu_torch.entry import dryrun_multichip, entry
    from multimodal_ad_tpu_torch.eval.features import extract_unet_features
    from multimodal_ad_tpu_torch.models.resnet3d import generate_model
    from multimodal_ad_tpu_torch.ops import fused_gather as fg
    from multimodal_ad_tpu_torch.ops import int8_conv as k3
    from multimodal_ad_tpu_torch.ops import roi_pool as rp
    from multimodal_ad_tpu_torch.parallel import mesh as pmesh
    from multimodal_ad_tpu_torch.serve import EnsemblePredictor
    from multimodal_ad_tpu_torch.train import loop

    t_phase = time.time()
    log(f"== 19. data parallel: ResNet-18 fp32 at 91x109x91, global batch {BATCH}; "
        "W = 1 on NCCL, W = 2 on gloo with both ranks on cuda:0")
    dpw = os.path.join(work, "dp")
    os.makedirs(dpw)
    out = {}
    launches = {"K1": {}, "K2": {}, "K3": {}}
    tr_val = ctx["tr_val"]
    vols8 = np.stack([load_volume(r["MRI"]) for r in tr_val[:BATCH]])[..., None]
    labels8 = np.array([r["label"] for r in tr_val[:BATCH]])
    sd = generate_model(model_depth=18, dropout_rate=0.0, compute_dtype=torch.float32,
                        generator=torch.Generator().manual_seed(SEED + 19)).state_dict()
    cw = torch.tensor([0.5, 0.5], device=dev)
    lr0 = loop.make_epoch_schedule(1e-3, 20)(0)
    defaults = Config()
    records8 = ctx["ext_records"][:BATCH]

    # ---- (a), (d), (e) at W = 1 on NCCL, in this process -----------------
    pmesh.init_distributed(device="cuda", init_method=f"file://{dpw}/store_w1",
                           rank=0, world_size=1)
    check(dist.get_backend() == "nccl", f"W = 1 runs {dist.get_backend()}, not nccl")
    mesh = pmesh.make_mesh()
    ds = DeviceDataset(vols8, labels8, store_dtype=np.float32, mesh=mesh)
    fg.gather_normalize.launches = 0
    batch = next(iter(DeviceEpochIterator(ds, np.arange(BATCH), BATCH)))
    torch.cuda.synchronize()
    launches["K1"]["w1_nccl_step"] = fg.gather_normalize.launches
    plain, dp = (_dp_fresh_state(torch, dev, sd, m) for m in (None, mesh))
    l_plain = float(loop.train_step(plain, batch, cw)[0])
    l_dp = float(loop.train_step(dp, batch, cw)[0])
    a_check = adam_rule(torch, dp, plain, lr0)
    ms_plain = _timed_steps(torch, plain, batch, cw)
    ms_dp = _timed_steps(torch, dp, batch, cw)
    out["w1"] = dict(a_check, loss_dp=l_dp, loss_plain=l_plain, step_ms_plain=ms_plain,
                     step_ms_dp=ms_dp, ddp_overhead_ms=ms_dp - ms_plain,
                     ddp_overhead_pct=100 * (ms_dp - ms_plain) / ms_plain,
                     vols_per_s_dp=BATCH / (ms_dp / 1e3))
    log(f"(a) W = 1 NCCL DP step against the plain step, same weights and batch: loss "
        f"{l_dp:.6f} vs {l_plain:.6f}; first moments max |du| {a_check['du']:.3g} "
        f"({a_check['du_rel']:.3g} of |u| {a_check['u_norm']:.4g}; bound 1e-5); parameters "
        f"max |d| {a_check['big_max_over_lr']:.3g} lr where |u| is large (bound 0.02), "
        f"{a_check['loose_max_over_lr']:.3g} lr elsewhere (bound 2, "
        f"{100 * a_check['loose_share']:.3f} % of them); BN statistics {a_check['bn_stats_max']:.3g}")
    log(f"    step ms (CUDA events, median of 14 after 2): plain {ms_plain:.2f}, DDP "
        f"{ms_dp:.2f}: overhead {ms_dp - ms_plain:.2f} ms "
        f"({out['w1']['ddp_overhead_pct']:.1f} %) on {card}")
    check(a_check["ok"] and abs(l_dp - l_plain) <= 1e-6 * abs(l_plain),
          f"W = 1 DP step differs from the plain step: {a_check}, {l_dp} vs {l_plain}")
    del plain, dp
    # the flagship's training precision (bf16 autocast), as phase 8 times it
    bf = {}
    for m, tag in ((None, "plain"), (mesh, "dp")):
        model = generate_model(model_depth=18, compute_dtype=torch.bfloat16,
                               generator=torch.Generator().manual_seed(SEED + 12)).to(dev)
        st = loop.create_train_state(model, loop.make_epoch_schedule(1e-3, 20),
                                     dropout_seed=SEED + 12, mesh=m)
        bf[tag] = _timed_steps(torch, st, batch, cw)
        del st, model
    out["w1"].update(bf16_step_ms_plain=bf["plain"], bf16_step_ms_dp=bf["dp"],
                     bf16_vols_per_s_dp=BATCH / (bf["dp"] / 1e3))
    log(f"    bf16 autocast: plain {bf['plain']:.2f} ms, DDP {bf['dp']:.2f} ms a step: "
        f"{BATCH / (bf['dp'] / 1e3):.2f} vols/s at W = 1 against phase 8's "
        f"{ctx['train_rate']:.2f} (its resident augmented step) in this call")
    del ds, batch
    torch.cuda.empty_cache()

    vols = ctx["vols"]
    res_d = {}
    for m, tag in ((None, "plain"), (mesh, "mesh")):
        pred = EnsemblePredictor.from_checkpoint_dir(ctx["ckpt_dir"], batch_size=BATCH, mesh=m)
        fg.gather_normalize.launches = 0
        bf16 = pred.predict_proba(vols)
        k1_bf16 = fg.gather_normalize.launches
        if m is None:
            pad_bf16 = _padded_proba(torch, pred, vols)
        pred.quantize_int8(vols[:4])
        fg.gather_normalize.launches = k3.conv_i8.launches = 0
        q8 = pred.predict_proba(vols)
        torch.cuda.synchronize()
        res_d[tag] = (bf16, q8, k1_bf16, fg.gather_normalize.launches, k3.conv_i8.launches)
        if m is None:
            res_d["padded"] = (pad_bf16, _padded_proba(torch, pred, vols))
        del pred
    launches["K1"]["w1_nccl_serving"] = res_d["mesh"][2] + res_d["mesh"][3]
    launches["K3"]["w1_nccl_serving"] = res_d["mesh"][4]
    # the mesh path pads every chunk to the batch: bit-equal to the mesh-less
    # predictor's padded answer; the mesh-less predictor's own buckets: full
    # chunks to the bit, the ragged one within BUCKET_BOUND
    same_bf16, same_int8 = (bool(np.array_equal(res_d["mesh"][k], res_d["padded"][k]))
                            for k in (0, 1))
    gaps = [_bucket_gaps(res_d["plain"][k], res_d["padded"][k], len(vols) // BATCH * BATCH)
            for k in (0, 1)]
    ragged_d = max(g[1] for g in gaps)
    log(f"(d) EnsemblePredictor(mesh=) W = 1, {len(vols)} volumes, 5 folds: bf16 bit-equal "
        f"to the mesh-less predictor's padded answer {same_bf16}, int8 {same_int8}; the "
        f"mesh-less buckets' full chunks bit-equal {all(g[0] for g in gaps)}, the ragged chunk "
        f"max |dprob| {ragged_d:.3g} (bound {BUCKET_BOUND:g}; the rows' bf16 probabilities "
        f"span {np.ptp(res_d['padded'][0][:, 1]):.3g}); K1 {res_d['mesh'][2]} + "
        f"{res_d['mesh'][3]}, K3 {res_d['mesh'][4]} launches")
    check(same_bf16 and same_int8, "the W = 1 mesh predictor differs from the plain one")
    check(all(g[0] for g in gaps) and ragged_d <= BUCKET_BOUND,
          f"the bucketed predictor differs from the padded one: {gaps}")
    torch.cuda.empty_cache()

    out_w1 = os.path.join(dpw, "ext_w1")
    fg.gather_normalize.launches = rp.roi_pool.launches = 0
    extract_unet_features(records8, ctx["atlas_labels"], ctx["roi_names"], out_w1,
                          batch_size=BATCH, num_threads=defaults.loader_threads,
                          seed=defaults.seed, mesh=mesh)
    torch.cuda.synchronize()
    launches["K1"]["w1_nccl_extraction"] = fg.gather_normalize.launches
    launches["K2"]["w1_nccl_extraction"] = rp.roi_pool.launches

    def head_lines(path, n):
        with open(path, "rb") as f:
            return [f.readline() for _ in range(n)]

    same_csv = all(head_lines(os.path.join(out_w1, name), 1 + BATCH)
                   == head_lines(os.path.join(ctx["ext_out1"], name), 1 + BATCH)
                   for name in ("features.csv", "roi_features.csv"))
    log(f"(e) extract_unet_features(mesh=) W = 1 over phase 7's first {BATCH} test subjects: "
        f"CSVs byte-identical to phase 7's rows {same_csv}; K1 "
        f"{launches['K1']['w1_nccl_extraction']}, K2 {launches['K2']['w1_nccl_extraction']}")
    check(same_csv, "the W = 1 mesh extraction wrote other bytes than phase 7")
    dist.destroy_process_group()
    torch.cuda.empty_cache()

    # ---- (b), (d), (e) at W = 2 on gloo, both ranks on cuda:0 -------------
    args = {"sd": os.path.join(dpw, "sd.pt"), "vols8": os.path.join(dpw, "vols8.npy"),
            "labels8": labels8, "vols": os.path.join(dpw, "vols.npy"),
            "ckpt_dir": ctx["ckpt_dir"], "records8": records8,
            "atlas_labels": ctx["atlas_labels"], "roi_names": ctx["roi_names"],
            "out_w2": os.path.join(dpw, "ext_w2"), "threads": defaults.loader_threads,
            "seed": defaults.seed}
    torch.save(sd, args["sd"])
    np.save(args["vols8"], vols8)
    np.save(args["vols"], vols)
    torch.save(args, os.path.join(dpw, "args.pt"))
    t0 = time.time()
    mp.start_processes(_dp_rank, args=(2, os.path.join(dpw, "store_w2"),
                                       os.path.join(dpw, "args.pt"), dpw),
                       nprocs=2, join=True, start_method="spawn")
    w2_s = time.time() - t0
    ranks = [torch.load(os.path.join(dpw, f"rank{r}.pt"), weights_only=False) for r in (0, 1)]
    out["w2"] = {"seconds": w2_s}
    for name in ("full", "ragged"):
        r0, r1 = ranks[0][name], ranks[1][name]
        c = r0["check"]
        equal_ranks = (r0["param_sums"] == r1["param_sums"]
                       and r0["buffer_sums"] == r1["buffer_sums"])
        out["w2"][name] = dict(c, loss=r0["loss"], ref_loss=r0["ref_loss"],
                               ranks_equal=equal_ranks,
                               k1=[r0["k1"], r1["k1"]], rows=[r0["rows"], r1["rows"]],
                               real=[r0["real"], r1["real"]])
        log(f"(b) W = 2 gloo, {name} batch (real rows by rank {r0['real']:.0f} + "
            f"{r1['real']:.0f}): loss {r0['loss']:.6f} vs one process {r0['ref_loss']:.6f}; "
            f"|du| {c['du_rel']:.3g} of |u| (bound {W2_U_BOUND:g}); parameters "
            f"{c['big_max_over_lr']:.3g} "
            f"lr / {c['loose_max_over_lr']:.3g} lr ({100 * c['loose_share']:.3f} % loose); BN "
            f"statistics {c['bn_stats_max']:.3g}; ranks' parameters and buffers equal "
            f"{equal_ranks}; K1 launches by rank {r0['k1']}, {r1['k1']} on "
            f"{r0['rows']} + {r1['rows']} rows")
        check(c["ok"] and abs(r0["loss"] - r0["ref_loss"]) <= 1e-5 * abs(r0["ref_loss"]),
              f"W = 2 {name} step differs from one process: {c}")
        check(equal_ranks, f"the two ranks' models differ after the {name} step")
        check(r0["k1"] == r1["k1"] == 1 and r0["rows"] == r1["rows"] == BATCH // 2,
              f"K1 per rank {r0['k1']}, {r1['k1']} on {r0['rows']}, {r1['rows']} rows")
        for r in (0, 1):
            launches["K1"][f"w2_gloo_rank{r}_step_{name}"] = ranks[r][name]["k1"]
    out["w2"]["step_ms"] = ranks[0]["full"]["step_ms"]
    log(f"    W = 2 gloo step (both ranks on one card, 4 rows each): "
        f"{out['w2']['step_ms']:.1f} ms (CUDA events, median of 6), against "
        f"{ms_plain:.2f} ms for one process at 8 rows")

    ext2 = os.path.join(dpw, "ext_w2")
    worst, same_rows = 0.0, True
    for name in ("features.csv", "roi_features.csv"):
        with open(os.path.join(ext2, name)) as f2, \
                open(os.path.join(ctx["ext_out1"], name)) as f1:
            r2, r1_ = csv.reader(f2), csv.reader(f1)
            for i, (a2, a1) in enumerate(zip(r2, r1_)):
                if i > BATCH:
                    break
                if i == 0 or a2[0] != a1[0]:
                    same_rows &= a2 == a1 if i == 0 else False
                    continue
                worst = max(worst, float(np.abs(np.asarray(a2[1:], np.float64)
                                                - np.asarray(a1[1:], np.float64)).max()))
    for r in (0, 1):
        launches["K1"][f"w2_gloo_rank{r}_extraction"] = ranks[r]["extraction"]["k1"]
        launches["K2"][f"w2_gloo_rank{r}_extraction"] = ranks[r]["extraction"]["k2"]
    out["w2"]["extraction_max_abs"] = worst
    log(f"(e) W = 2 gloo extraction: same header, rows and order as phase 7 {same_rows}, "
        f"max |d| {worst:.3g} (bound 1e-4); K1 / K2 by rank "
        f"{[ranks[r]['extraction']['k1'] for r in (0, 1)]} / "
        f"{[ranks[r]['extraction']['k2'] for r in (0, 1)]}")
    check(same_rows and worst <= 1e-4, f"W = 2 extraction rows {same_rows}, max |d| {worst}")
    check(all(ranks[r]["extraction"]["k1"] == 1 and ranks[r]["extraction"]["k2"] == 1
              for r in (0, 1)), "each rank must run K1 and K2 once on its rows")

    p2 = [ranks[r]["predictor"] for r in (0, 1)]
    d_bf16 = float(np.abs(p2[0]["bf16"] - res_d["plain"][0]).max())
    d_int8 = float(np.abs(p2[0]["int8"] - res_d["plain"][1]).max())
    ranks_same = all(np.array_equal(p2[0][k], p2[1][k]) for k in ("bf16", "int8"))
    for r in (0, 1):
        launches["K1"][f"w2_gloo_rank{r}_serving"] = p2[r]["k1_bf16"] + p2[r]["k1_int8"]
        launches["K3"][f"w2_gloo_rank{r}_serving"] = p2[r]["k3"]
    out["w2"].update(serving_bf16_max_abs=d_bf16, serving_int8_max_abs=d_int8)
    log(f"(d) W = 2 gloo EnsemblePredictor: bf16 max |dprob| {d_bf16:.3g}, int8 "
        f"{d_int8:.3g} (bound 5e-3 each: 4-row batches may take other cuDNN algorithms); "
        f"both ranks return the same array {ranks_same}; K3 by rank {[p['k3'] for p in p2]}")
    check(ranks_same and d_bf16 <= 5e-3 and d_int8 <= 5e-3,
          f"W = 2 serving: ranks equal {ranks_same}, {d_bf16}, {d_int8}")
    check(all(p["k3"] == 19 * N_FOLDS * 2 for p in p2),
          f"int8 serving at W = 2 ran K3 {[p['k3'] for p in p2]} times a rank")
    log(f"    the W = 2 spawn took {w2_s:.1f} s (two processes, both on {card})")

    # ---- (c) cli.train_resnet3d under torch.distributed.run ----------------
    cdir = os.path.join(dpw, "launch_counts")
    ckpt_c = os.path.join(dpw, "train_ckpt")
    argv = [f"label_file={ctx['train_csv']}", f"mri_dir={ctx['train_mri']}", "model_depth=18",
            "resnet_shortcut=B", "compute_dtype=bfloat16", f"batch_size={BATCH}",
            "hbm_cache=true", "augment=true", "precise_bn=true", "normalizer=scale_intensity",
            "n_splits=2", "num_epochs=1", "lr=1e-3", f"checkpoint_dir={ckpt_c}"]
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=1",
         "-m", "multimodal_ad_tpu_torch.cli.train_resnet3d", "--device", "cuda"] + argv,
        cwd=ROOT, env=dict(os.environ, MAD_LAUNCH_COUNTS_DIR=cdir), capture_output=True,
        text=True, timeout=600)
    wall_c = time.time() - t0
    if proc.returncode != 0:
        log(proc.stdout[-4000:])
        log(proc.stderr[-4000:])
    check(proc.returncode == 0, f"torch.distributed.run cli.train_resnet3d exited {proc.returncode}")
    with open(os.path.join(cdir, "launches-rank0.json")) as f:
        counts_c = json.load(f)
    per_epoch = 3 * (-(-(len(tr_val) // 2) // BATCH))
    expect = 2 * per_epoch + 2 * (-(-len(ctx["test_recs"]) // BATCH))
    epoch_s = [float(t) for t in re.findall(r"Fold\d Ep\d+ .* time=([0-9.]+)s", proc.stdout)]
    with open(os.path.join(ckpt_c, "cv_results.csv")) as f:
        rows_c = list(csv.reader(f))
    launches["K1"]["w1_nccl_torchrun_cli"] = counts_c["K1"]
    out["cli"] = {"wall_s": wall_c, "k1": counts_c["K1"], "expected_k1": expect,
                  "epoch_s": epoch_s,
                  "cli_vols_per_s": counts_c["K1"] * BATCH / wall_c,
                  "phase8_cli_vols_per_s": ctx["train_launches"] * BATCH / ctx["train_wall"]}
    log(f"(c) torch.distributed.run --nproc_per_node=1 cli.train_resnet3d (NCCL, 2 folds x 1 "
        f"epoch): {wall_c:.1f} s with process start; K1 {counts_c['K1']} (expected {expect}); "
        f"{len(rows_c) - 1} CSV rows; epoch times as printed {epoch_s} s (fold 1 tunes cuDNN "
        f"in the new process); {out['cli']['cli_vols_per_s']:.2f} gathered vols/s over the "
        f"launched run against {out['cli']['phase8_cli_vols_per_s']:.2f} over phase 8's "
        f"in-process CLI run (2 epochs, this call)")
    check(counts_c["K1"] == expect, f"the launched CLI ran K1 {counts_c['K1']} times")
    check(len(rows_c) == 3 and all(len(r) == 19 for r in rows_c),
          f"cv_results.csv of the launched run is {len(rows_c)} rows")
    check(proc.stdout.count("Configuration Parameters:") == 1, "the config printed twice")
    for k in (1, 2):
        check(os.path.isfile(os.path.join(ckpt_c, f"best_fold{k}", "model.pt")),
              f"best_fold{k} of the launched run missing")

    # ---- (f) the dry run, the flagship entry, the examples -----------------
    t0 = time.time()
    loss = dryrun_multichip(2)
    out["dryrun"] = {"loss": loss, "seconds": time.time() - t0}
    check(np.isfinite(loss), f"dryrun_multichip(2) loss {loss}")
    fwd, (model, x) = entry()
    logits = fwd(model, x)
    check(tuple(logits.shape) == (4, 2) and bool(torch.isfinite(logits).all()),
          f"entry() forward gave {tuple(logits.shape)}")
    del model, x, logits
    ex_s = {}
    for name in examples.EXAMPLES:
        t0 = time.time()
        result = importlib.import_module(f"multimodal_ad_tpu_torch.examples.{name}").main(
            device="cuda")
        ex_s[name] = time.time() - t0
        check(result is not None, f"example {name} returned nothing")
    out["examples_s"] = ex_s
    log(f"(f) dryrun_multichip(2) loss {loss:.4f} in {out['dryrun']['seconds']:.1f} s; entry() "
        f"(4, 2) logits; examples on the card (s): "
        + ", ".join(f"{k} {v:.1f}" for k, v in ex_s.items()))
    out["launches_data_parallel"] = launches
    out["seconds"] = time.time() - t_phase
    log(f"phase 19: {out['seconds']:.1f} s")
    return out


# Phase 20's bounds against the unsharded run on the same card: the fp32
# forward's logits and layer-4 map within SP_FWD_BOUND of their spread
# (cuDNN takes other algorithms on slabs: not bit-equal), the bf16
# probabilities within SP_BF16_BOUND, the fp32 2-D step's loss within
# SP_LOSS_REL (the first moments within W2_U_BOUND, as phase 19's).
SP_FWD_BOUND = 1e-4
SP_BF16_BOUND = 5e-3
SP_LOSS_REL = 1e-6
SP_FWD_BATCH = 2


def _sp_forward_and_serving(torch, dev, a, rank):
    """Phase 20 (a) and (e) on one of two ranks: {"space": 2}."""
    from multimodal_ad_tpu_torch.models.resnet3d import ResNet3D
    from multimodal_ad_tpu_torch.ops import fused_gather as fg
    from multimodal_ad_tpu_torch.ops import int8_conv as k3
    from multimodal_ad_tpu_torch.parallel import mesh as pmesh
    from multimodal_ad_tpu_torch.parallel.spatial import HaloExchange, convert_spatial
    from multimodal_ad_tpu_torch.serve import EnsemblePredictor

    res = {}
    mesh = pmesh.make_mesh({"space": 2})
    sh = pmesh.spatial_sharding(mesh)
    sd = torch.load(a["sd"], weights_only=False)
    x = torch.load(a["x_fwd"], weights_only=False).to(dev)
    xs = sh.slab(x)

    def model(head, dtype, s2d=True):
        m = ResNet3D(depth=18, head=head, compute_dtype=dtype, s2d_stem=s2d)
        m.load_state_dict({k: v for k, v in sd.items()
                           if head == "classifier" or not k.startswith("conv_seg")})
        return m.to(dev).eval()

    # the classifier by stem form and type, spatially sharded
    sp = {(s2d, dt): convert_spatial(model("classifier", dt, s2d), mesh)
          for s2d in (True, False) for dt in (torch.float32, torch.bfloat16)}
    with torch.no_grad():
        HaloExchange.exchanges = HaloExchange.bytes = 0
        logits = sp[(True, torch.float32)](xs)
        torch.cuda.synchronize()
        res["fwd_exchanges"], res["fwd_halo_bytes"] = HaloExchange.exchanges, HaloExchange.bytes
        slab, bounds = convert_spatial(model("none", torch.float32), mesh)(xs)
        res["none_slab"] = (tuple(slab.shape), bounds)
        feats = sh.gather(slab.contiguous())
        probs = torch.softmax(sp[(True, torch.bfloat16)](xs), dim=-1)
        res["logits"], res["probs_bf16"] = logits.cpu(), probs.cpu()
        # (f) the plain 7^3 halo stem on the same slabs
        plain_logits = sp[(False, torch.float32)](xs)
        plain_probs = torch.softmax(sp[(False, torch.bfloat16)](xs), dim=-1)
        res["plain_logits"] = plain_logits.cpu()
        if rank == 0:
            ref = model("classifier", torch.float32)(x)
            ref_feats = model("none", torch.float32)(x)
            ref_probs = torch.softmax(model("classifier", torch.bfloat16)(x), dim=-1)
            res["logits_err"] = float((logits - ref).abs().max() / (ref.max() - ref.min()))
            res["feats_err"] = float((feats - ref_feats).abs().max()
                                     / (ref_feats.max() - ref_feats.min()))
            res["probs_bf16_err"] = float((probs - ref_probs).abs().max())
            res["ref_logits"] = ref.cpu()
            pref = model("classifier", torch.float32, s2d=False)(x)
            pref_probs = torch.softmax(model("classifier", torch.bfloat16, s2d=False)(x), dim=-1)
            res["plain_logits_err"] = float((plain_logits - pref).abs().max()
                                            / (pref.max() - pref.min()))
            res["plain_probs_bf16_err"] = float((plain_probs - pref_probs).abs().max())
            res["s2d_vs_plain_logits"] = float((logits - plain_logits).abs().max()
                                               / (pref.max() - pref.min()))
        del feats, slab
    torch.cuda.empty_cache()
    # (f) each form's stem (conv1 to the max pool) and stem conv on this
    # rank's slab, device time under torch.profiler (2 forwards)
    res["stem_ms"] = {}
    with torch.no_grad():
        for (s2d, dt), m in sp.items():
            stem_ms, conv_ms, dev_ms = stem_ranges(torch, [m], lambda m=m: m(xs), n=2)
            key = f"{'s2d' if s2d else 'plain'} {'bf16' if dt == torch.bfloat16 else 'fp32'}"
            res["stem_ms"][key] = {"stem": stem_ms, "conv": conv_ms, "forward": dev_ms}
    del sp
    torch.cuda.empty_cache()

    # (e) the predictor on {"data": 1, "space": 2}: the batch replicated over
    # 'space'; rank 0 holds it to the mesh-less predictor in this process
    mesh2 = pmesh.make_mesh({"data": 1, "space": 2})
    vols = np.load(a["vols"])
    preds = {"mesh": EnsemblePredictor.from_checkpoint_dir(a["ckpt_dir"], batch_size=BATCH,
                                                           device=dev, mesh=mesh2)}
    if rank == 0:
        preds["plain"] = EnsemblePredictor.from_checkpoint_dir(a["ckpt_dir"], batch_size=BATCH,
                                                               device=dev)
    out = {}
    for tag, pred in preds.items():
        fg.gather_normalize.launches = 0
        bf16 = pred.predict_proba(vols)
        k1_bf16 = fg.gather_normalize.launches
        if tag == "plain":
            out["padded"] = {"bf16": _padded_proba(torch, pred, vols)}
        pred.quantize_int8(vols[:4])
        fg.gather_normalize.launches = k3.conv_i8.launches = 0
        q8 = pred.predict_proba(vols)
        torch.cuda.synchronize()
        out[tag] = {"bf16": bf16, "int8": q8, "k1": k1_bf16 + fg.gather_normalize.launches,
                    "k3": k3.conv_i8.launches}
        if tag == "plain":
            out["padded"]["int8"] = _padded_proba(torch, pred, vols)
    res["predictor"] = out
    return res


def _block_exchange_marks(model, HaloExchange):
    """Hooks noting HaloExchange's counts as a plain spatial forward enters
    layer1 and leaves layer4: ``marks["blocks"]`` the blocks' forward
    (exchanges, bytes) once both fired. Returns (marks, handles)."""
    marks = {}

    def note(name):
        marks.setdefault(name, (HaloExchange.exchanges, HaloExchange.bytes))
        if "in" in marks and "out" in marks:
            marks["blocks"] = tuple(b - a for a, b in zip(marks["in"], marks["out"]))

    return marks, [model.layer1.register_forward_pre_hook(lambda m, args: note("in")),
                   model.layer4.register_forward_hook(lambda m, args, y: note("out"))]


def _sp_train(torch, dev, a, rank):
    """Phase 20 (b), (c), (g) and (h) on one of four ranks: {"data": 2,
    "space": 2}."""
    from multimodal_ad_tpu_torch.data.device_cache import DeviceDataset, DeviceEpochIterator
    from multimodal_ad_tpu_torch.models.resnet3d import ResNet3D
    from multimodal_ad_tpu_torch.ops import fused_gather as fg
    from multimodal_ad_tpu_torch.parallel import mesh as pmesh
    from multimodal_ad_tpu_torch.parallel.spatial import HaloExchange
    from multimodal_ad_tpu_torch.train import loop

    res = {"coords": None}
    mesh = pmesh.make_mesh({"data": 2, "space": 2})
    res["coords"] = (pmesh.data_rank(mesh), pmesh.space_rank(mesh))
    sd = torch.load(a["sd"], weights_only=False)
    vols8, labels8 = np.load(a["vols8"]), a["labels8"]
    cw = torch.tensor([0.5, 0.5], device=dev)
    lr0 = loop.make_epoch_schedule(1e-3, 20)(0)
    ds = DeviceDataset(vols8, labels8, device=dev, store_dtype=np.float32, mesh=mesh)

    def step_result(state, loss):
        return {"loss": float(loss), "exchanges": HaloExchange.exchanges,
                "halo_bytes": HaloExchange.bytes,
                "param_sums": [float(p.detach().double().sum()) for p in state.model.parameters()],
                "buffer_sums": [float(b.double().sum()) for b in state.model.buffers()]}

    for name, idx in (("full", np.arange(BATCH)), ("ragged", np.arange(5))):
        fg.gather_normalize.launches = 0
        batch = next(iter(DeviceEpochIterator(ds, idx, BATCH, spatial=1)))  # K1, then the slab
        torch.cuda.synchronize()
        k1 = fg.gather_normalize.launches
        state = _dp_fresh_state(torch, dev, sd, mesh, spatial=True)
        HaloExchange.exchanges = HaloExchange.bytes = 0
        r = step_result(state, loop.train_step(state, batch, cw)[0])
        r.update(k1=k1, slab=tuple(batch["image"].shape), real=float(batch["mask"].sum()))
        ref_state = None
        if rank == 0:  # the one-process step at the global batch
            ds1 = DeviceDataset(vols8, labels8, device=dev, store_dtype=np.float32)
            ref_state = _dp_fresh_state(torch, dev, sd, None)
            ref_loss, _ = loop.train_step(ref_state, next(iter(
                DeviceEpochIterator(ds1, idx, BATCH))), cw)
            r["ref_loss"] = float(ref_loss)
            r["check"] = adam_rule(torch, state, ref_state, lr0, W2_U_BOUND)
            del ds1
        if name == "full":
            # (g) the plain and the remat step from the same weights, both on
            # cuDNN's deterministic algorithms (the max pool's backward still
            # adds with atomics)
            cudnn = torch.backends.cudnn
            was = cudnn.deterministic
            cudnn.deterministic = True
            try:
                pstate = _dp_fresh_state(torch, dev, sd, mesh, spatial=True)
                marks, hooks = _block_exchange_marks(pstate.model, HaloExchange)
                HaloExchange.exchanges = HaloExchange.bytes = 0
                p = step_result(pstate, loop.train_step(pstate, batch, cw)[0])
                for h in hooks:
                    h.remove()
                rstate = _dp_fresh_state(torch, dev, sd, mesh, spatial=True, remat=True)
                HaloExchange.exchanges = HaloExchange.bytes = 0
                g = step_result(rstate, loop.train_step(rstate, batch, cw)[0])
            finally:
                cudnn.deterministic = was
            g["plain"] = {k: p[k] for k in ("loss", "exchanges", "halo_bytes")}
            g["blocks_fwd"] = marks["blocks"]
            pa, pb = dict(pstate.model.named_parameters()), dict(rstate.model.named_parameters())
            g_max = max(float(p.grad.abs().max()) for p in pa.values())
            g["grad_max_rel"] = max(float((pb[k].grad - p.grad).abs().max())
                                    for k, p in pa.items()) / g_max
            sa, sb = pstate.model.state_dict(), rstate.model.state_dict()
            stats = [k for k in sa if ".running_" in k or "num_batches" in k]
            g["stats_equal"] = all(torch.equal(sa[k], sb[k]) for k in stats)
            g["tracked"] = sorted({int(sb[k]) for k in stats if "num_batches" in k})
            if rank == 0:
                g["check"] = adam_rule(torch, rstate, ref_state, lr0, W2_U_BOUND)
            r["remat"] = g
            del pstate, rstate
        del state, ref_state
        torch.cuda.empty_cache()
        if name == "full":  # (h) the flagship's training precision, timed, with and without remat
            for remat in (False, True):
                model = ResNet3D(depth=18, remat=remat,
                                 generator=torch.Generator().manual_seed(SEED + 20)).to(dev)
                st = loop.create_train_state(model, loop.make_epoch_schedule(1e-3, 20),
                                             dropout_seed=SEED + 20, mesh=mesh, spatial=True)
                loop.train_step(st, batch, cw)  # warm-up
                torch.cuda.synchronize()
                HaloExchange.exchanges = HaloExchange.bytes = 0
                key = "bf16_remat" if remat else "bf16"
                r[f"{key}_step_ms"] = _timed_steps(torch, st, batch, cw, n=3, warmup=0)
                r[f"{key}_exchanges_per_step"] = HaloExchange.exchanges / 3
                r[f"{key}_halo_mb_per_step"] = HaloExchange.bytes / 3 / 1e6
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                loop.train_step(st, batch, cw)
                torch.cuda.synchronize()
                r[f"{key}_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
                r[f"{key}_step_rise_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
                del st, model
                torch.cuda.empty_cache()
        res[name] = r
    return res


def _sp_rank(rank, world, store, args_path, out_dir):
    """One of phase 20's gloo ranks, all on cuda:0: (a) and (e) at two
    ranks, (b) and (c) at four. cuDNN's autotuning is off in these ranks
    (heuristic algorithms): each rank would tune every slab shape anew."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from multimodal_ad_tpu_torch.parallel import mesh as pmesh

    dev = pmesh.init_distributed(backend="gloo", device="cuda:0",
                                 init_method=f"file://{store}", rank=rank, world_size=world)
    torch.backends.cudnn.benchmark = False
    try:
        a = torch.load(args_path, weights_only=False)
        res = (_sp_forward_and_serving if world == 2 else _sp_train)(torch, dev, a, rank)
        torch.save(res, os.path.join(out_dir, f"sp{world}-rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spatial_phase(torch, dev, card, work, ctx):
    """Phase 20: spatial sharding and the 2-D mesh at full width (see the
    module docstring)."""
    import torch.multiprocessing as mp

    from multimodal_ad_tpu_torch.data.pipeline import load_volume
    from multimodal_ad_tpu_torch.entry import dryrun_multichip
    from multimodal_ad_tpu_torch.models.resnet3d import generate_model
    from multimodal_ad_tpu_torch.ops.normalize import scale_intensity

    t_phase = time.time()
    log("== 20. spatial sharding: ResNet-18 B at 91x109x91, the volume's X over a 'space' "
        "axis (halo exchanges), gloo ranks on cuda:0")
    spw = os.path.join(work, "sp")
    os.makedirs(spw)
    out = {}
    launches = {"K1": {}, "K2": {}, "K3": {}}
    tr_val = ctx["tr_val"]
    vols8 = np.stack([load_volume(r["MRI"]) for r in tr_val[:BATCH]])[..., None]
    labels8 = np.array([r["label"] for r in tr_val[:BATCH]])
    sd = generate_model(model_depth=18, dropout_rate=0.0, compute_dtype=torch.float32,
                        generator=torch.Generator().manual_seed(SEED + 20)).state_dict()
    x_fwd = scale_intensity(torch.from_numpy(vols8[:SP_FWD_BATCH]).float().to(dev)).cpu()
    args = {"sd": os.path.join(spw, "sd.pt"), "x_fwd": os.path.join(spw, "x_fwd.pt"),
            "vols8": os.path.join(spw, "vols8.npy"), "labels8": labels8,
            "vols": os.path.join(spw, "vols.npy"), "ckpt_dir": ctx["ckpt_dir"]}
    torch.save(sd, args["sd"])
    torch.save(x_fwd, args["x_fwd"])
    np.save(args["vols8"], vols8)
    np.save(args["vols"], ctx["vols"])
    torch.save(args, os.path.join(spw, "args.pt"))

    def spawn(world):
        t0 = time.time()
        mp.start_processes(_sp_rank, args=(world, os.path.join(spw, f"store{world}"),
                                           os.path.join(spw, "args.pt"), spw),
                           nprocs=world, join=True, start_method="spawn")
        return ([torch.load(os.path.join(spw, f"sp{world}-rank{r}.pt"), weights_only=False)
                 for r in range(world)], time.time() - t0)

    # ---- (a), (e): two ranks, {"space": 2} and {"data": 1, "space": 2} ------
    r2, out["spawn2_s"] = spawn(2)
    a0 = r2[0]
    same_logits = bool(torch.equal(r2[0]["logits"], r2[1]["logits"]))
    out["a"] = {k: a0[k] for k in ("logits_err", "feats_err", "probs_bf16_err", "fwd_exchanges",
                                   "fwd_halo_bytes")}
    out["a"]["none_slabs"] = [r["none_slab"] for r in r2]
    log(f"(a) {{'space': 2}} fp32 forward at B = {SP_FWD_BATCH}: logits "
        f"{a0['logits_err']:.3g} of their spread from the unsharded forward (bound "
        f"{SP_FWD_BOUND:g}), the same on both ranks {same_logits}; the 'none' head's slabs "
        f"{[r['none_slab'] for r in r2]}, gathered {a0['feats_err']:.3g} of the layer-4 map's "
        f"spread; bf16 probabilities {a0['probs_bf16_err']:.3g} (bound {SP_BF16_BOUND:g}); "
        f"{a0['fwd_exchanges']} exchanges, {a0['fwd_halo_bytes'] / 1e6:.2f} MB of halo "
        "planes a rank a forward")
    check(a0["logits_err"] <= SP_FWD_BOUND and a0["feats_err"] <= SP_FWD_BOUND
          and a0["probs_bf16_err"] <= SP_BF16_BOUND and same_logits,
          f"the spatial forward misses the unsharded one: {out['a']}")
    same_plain = bool(torch.equal(r2[0]["plain_logits"], r2[1]["plain_logits"]))
    out["f"] = {k: a0[k] for k in ("plain_logits_err", "plain_probs_bf16_err",
                                   "s2d_vs_plain_logits")}
    out["f"]["stem_ms"] = [r["stem_ms"] for r in r2]
    log(f"(f) the stems on slabs, B = {SP_FWD_BATCH}: the plain 7^3 halo stem's fp32 logits "
        f"{a0['plain_logits_err']:.3g} of their spread from the unsharded plain-stem forward "
        f"(bound {SP_FWD_BOUND:g}), the same on both ranks {same_plain}, bf16 probabilities "
        f"{a0['plain_probs_bf16_err']:.3g} (bound {SP_BF16_BOUND:g}); s2d vs plain on slabs "
        f"{a0['s2d_vs_plain_logits']:.3g} of the spread")
    for r, rr in enumerate(r2):
        for key, t in rr["stem_ms"].items():
            log(f"    rank {r} {key:10s} stem (conv1 to max pool) {t['stem']:.3f} ms, its conv "
                f"{t['conv']:.3f} ms of {t['forward']:.3f} ms device time a forward "
                f"(torch.profiler, 2 forwards)")
    check(a0["plain_logits_err"] <= SP_FWD_BOUND and a0["plain_probs_bf16_err"] <= SP_BF16_BOUND
          and same_plain, f"the plain stem on slabs misses the unsharded one: {out['f']}")
    check(all(0 < t["conv"] <= t["stem"] for rr in r2 for t in rr["stem_ms"].values()),
          f"the profile saw no stem on a rank: {out['f']['stem_ms']}")
    p = [r["predictor"] for r in r2]
    # the mesh path pads every chunk to the batch: rank 0 bit-equal to the
    # mesh-less predictor's padded answer in its process; that predictor's
    # own buckets: full chunks to the bit, the ragged one within BUCKET_BOUND
    bit_equal = all(np.array_equal(p[0]["mesh"][k], p[0]["padded"][k]) for k in ("bf16", "int8"))
    gaps = [_bucket_gaps(p[0]["plain"][k], p[0]["padded"][k],
                         len(ctx["vols"]) // BATCH * BATCH) for k in ("bf16", "int8")]
    ragged_d = max(g[1] for g in gaps)
    # each space rank computes the replicated batch in its own process, where
    # cuDNN may take other algorithms: the ranks agree to the 4-row bound of
    # phase 19, not to the bit
    ranks_d = max(float(np.abs(p[0]["mesh"][k] - p[1]["mesh"][k]).max()) for k in ("bf16", "int8"))
    for r in (0, 1):
        launches["K1"][f"space2_rank{r}_serving"] = p[r]["mesh"]["k1"]
        launches["K3"][f"space2_rank{r}_serving"] = p[r]["mesh"]["k3"]
    out["e"] = {"bit_equal": bit_equal, "buckets_full_bit_equal": all(g[0] for g in gaps),
                "ragged_max_abs": ragged_d, "ranks_max_abs": ranks_d,
                "k1": [p[r]["mesh"]["k1"] for r in (0, 1)],
                "k3": [p[r]["mesh"]["k3"] for r in (0, 1)]}
    log(f"(e) EnsemblePredictor(mesh={{'data': 1, 'space': 2}}) over phase 4's {N_FOLDS} folds, "
        f"{len(ctx['vols'])} volumes, bf16 then int8: rank 0 bit-equal to the mesh-less "
        f"predictor's padded answer in its process {bit_equal}; rank 1 max |dprob| "
        f"{ranks_d:.3g} from rank 0 (bound {SP_BF16_BOUND:g}); the mesh-less buckets' full "
        f"chunks bit-equal {out['e']['buckets_full_bit_equal']}, the ragged chunk max |dprob| "
        f"{ragged_d:.3g} (bound {BUCKET_BOUND:g}; the rows' bf16 probabilities span "
        f"{np.ptp(p[0]['padded']['bf16'][:, 1]):.3g}); K1 {out['e']['k1']}, K3 "
        f"{out['e']['k3']} by rank")
    chunks = -(-len(ctx["vols"]) // BATCH)
    check(bit_equal and ranks_d <= SP_BF16_BOUND,
          f"the predictor on a space axis differs from the mesh-less one: {out['e']}")
    check(out["e"]["buckets_full_bit_equal"] and ragged_d <= BUCKET_BOUND,
          f"the bucketed predictor differs from the padded one: {out['e']}")
    check(all(p[r]["mesh"]["k3"] == 19 * N_FOLDS * chunks for r in (0, 1)),
          f"int8 serving on a space axis ran K3 {out['e']['k3']} times")
    log(f"    the two-rank spawn took {out['spawn2_s']:.1f} s")

    # ---- (b), (c): four ranks, {"data": 2, "space": 2} ---------------------
    r4, out["spawn4_s"] = spawn(4)
    rows = BATCH // 2
    for name in ("full", "ragged"):
        rs = [r[name] for r in r4]
        c = rs[0]["check"]
        equal_ranks = all(r["param_sums"] == rs[0]["param_sums"]
                          and r["buffer_sums"] == rs[0]["buffer_sums"] for r in rs[1:])
        rel = abs(rs[0]["loss"] - rs[0]["ref_loss"]) / abs(rs[0]["ref_loss"])
        out[name] = dict(c, loss=rs[0]["loss"], ref_loss=rs[0]["ref_loss"], loss_rel=rel,
                         ranks_equal=equal_ranks, k1=[r["k1"] for r in rs],
                         slabs=[r["slab"] for r in rs], real=[r["real"] for r in rs],
                         exchanges=rs[0]["exchanges"], halo_mb=rs[0]["halo_bytes"] / 1e6)
        tag = "b" if name == "full" else "c"
        log(f"({tag}) {{'data': 2, 'space': 2}} fp32 step, {name} batch (real rows by data row "
            f"{[r['real'] for r in rs[::2]]}), slabs {[r['slab'] for r in rs]}: loss "
            f"{rs[0]['loss']:.7f} vs one process {rs[0]['ref_loss']:.7f} (rel {rel:.3g}, bound "
            f"{SP_LOSS_REL:g}); |du| {c['du_rel']:.3g} of |u| (bound {W2_U_BOUND:g}); "
            f"parameters {c['big_max_over_lr']:.3g} lr / {c['loose_max_over_lr']:.3g} lr "
            f"({100 * c['loose_share']:.3f} % loose); BN statistics {c['bn_stats_max']:.3g}; the "
            f"four ranks' parameters and buffers equal {equal_ranks}; K1 by rank "
            f"{[r['k1'] for r in rs]}; {rs[0]['exchanges']} exchanges, "
            f"{rs[0]['halo_bytes'] / 1e6:.1f} MB of halo a rank")
        check(c["ok"] and rel <= SP_LOSS_REL, f"the 2-D {name} step differs: {out[name]}")
        check(equal_ranks, f"the four ranks' models differ after the {name} step")
        check(all(r["k1"] == 1 and r["slab"][0] == rows for r in rs),
              f"K1 per rank {[r['k1'] for r in rs]} on {[r['slab'] for r in rs]}")
        for r, rr in enumerate(rs):
            launches["K1"][f"data2_space2_rank{r}_step_{name}"] = rr["k1"]
    full0 = r4[0]["full"]
    out["bf16_step_ms"] = full0["bf16_step_ms"]
    out["bf16_exchanges_per_step"] = full0["bf16_exchanges_per_step"]
    out["bf16_halo_mb_per_step"] = full0["bf16_halo_mb_per_step"]
    log(f"    bf16 2-D step (4 gloo ranks on one card, slabs {[r['full']['slab'] for r in r4]}): "
        f"{full0['bf16_step_ms']:.1f} ms (CUDA events on rank 0, median of 3 after 1), "
        f"{full0['bf16_exchanges_per_step']:.0f} exchanges and "
        f"{full0['bf16_halo_mb_per_step']:.1f} MB of halo a rank a step; the four-rank spawn "
        f"took {out['spawn4_s']:.1f} s on {card}")

    # ---- (g), (h): remat on the 'space' axis --------------------------------
    fulls = [r["full"] for r in r4]
    gs = [f["remat"] for f in fulls]
    c = gs[0]["check"]
    g_ranks_equal = all(g["param_sums"] == gs[0]["param_sums"]
                        and g["buffer_sums"] == gs[0]["buffer_sums"] for g in gs[1:])
    out["g"] = {"loss": gs[0]["loss"], "plain_loss": gs[0]["plain"]["loss"],
                "loss_equal": all(g["loss"] == g["plain"]["loss"] for g in gs),
                "stats_equal": all(g["stats_equal"] for g in gs),
                "tracked": sorted({t for g in gs for t in g["tracked"]}),
                "grad_max_rel": max(g["grad_max_rel"] for g in gs), "ranks_equal": g_ranks_equal,
                "check": c, "exchanges": [g["exchanges"] for g in gs],
                "plain_exchanges": [g["plain"]["exchanges"] for g in gs],
                "blocks_fwd": [g["blocks_fwd"] for g in gs],
                "halo_mb": [g["halo_bytes"] / 1e6 for g in gs]}
    replayed = all(g["exchanges"] == g["plain"]["exchanges"] + g["blocks_fwd"][0]
                   and g["halo_bytes"] == g["plain"]["halo_bytes"] + g["blocks_fwd"][1]
                   for g in gs)
    log(f"(g) {{'data': 2, 'space': 2}} fp32 step with remat=True against remat=False from the "
        f"same weights, both on cuDNN's deterministic algorithms: loss "
        f"{gs[0]['loss']:.9g} vs {gs[0]['plain']['loss']:.9g} (equal to the bit on every rank "
        f"{out['g']['loss_equal']}); BatchNorm statistics equal {out['g']['stats_equal']}, "
        f"num_batches_tracked {out['g']['tracked']}; clipped gradients max |d| "
        f"{out['g']['grad_max_rel']:.3g} of max |g| (bound 1.5e-6); the four ranks' parameters "
        f"equal {g_ranks_equal}; against one process |du| {c['du_rel']:.3g} of |u| (bound "
        f"{W2_U_BOUND:g}), parameters {c['big_max_over_lr']:.3g} lr / "
        f"{c['loose_max_over_lr']:.3g} lr; exchanges by rank {out['g']['exchanges']} = plain "
        f"{out['g']['plain_exchanges']} + the blocks' forward "
        f"{[b[0] for b in out['g']['blocks_fwd']]} ({replayed}), "
        f"{gs[0]['halo_bytes'] / 1e6:.1f} MB of halo on rank 0")
    check(out["g"]["loss_equal"] and out["g"]["stats_equal"] and out["g"]["tracked"] == [1]
          and out["g"]["grad_max_rel"] <= 1.5e-6 and g_ranks_equal and c["ok"] and replayed,
          f"the remat step on a 'space' axis differs from the plain one: {out['g']}")
    out["h"] = {}
    for key in ("bf16", "bf16_remat"):
        out["h"][key] = {"ms": full0[f"{key}_step_ms"],
                         "exchanges": full0[f"{key}_exchanges_per_step"],
                         "halo_mb": full0[f"{key}_halo_mb_per_step"],
                         "peak_gb": [f[f"{key}_peak_gb"] for f in fulls],
                         "step_rise_gb": [f[f"{key}_step_rise_gb"] for f in fulls]}
        h = out["h"][key]
        log(f"(h) bf16 2-D step{' with remat' if 'remat' in key else ''}: {h['ms']:.1f} ms "
            f"(rank 0, median of 3 after 1), {h['exchanges']:.0f} exchanges and "
            f"{h['halo_mb']:.1f} MB of halo a rank a step; peak memory over a step by rank "
            f"{[round(v, 3) for v in h['peak_gb']]} GB (its rise in the step "
            f"{[round(v, 3) for v in h['step_rise_gb']]} GB)")

    # ---- (d) the dry run over four gloo ranks on the card ------------------
    t0 = time.time()
    loss = dryrun_multichip(4)
    out["dryrun"] = {"loss": loss, "seconds": time.time() - t0}
    check(np.isfinite(loss), f"dryrun_multichip(4) loss {loss}")
    log(f"(d) dryrun_multichip(4): loss {loss:.4f} in {out['dryrun']['seconds']:.1f} s")
    out["launches_spatial"] = launches
    out["seconds"] = time.time() - t_phase
    log(f"phase 20: {out['seconds']:.1f} s")
    return out


def k4_moved_bytes(x, y):
    """Bytes K4 must move: x, y and g read once and dx written once."""
    return 2 * x.numel() * x.element_size() + 2 * y.numel() * y.element_size()


def k4_bound_ms(x, y, window):
    """Least time for K4's work: its bytes (k4_moved_bytes) at HBM's rate;
    or its compares and adds (each window's w^3 compares, a compare and an
    add per (input, window) pair) at the float32 rate, whichever is
    larger."""
    ops = 3 * window ** 3 * y.numel()
    t_bytes, t_ops = k4_moved_bytes(x, y) / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ptxas_lines(log):
    """The lines of an nvcc -Xptxas -v log (ops/_build.py::build_log) that
    name a kernel and give its registers, stack and spills."""
    keys = ("Compiling entry function", "registers", "spill stores")
    return [ln.strip() for ln in log.splitlines() if any(k in ln for k in keys)]


def _window_ranks(torch, g, shape, dev):
    """A (B, D, H, W, C) input whose every 2^3/s2 window holds 0..7 once,
    in a random order: no window ties, exact in bfloat16."""
    b, d, h, w, c = shape
    keys = torch.rand((b, d // 2, h // 2, w // 2, c, 8), generator=g, device=dev)
    ranks = keys.argsort(-1).argsort(-1).to(torch.float32)
    ranks = ranks.view(b, d // 2, h // 2, w // 2, c, 2, 2, 2)
    return ranks.permute(0, 1, 5, 2, 6, 3, 7, 4).reshape(shape)


def _k4_device_ms(torch, fn, tries=3):
    """Device ms a call of K4's one kernel (max_pool_backward) over 5 calls
    of `fn()` under torch.profiler (warm L2), or None when no profile of
    `tries` shows it (the profiler can lose events; K4's time comes from
    CUDA events, this is the kernel's own share)."""
    for _ in range(tries):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            us = device_us(e)
            if us > 0 and "max_pool_backward" in e.key:
                return us / e.count / 1e3
    return None


def max_pool_phase(torch, dev, card):
    """Phase 21: K4, the tie-splitting max-pool backward (see the module
    docstring)."""
    import torch.nn.functional as F

    from multimodal_ad_tpu_torch.core.config import Config
    from multimodal_ad_tpu_torch.ops import pool as tk4
    from multimodal_ad_tpu_torch.train.cv import _make_model

    from multimodal_ad_tpu_torch.ops import _build

    t_phase = time.time()
    log("== 21. K4: max_pool_3d_fast's tie-splitting backward at the ResNet-18 stem pool "
        f"{POOL_STEM} 3^3/s2/p1 and the U-Net encoder pool {POOL_UNET} 2^3/s2/p0")
    log(card)
    tk4._lib()
    ptxas = ptxas_lines(_build.build_log("max_pool"))
    for line in ptxas:
        log(f"K4 ptxas: {line}")
    if not ptxas:
        log("K4 ptxas report: none (the library was built before this process)")
    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    # the dtype the ResNet train step hands its max pool, under the config's autocast
    model = _make_model(Config(), None, SEED).to(dev).train()
    seen = []
    hook = model.maxpool.register_forward_pre_hook(lambda m, a: seen.append(a[0].dtype))
    model(torch.zeros((2, 32, 38, 32, 1), device=dev))
    hook.remove()
    train_dtype = seen[0]
    del model
    log(f"the ResNet-18 train step's max pool takes {train_dtype}")
    dtypes = [train_dtype] + [d for d in (torch.float32,) if d != train_dtype]

    def aten_pool(x, window, padding):
        """(y, indices) of ATen's max pool on the channels-last view."""
        return F.max_pool3d(x.permute(0, 4, 1, 2, 3), window, 2, padding,
                            return_indices=True)

    def aten_backward(x, gy, idx, window, padding):
        dxp = torch.ops.aten.max_pool3d_with_indices_backward(
            gy.permute(0, 4, 1, 2, 3), x.permute(0, 4, 1, 2, 3), [window] * 3, [2] * 3,
            [padding] * 3, [1] * 3, False, idx)
        return dxp.permute(0, 2, 3, 4, 1)

    # the path: max_pool_3d_fast through autograd, counted
    drive = [(POOL_STEM, 3, 1, d) for d in dtypes] + [(POOL_UNET, 2, 0, torch.bfloat16)]
    tk4.max_pool_3d_fast_backward.launches = 0
    for shape, window, padding, dtype in drive:
        x = torch.randn(shape, generator=g, device=dev).clamp_(min=0).to(dtype)
        x.requires_grad_(True)
        y = tk4.max_pool_3d_fast(x, window, 2, padding)
        y.backward(torch.randn(tuple(y.shape), generator=g, device=dev).to(dtype))
        check(x.grad is not None and bool(torch.isfinite(x.grad).all()),
              f"K4's gradient at {shape} {dtype} is not finite")
    torch.cuda.synchronize()
    launches = tk4.max_pool_3d_fast_backward.launches
    check(launches == len(drive), f"K4 launched {launches} times for {len(drive)} backwards")
    del x, y

    errs, out = {}, {"train_pool_dtype": str(train_dtype), "launches": launches}

    def compare(name, x, window, padding, dtype, tie_free):
        """K4 on x against its plain version (and ATen's backward where no
        window ties, in float32); the forward against ATen's.

        float32: within 1e-6 * max|g| of the plain version. bf16: the plain
        version rounds `inv` and each of up to 8 partial sums to bf16, K4
        sums in float32 and rounds once, so K4 must equal the plain
        version run in float32 on the same values and rounded once, and lie
        within 1e-2 * max|dx| of the bf16 plain version (an input that is
        the maximum of several windows sums their cotangents: max|dx| is a
        few times max|g|)."""
        y = tk4.max_pool_3d_fast(x, window, 2, padding)
        y_ref, idx = aten_pool(x, window, padding)
        check(torch.equal(y, y_ref.permute(0, 2, 3, 4, 1)), f"{name}: forward != F.max_pool3d")
        gy = torch.randn(tuple(y.shape), generator=g, device=dev).to(dtype)
        a = tk4.max_pool_3d_fast_backward(x, y, gy, window, padding)
        b = tk4.max_pool_3d_fast_backward(x, y, gy, window, padding)
        ref = tk4.max_pool_3d_fast_plain(x, y, gy, window, padding)
        ref32 = tk4.max_pool_3d_fast_plain(x.float(), y.float(), gy.float(), window, padding)
        torch.cuda.synchronize()
        check(torch.equal(a, b), f"{name}: two K4 launches differ")
        gmax = float(gy.float().abs().max())
        dxmax = float(ref32.abs().max())
        err = float((a.float() - ref.float()).abs().max())
        row = {"k4_vs_plain": err, "max_abs_g": gmax, "max_abs_dx": dxmax,
               "bit_equal_to_plain_in_float32": torch.equal(a, ref32.to(dtype))}
        if dtype == torch.float32:
            check(err <= 1e-6 * gmax, f"{name}: K4 vs plain {err:.3e} > 1e-6 * {gmax:.3f}")
        else:
            check(row["bit_equal_to_plain_in_float32"],
                  f"{name}: K4 != the float32 plain version rounded once")
            check(err <= 1e-2 * dxmax, f"{name}: K4 vs plain {err:.3e} > 1e-2 * {dxmax:.3f}")
        del ref32
        aten = aten_backward(x, gy, idx, window, padding)
        row["k4_vs_aten"] = float((a.float() - aten.float()).abs().max())
        if tie_free and dtype == torch.float32:
            check(row["k4_vs_aten"] <= 1e-6 * gmax,
                  f"{name}: K4 vs ATen {row['k4_vs_aten']:.3e} on a tie-free input")
        mass = abs(float(a.double().sum()) - float(gy.double().sum()))
        row["mass_err_rel"] = mass / float(gy.double().abs().sum())
        rel = 1e-6 if dtype == torch.float32 else 1e-2
        check(row["mass_err_rel"] <= rel, f"{name}: mass {row['mass_err_rel']:.3e} lost")
        errs[name] = row
        log(f"{name}: K4 vs plain {err:.3e} (max|g| {gmax:.3f}, max|dx| {dxmax:.3f}; "
            f"bit-equal to the float32 plain: {row['bit_equal_to_plain_in_float32']}), vs ATen "
            f"{row['k4_vs_aten']:.3e}, mass {row['mass_err_rel']:.2e} of sum|g|, "
            "two launches bit-identical")
        return a, ref, aten, gy

    # (a) the stem pool, tie-free and tied. 59.6 M draws of randn repeat
    # values, and in bf16 most windows' top values share a bucket: the
    # tie-free float32 input is 59.6 M distinct floats (consecutive bit
    # patterns from 1.0, shuffled). A 3^3 window of ReLU(n) ties at its
    # maximum only where all 27 are zero (2^-27); ReLU(n - 2) leaves about
    # half the windows all zero.
    for dtype in dtypes:
        base = torch.randn(POOL_STEM, generator=g, device=dev)
        if dtype == torch.float32:
            n = base.numel()
            first = torch.randperm(n, generator=g, device=dev, dtype=torch.int32)
            tie_free = ("distinct", (first + 0x3F800000).view(torch.float32).view(POOL_STEM))
            del first
        else:
            tie_free = ("normal", base)
        for kind, x in (tie_free, ("relu(n-2)", (base - 2).clamp(min=0))):
            name = f"stem {kind} {str(dtype)[6:]}"
            compare(name, x.to(dtype), 3, 1, dtype, kind == "distinct")
            if kind == "relu(n-2)":
                y = tk4.max_pool_3d_fast(x.to(dtype), 3, 2, 1)
                errs[name]["tied_window_share"] = float((y == 0).float().mean())
                log(f"{name}: {errs[name]['tied_window_share']:.3f} of the windows all zero")
                del y
        del base, x
    # (b) the U-Net pool: all zero (every window tied), then no window tied
    zeros = torch.zeros(POOL_UNET, dtype=torch.bfloat16, device=dev)
    a, ref, _, gy = compare("unet zeros bf16", zeros, 2, 0, torch.bfloat16, False)
    rep = gy.repeat_interleave(2, 1).repeat_interleave(2, 2).repeat_interleave(2, 3) / 8
    check(torch.equal(a, rep) and torch.equal(ref, rep), "unet zeros: not exactly g / 8")
    ranks = _window_ranks(torch, g, POOL_UNET, dev).to(torch.bfloat16)
    a, ref, aten, _ = compare("unet tie-free bf16", ranks, 2, 0, torch.bfloat16, True)
    check(torch.equal(a, ref) and torch.equal(a, aten),
          "unet tie-free: K4, plain and ATen not bit-equal")
    del zeros, a, ref, aten, gy, rep
    log("unet: all-zero input exactly g / 8; tie-free input K4 = plain = ATen bit for bit")

    # (c) times
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.int32, device=dev)
    timing, geometry = {}, {}
    for label, shape, window, padding, dtype in (
            [(f"stem {str(d)[6:]}", POOL_STEM, 3, 1, d) for d in dtypes]
            + [("unet bfloat16", POOL_UNET, 2, 0, torch.bfloat16)]):
        x = torch.randn(shape, generator=g, device=dev).clamp_(min=0).to(dtype)
        y = tk4.max_pool_3d_fast(x, window, 2, padding)
        gy = torch.randn(tuple(y.shape), generator=g, device=dev).to(dtype)
        _, idx = aten_pool(x, window, padding)
        xr = x.detach().requires_grad_(True)

        def k4_fwd_bwd():
            tk4.max_pool_3d_fast(xr, window, 2, padding).backward(gy)

        def aten_fwd_bwd():
            F.max_pool3d(xr.permute(0, 4, 1, 2, 3), window, 2, padding).backward(
                gy.permute(0, 4, 1, 2, 3))

        bound, bound_by = k4_bound_ms(x, y, window)
        geo = tk4.card_geometry(x, window, padding)
        kernel_ms = _k4_device_ms(torch, lambda: tk4.max_pool_3d_fast_backward(
            x, y, gy, window, padding))
        row = {
            "ms": time_cuda(torch, lambda: tk4.max_pool_3d_fast_backward(
                x, y, gy, window, padding), flush=flush),
            "plain_ms": time_cuda(torch, lambda: tk4.max_pool_3d_fast_plain(
                x, y, gy, window, padding), flush=flush),
            "aten_backward_ms": time_cuda(torch, lambda: aten_backward(
                x, gy, idx, window, padding), flush=flush),
            "fwd_bwd_ms": time_cuda(torch, k4_fwd_bwd, flush=flush),
            "aten_fwd_bwd_ms": time_cuda(torch, aten_fwd_bwd, flush=flush),
            "bound_ms": bound, "bound_by": bound_by,
            "moved_mb": k4_moved_bytes(x, y) / 1e6,
            "kernel_ms_profiler": kernel_ms,
        }
        geometry[label] = {"path": geo.path, "grid": geo.grid, "threads": geo.threads,
                           "smem": geo.smem, "per_sm": geo.per_sm, "waves": geo.waves,
                           "patch": [geo.th, geo.tw], "group_units": geo.nv, "kd": geo.kd,
                           "vec": geo.vec}
        row["gb_per_s"] = row["moved_mb"] / row["ms"]
        row["kernel_gb_per_s"] = kernel_ms and row["moved_mb"] / kernel_ms
        timing[label] = row
        log(f"{label} {tuple(shape)}: K4 {row['ms']:.4f} ms (bound {bound:.4f}, {bound_by}, "
            f"{row['moved_mb']:.1f} MB, {row['gb_per_s']:.0f} GB/s), plain {row['plain_ms']:.4f}, "
            f"ATen backward {row['aten_backward_ms']:.4f}; forward + backward K4 "
            f"{row['fwd_bwd_ms']:.4f}, ATen {row['aten_fwd_bwd_ms']:.4f}; {geo.path} path, "
            f"{geo.grid} CTAs x {geo.threads}, {geo.smem} B shared, {geo.per_sm} an SM "
            f"(the card's count), {geo.waves:.2f} waves; "
            "the kernel (profiler, warm L2) "
            + (f"{kernel_ms:.4f} ms, {row['kernel_gb_per_s']:.0f} GB/s" if kernel_ms
               else "not measured: the profiler lost its events"))
        del x, y, gy, idx, xr
    del flush
    out.update(errs=errs, timing=timing, train_dtype_label=f"stem {str(train_dtype)[6:]}",
               geometry=geometry,
               max_abs_err=max(r["k4_vs_plain"] for r in errs.values()),
               phase_s=time.time() - t_phase)
    log(f"phase 21 took {out['phase_s']:.1f} s")
    return out


def _time_attr(e, names):
    for name in names:
        v = getattr(e, name, None)
        if v is not None:
            return float(v)
    return 0.0


def stem_share(torch, pred, x, n=2):
    """`stem_ranges` of `pred.forward(x)` over the predictor's folds."""
    return stem_ranges(torch, pred.folds, lambda: pred.forward(x), n)


def stem_ranges(torch, models, fn, n=2):
    """(stem device ms, stem conv device ms, all device ms) a call of
    `fn()`, from `n` calls under torch.profiler: each of `models`' stem
    (conv1 to the max pool) runs inside a "stem" range and its conv1 inside
    a "stem conv" range (forward hooks); a range's device time is the
    kernels launched inside it. The ranges' own device-side rows (their
    spans on the card) are left out of the total."""
    ranges, handles = [], []

    def enter(mod, args):
        for name in ("stem", "stem conv"):
            ranges.append(torch.profiler.record_function(name).__enter__())

    def leave(mod, args, y):
        ranges.pop().__exit__(None, None, None)

    for m in models:
        handles.append(m.conv1.register_forward_pre_hook(enter))
        handles.append(m.conv1.register_forward_hook(leave))
        handles.append(m.maxpool.register_forward_hook(leave))
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    total = sum(device_us(e) for e in prof.key_averages() if e.key not in ("stem", "stem conv"))

    def inside(name):
        return sum(_time_attr(e, ("device_time_total", "cuda_time_total"))
                   for e in prof.events()
                   if e.name == name and str(e.device_type).endswith("CPU"))

    return inside("stem") / 1e3 / n, inside("stem conv") / 1e3 / n, total / 1e3 / n


def stem_remat_phase(torch, dev, card, ctx):
    """Phase 22: the space-to-depth stem (`StemConv`, the default) against
    the plain 7^3 stem on the same folds, their times alone and their share
    of resident serving, and a resident train step with and without
    `remat`, ResNet-18 at full width."""
    import torch.nn.functional as F

    from multimodal_ad_tpu_torch.data.device_cache import DeviceDataset, DeviceEpochIterator
    from multimodal_ad_tpu_torch.models.resnet3d import ResNet3D, generate_model
    from multimodal_ad_tpu_torch.ops import fused_gather as fg
    from multimodal_ad_tpu_torch.serve import EnsemblePredictor
    from multimodal_ad_tpu_torch.train import checkpoint as ckpt
    from multimodal_ad_tpu_torch.train import loop

    t_phase = time.time()
    out = {"card": card}
    log(f"== 22. the s2d stem against the plain 7^3 stem, and remat; ResNet-18 B at "
        f"91x109x91 ({card})")
    sds = [ckpt.restore_state(os.path.join(ctx["ckpt_dir"], f"best_fold{k}"))[0]
           for k in range(1, N_FOLDS + 1)]
    vols = ctx["vols"]
    labels = np.arange(len(vols)) % 2
    fg.gather_normalize.launches = 0  # phase 22's path: resident serving and training

    # (a) the two stems on phase 4's folds
    ds = DeviceDataset(vols[..., None], labels, quantize="uint8")
    preds = {s2d: EnsemblePredictor(generate_model(model_depth=18, s2d_stem=s2d), sds,
                                    batch_size=BATCH, device=dev) for s2d in (True, False)}
    check(all(m.conv1.s2d for m in preds[True].folds)
          and not any(m.conv1.s2d for m in preds[False].folds), "stem forms mixed up")
    x8 = ds.gather_normalized(np.arange(BATCH), torch.bfloat16)["image"]
    probs = {s2d: p.forward(x8).cpu().numpy() for s2d, p in preds.items()}
    out["prob_max_abs_diff"] = float(np.abs(probs[True] - probs[False]).max())
    log(f"(a) resident bf16 serving, {N_FOLDS} folds, B = {BATCH}: s2d vs plain stem max "
        f"|dprob| {out['prob_max_abs_diff']:.3g} (bound 5e-3)")
    check(out["prob_max_abs_diff"] <= 5e-3,
          f"the s2d and plain stems' ensembles differ by {out['prob_max_abs_diff']}")
    x32 = ds.gather_normalized(np.arange(BATCH), torch.float32)["image"].permute(0, 4, 1, 2, 3)
    with torch.no_grad():
        ys, yp = preds[True].folds[0].conv1(x32), preds[False].folds[0].conv1(x32)
    spread = float(yp.max() - yp.min())
    out["stem_fp32_max_abs_diff"] = float((ys - yp).abs().max())
    out["stem_fp32_spread"] = spread
    log(f"    fold 1's stem conv in fp32 (TF32 off), B = {BATCH}: s2d vs plain max |d| "
        f"{out['stem_fp32_max_abs_diff']:.3g}, {out['stem_fp32_max_abs_diff'] / spread:.3g} "
        f"of the spread {spread:.4g} (bound 1e-4)")
    check(out["stem_fp32_max_abs_diff"] <= 1e-4 * spread,
          f"the s2d stem is {out['stem_fp32_max_abs_diff']} from the plain stem in fp32")
    out["card_vs_host_fp32_logits"] = ctx["card_vs_host_d"]
    log(f"    card vs host fp32 logits of fold 1 with the s2d stem (phase 4): max |d| "
        f"{ctx['card_vs_host_d']:.3g} (bound 2e-3)")
    del ys, yp, x32

    # (b) the stem alone, both forms, both types; forward in eval mode without
    # gradients (serving), forward + backward in train mode (training)
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 22)
    times = {}
    for b in (BATCH, 32):
        x = torch.randn((b, *VOL_SHAPE, 1), generator=g, device=dev).permute(0, 4, 1, 2, 3)
        for s2d, p in preds.items():
            m = p.folds[0]
            for dt in ("bf16", "fp32"):
                for part in ("conv", "conv+bn+relu+pool"):
                    def fwd():
                        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=dt == "bf16"):
                            h = m.conv1(x)
                            return h if part == "conv" else m.maxpool(F.relu(m.bn1(h)))

                    m.eval()
                    with torch.no_grad():
                        f_ms = time_cuda(torch, fwd, flush=flush)
                    m.train().requires_grad_(True)
                    cot = torch.randn(fwd().shape, generator=g, device=dev).to(
                        torch.bfloat16 if dt == "bf16" else torch.float32)
                    fb_ms = time_cuda(torch, lambda: fwd().backward(cot), flush=flush)
                    m.eval().requires_grad_(False)
                    key = f"{'s2d' if s2d else 'plain'} {dt} {part} B={b}"
                    times[key] = {"fwd_ms": f_ms, "fwd_bwd_ms": fb_ms}
                    log(f"(b) stem {key:34s} forward {f_ms:8.3f} ms, forward + backward "
                        f"{fb_ms:8.3f} ms (median of 25, L2 flushed)")
        del x
    out["stem_times"] = times
    del flush
    for p in preds.values():  # the timing runs moved fold 1's BatchNorm statistics
        p.folds[0].load_state_dict(sds[0])

    x32b = ds.gather_normalized(np.arange(32) % len(vols), torch.bfloat16)["image"]
    for s2d, p in preds.items():
        name = "s2d" if s2d else "plain"
        fwd_ms, _ = step_events(torch, lambda: p.forward(x32b), 5, warmup=1)
        stem_ms, conv_ms, dev_ms = stem_share(torch, p, x32b)
        out[f"resident_b32_{name}"] = {"forward_ms": fwd_ms, "vols_per_s": 32 / (fwd_ms / 1e3),
                                       "device_ms": dev_ms, "stem_device_ms": stem_ms,
                                       "stem_conv_device_ms": conv_ms,
                                       "stem_share": stem_ms / dev_ms,
                                       "stem_conv_share": conv_ms / dev_ms}
        log(f"(b) resident bf16 serving, B = 32, {name} stem: {N_FOLDS}-fold forward "
            f"{fwd_ms:.3f} ms ({32 / (fwd_ms / 1e3):.2f} vols/s, CUDA events, median of 5); "
            f"profile: {dev_ms:.3f} ms of device time a batch, the stems (conv to max pool) "
            f"{stem_ms:.3f} ms = {stem_ms / dev_ms:.1%}, their convs {conv_ms:.3f} ms = "
            f"{conv_ms / dev_ms:.1%}")
        check(0 < conv_ms < stem_ms < dev_ms,
              f"the profile saw {conv_ms} / {stem_ms} ms of stem in {dev_ms} ms")
    del preds, x8, x32b, ds

    # (c) a resident train step at B = 8 with and without remat
    train_ds = DeviceDataset(vols[..., None], labels, store_dtype=np.float32)
    it = DeviceEpochIterator(train_ds, np.arange(train_ds.n), BATCH, shuffle=True,
                             seed=SEED, augment=True)
    batches = (bt for _ in range(64) for bt in it)
    fixed = next(batches)
    cw = torch.tensor([0.5, 0.5], device=dev)
    base = ResNet3D(depth=18, generator=torch.Generator().manual_seed(SEED + 23)).state_dict()
    steps = {}
    for dt, dname in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        for remat in (False, True):
            m = ResNet3D(depth=18, compute_dtype=dt, remat=remat)
            m.load_state_dict(base)
            state = loop.create_train_state(m.to(dev), loop.make_epoch_schedule(1e-3, 20),
                                            dropout_seed=SEED)
            loss = float(loop.train_step(state, fixed, cw)[0])
            r = {"loss": loss,
                 "stats": {k: v.clone() for k, v in m.state_dict().items()
                           if ".running_" in k or "num_batches" in k},
                 "grads": torch.cat([p.grad.flatten() for p in m.parameters()])}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            r["ms"], _ = step_events(torch, lambda: loop.train_step(state, next(batches), cw),
                                     6, warmup=1)
            r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            steps[(dname, remat)] = r
            del state, m
    for dname in ("fp32", "bf16"):
        a, b = steps[(dname, False)], steps[(dname, True)]
        rel = abs(b["loss"] - a["loss"]) / abs(a["loss"])
        stats_equal = all(torch.equal(a["stats"][k], v) for k, v in b["stats"].items())
        dg = float((a["grads"] - b["grads"]).abs().max() / a["grads"].abs().max())
        out[f"train_{dname}"] = {"ms": a["ms"], "remat_ms": b["ms"], "peak_gb": a["peak_gb"],
                                 "remat_peak_gb": b["peak_gb"], "loss": a["loss"],
                                 "remat_loss": b["loss"], "loss_rel": rel,
                                 "stats_equal": stats_equal, "grad_max_rel": dg}
        log(f"(c) resident {dname} train step, B = {BATCH} (K1 + augmentation + step; median "
            f"of 6, CUDA events): {a['ms']:.2f} ms, remat {b['ms']:.2f} ms; peak memory "
            f"{a['peak_gb']:.2f} GB, remat {b['peak_gb']:.2f} GB; first step's loss "
            f"{a['loss']:.7f} / {b['loss']:.7f} (rel {rel:.3g}), BatchNorm statistics equal "
            f"{stats_equal}, clipped gradients max |d| {dg:.3g} of max |g|")
    check(out["train_fp32"]["loss_rel"] <= 1e-6 and out["train_fp32"]["stats_equal"],
          f"the fp32 remat step differs: {out['train_fp32']}")
    # the bf16 step at B = 32 (K1 gathers with repeats, no augmentation)
    idx32 = np.arange(32) % train_ds.n
    for remat in (False, True):
        m = ResNet3D(depth=18, remat=remat)
        m.load_state_dict(base)
        state = loop.create_train_state(m.to(dev), loop.make_epoch_schedule(1e-3, 20),
                                        dropout_seed=SEED)
        loop.train_step(state, train_ds.gather_normalized(idx32), cw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, _ = step_events(
            torch, lambda: loop.train_step(state, train_ds.gather_normalized(idx32), cw), 4,
            warmup=1)
        key = "remat" if remat else "plain"
        out[f"train_bf16_b32_{key}"] = {"ms": ms,
                                         "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del state, m
    a, b = out["train_bf16_b32_plain"], out["train_bf16_b32_remat"]
    log(f"(c) resident bf16 train step, B = 32 (K1 + step, median of 4): {a['ms']:.2f} ms, "
        f"remat {b['ms']:.2f} ms; peak memory {a['peak_gb']:.2f} GB, remat "
        f"{b['peak_gb']:.2f} GB")
    out["k1_launches"] = fg.gather_normalize.launches
    log(f"K1 launches in phase 22: {out['k1_launches']}")
    check(out["k1_launches"] > 0, "phase 22 never launched K1")
    out["seconds"] = time.time() - t_phase
    log(f"phase 22 took {out['seconds']:.1f} s ({card})")
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
    from multimodal_ad_tpu_torch.ops import pool as k4
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
    kernel_sources = ("fused_gather", "roi_pool", "int8_conv", "max_pool")
    _build.build(kernel_sources)  # one nvcc each, in parallel
    fg._lib()
    rp._lib()
    k3._lib()
    k4._lib()
    build_s = time.time() - t0
    log(f"K1, K2, K3 and K4 built and loaded in {build_s:.2f} s "
        f"({', '.join(_build.library_path(n).name for n in kernel_sources)})")
    for name in kernel_sources:
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
    check(fold.conv1.s2d, "the default fold does not run the s2d stem")
    fold_card_host_d = d
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

    # ---- 16. ICL meta-training -----------------------------------------------
    meta = metatrain_phase(torch, dev, card, work)

    # ---- 17. multimodal fusion training ---------------------------------------
    fuse = fusion_phase(torch, dev, card, work)

    # ---- 18. the tabular meta-estimators --------------------------------------
    meta_est = meta_estimators_phase(torch, dev, card, work)

    # ---- 19. data parallel over a device mesh ---------------------------------
    dp = data_parallel_phase(torch, dev, card, work, {
        "tr_val": tr_val, "test_recs": test_recs, "train_csv": train_csv,
        "train_mri": train_mri, "train_rate": train_rate, "train_wall": train_wall,
        "train_launches": train_launches, "ckpt_dir": ckpt_dir, "vols": vols,
        "ext_records": ext_records, "atlas_labels": labels, "roi_names": roi_names,
        "ext_out1": os.path.join(work, "out1")})

    # ---- 20. spatial sharding and the 2-D mesh --------------------------------
    sp = spatial_phase(torch, dev, card, work, {"tr_val": tr_val, "ckpt_dir": ckpt_dir,
                                                "vols": vols})

    # ---- 21. K4, the tie-splitting max-pool backward ---------------------------
    pool = max_pool_phase(torch, dev, card)

    # ---- 22. the s2d stem against the plain stem, and remat -------------------
    stem = stem_remat_phase(torch, dev, card, {"ckpt_dir": ckpt_dir, "vols": vols,
                                               "card_vs_host_d": fold_card_host_d})
    shutil.rmtree(work, ignore_errors=True)

    # ---- 23. result ----------------------------------------------------
    ms, plain_ms, bound, bound_by = timings["serving f32->bf16 B=8"]
    k3_top = q8["k3_shapes"][-1]  # stage 4, 3^3 d4, 512->512 (the last block's conv2)
    kernels = {"kernels": [{
        "name": "fused_gather_normalize",
        "route": "cuda",
        "source": K1_SOURCE,
        "replaces": K1_REPLACES,
        "launches": (serve_launches + resident_launches + ext_k1 + train_launches
                     + unet["k1_launches"] + ae["k1_launches"] + ae["extraction_k1"]
                     + q8["k1_launches"] + dense["k1_launches"] + enc["k1_launches"]
                     + fuse["k1_launches"] + fuse["daft_k1_launches"]
                     + stem["k1_launches"]),
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
        "launches_fusion_training": fuse["k1_launches"],
        "launches_daft_training": fuse["daft_k1_launches"],
        "launches_stem_remat": stem["k1_launches"],
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
        "launches_data_parallel": dp["launches_data_parallel"]["K1"],
        "launches_spatial": sp["launches_spatial"]["K1"],
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
        "launches_data_parallel": dp["launches_data_parallel"]["K2"],
        "launches_spatial": sp["launches_spatial"]["K2"],
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
        "launches_data_parallel": dp["launches_data_parallel"]["K3"],
        "launches_spatial": sp["launches_spatial"]["K3"],
        "design_pr": 7,
    }, {
        "name": "max_pool_3d_fast_backward",
        "route": "cuda",
        "source": K4_SOURCE,
        "replaces": K4_REPLACES,
        "not_pallas": "an XLA custom_vjp backward (dense slice/compare/pad form)",
        "launches": pool["launches"],
        "launches_note": "phase 21's max_pool_3d_fast backwards; no model routes it",
        "max_abs_err": pool["max_abs_err"],
        "ms": pool["timing"][pool["train_dtype_label"]]["ms"],
        "plain_ms": pool["timing"][pool["train_dtype_label"]]["plain_ms"],
        "bound_ms": pool["timing"][pool["train_dtype_label"]]["bound_ms"],
        "bound_by": pool["timing"][pool["train_dtype_label"]]["bound_by"],
        "library_ms": pool["timing"][pool["train_dtype_label"]]["aten_backward_ms"],
        "library_call": "aten max_pool3d_with_indices_backward from saved indices "
                        "(one maximum a window; equal where no window ties)",
        "shape": f"{pool['train_dtype_label']} {POOL_STEM}, 3^3/s2/p1",
        "per_shape": pool["timing"],
        "checks": pool["errs"],
        "status": "redesigned PR 15",
        "design_pr": 15,
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
                    "metatrain": meta, "fusion": fuse, "meta_estimators": meta_est,
                    "data_parallel": {k: v for k, v in dp.items()
                                      if k != "launches_data_parallel"},
                    "spatial": {k: v for k, v in sp.items() if k != "launches_spatial"},
                    "max_pool": {k: v for k, v in pool.items() if k not in ("timing", "errs")},
                    "stem_remat": stem,
                    "build_s": build_s,
                    "card": card, "seconds": time.time() - t_start}))
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
