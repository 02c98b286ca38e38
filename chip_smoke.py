#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (multimodal_ad_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit, nothing is caught):

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build K1 (csrc/fused_gather.cu) with nvcc for sm_90a, timed;
3. K1 against its plain PyTorch version on the card: 32 full-size
   91x109x91 volumes in uint8, int16 (with negatives) and float32,
   repeated indices and one constant volume, f32 and bf16 output, int32
   and int64 indices; then its time (CUDA events, L2 flushed before each
   launch, median of 25) beside the bound and the plain version's time;
4. serving: 5 seeded full-width ResNet-18 fold checkpoints, 12 NIfTI
   volumes, `cli.predict --batch-size 8` (chunks 8 + 4) on the card; the
   bf16 ensemble against the fp32 one (TF32 off), and one fold's fp32
   logits on the card against the same on the host CPU; vols/s;
5. resident corpus: DeviceDataset(quantize="uint8") of 32 volumes,
   gather_normalized by index, 5-fold forward at batch 8 and 32; vols/s;
6. one JSON line {"kernels": [...]} and, last, the device line.

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
    import numpy as np

    from multimodal_ad_tpu_torch.cli import predict as cli_predict
    from multimodal_ad_tpu_torch.core.config import Config
    from multimodal_ad_tpu_torch.core.device import resolve_device
    from multimodal_ad_tpu_torch.data.device_cache import DeviceDataset
    from multimodal_ad_tpu_torch.data.pipeline import load_volume
    from multimodal_ad_tpu_torch.data.synthetic import make_volume
    from multimodal_ad_tpu_torch.models.resnet3d import generate_model
    from multimodal_ad_tpu_torch.ops import _build
    from multimodal_ad_tpu_torch.ops import fused_gather as fg
    from multimodal_ad_tpu_torch.serve import EnsemblePredictor
    from multimodal_ad_tpu_torch.train import checkpoint as ckpt
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
    _build.build(["fused_gather"])
    fg._lib()
    log(f"K1 built and loaded in {time.time() - t0:.2f} s "
        f"({_build.library_path('fused_gather').name})")
    log(_build.build_log("fused_gather").strip())

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
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.int32, device=dev)
    timings = {}
    log("K1 device times (L2 flushed before each launch, median of 25):")
    # serving shape: a float32 chunk of 8 volumes -> bf16 batch; resident
    # shapes: the uint8 corpus -> bf16 batch of 8 and 32
    serve_src = sources[torch.float32][:BATCH].contiguous()
    cases = [("serving f32->bf16 B=8", serve_src,
              torch.arange(BATCH, device=dev)),
             ("resident u8->bf16 B=8", sources[torch.uint8],
              torch.tensor(idx8, device=dev)),
             ("resident u8->bf16 B=32", sources[torch.uint8],
              torch.tensor(idx32, device=dev))]
    for name, src, idx in cases:
        ms = time_cuda(torch, lambda: fg.gather_normalize(src, idx, torch.bfloat16),
                       flush=flush)
        plain_ms = time_cuda(
            torch, lambda: fg.gather_normalize_plain(src, idx, torch.bfloat16),
            flush=flush)
        bound, bound_by = k1_bound_ms(idx.numel(), src.element_size(), 2,
                                      idx.element_size())
        timings[name] = (ms, plain_ms, bound, bound_by)
        log(f"  {name:24s} kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
            f"bound {bound:.4f} ms ({bound_by})  -> {bound / ms:.1%} of bound")
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
    shutil.rmtree(work, ignore_errors=True)

    # ---- 6. result -----------------------------------------------------
    ms, plain_ms, bound, bound_by = timings["serving f32->bf16 B=8"]
    kernels = {"kernels": [{
        "name": "fused_gather_normalize",
        "route": "cuda",
        "source": K1_SOURCE,
        "replaces": K1_REPLACES,
        "launches": serve_launches + resident_launches,
        "launches_serving": serve_launches,
        "launches_resident": resident_launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": None,
        "shape": "float32 (8, 91, 109, 91, 1) -> bfloat16, B=8",
        "ms_resident_u8_b8": timings["resident u8->bf16 B=8"][0],
        "ms_resident_u8_b32": timings["resident u8->bf16 B=32"][0],
    }]}
    log(json.dumps({"serving_vols_per_s": serve_rates,
                    "resident_vols_per_s": {str(k): v for k, v in resident_rates.items()},
                    "card": card, "seconds": time.time() - t_start}))
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
