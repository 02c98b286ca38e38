#!/usr/bin/env python3
"""How far one fp32 train step is from a float64 one, alone and data parallel.

One step (Adam, clip 1.0, wd 1e-4, lr 1e-3 warmup) of a seeded ResNet
(dropout 0, TF32 off) on 8 seeded synthetic volumes, from the same weights,
taken five ways:

- float64 (the reference: the same model, its parameters and input in
  float64);
- float32, twice (cuDNN's run-to-run spread), and once with cuDNN held to
  deterministic algorithms;
- float32 with the global BatchNorm of parallel/mesh.py at one rank;
- float32 data parallel at W = 2 (two gloo ranks on one card, or on the
  CPU), 4 rows a rank.

For each pair it prints Adam's first moment / (1 - b1) = u (the clipped
gradient plus wd p): max |du| against |u|'s global norm, and the tensors
where it is largest. This is what sets chip_smoke.py phase 19 (b)'s bound
at full width.

    python3 scripts/dp_step_precision.py                      # the card, ResNet-18,
                                                              # 91x109x91
    python3 scripts/dp_step_precision.py --device cpu --depth 10 --shape 16 20 16

Prints the card's name and power limit first (on a card).
"""

from __future__ import annotations

import argparse
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _u(st):
    return {k: st.optimizer.state[p]["exp_avg"].double() / 0.1
            for k, p in st.model.named_parameters()}


def compare(ua, ub, label):
    norm = math.sqrt(sum(float((v ** 2).sum()) for v in ub.values()))
    rows = sorted(((float((ua[k] - ub[k]).abs().max()), k, float(ub[k].abs().max()))
                   for k in ub), reverse=True)
    print(f"{label}: max |du| {rows[0][0]:.3g} against |u| {norm:.4g}: "
          f"{rows[0][0] / norm:.3g}; largest in "
          + ", ".join(f"{k} ({d:.2g} of max |u| {m:.2g})" for d, k, m in rows[:3]),
          flush=True)
    return rows[0][0] / norm


def _model(torch, depth, sd=None, dtype=None):
    from multimodal_ad_tpu_torch.models.resnet3d import generate_model

    m = generate_model(model_depth=depth, dropout_rate=0.0, compute_dtype=torch.float32,
                       generator=torch.Generator().manual_seed(19))
    if sd is not None:
        m.load_state_dict(sd)
    if dtype == torch.float64:  # the model's forward casts its input to float32
        m = m.double()
        m.forward = lambda x, m=m: m.conv_seg(m.features(x.permute(0, 4, 1, 2, 3), None))
    return m


def _rank(rank, world, store, args_path, out_path):
    """One rank of the W = 2 step."""
    import torch
    import torch.distributed as dist

    from multimodal_ad_tpu_torch.parallel import mesh as pmesh
    from multimodal_ad_tpu_torch.train import loop

    a = torch.load(args_path, weights_only=False)
    dev = pmesh.init_distributed(backend="gloo", device=a["device"],
                                 init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        mesh = pmesh.make_mesh()
        st = loop.create_train_state(_model(torch, a["depth"], a["sd"]).to(dev),
                                     loop.make_epoch_schedule(1e-3, 20), mesh=mesh)
        batch = {k: v.to(dev) for k, v in pmesh.shard_batch(a["batch"], mesh).items()}
        loop.train_step(st, batch, torch.tensor([0.5, 0.5], device=dev))
        if rank == 0:
            torch.save({k: v.cpu() for k, v in _u(st).items()}, out_path)
    finally:
        dist.destroy_process_group()


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--depth", type=int, default=18)
    p.add_argument("--shape", type=int, nargs=3, default=[91, 109, 91])
    args = p.parse_args()

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from multimodal_ad_tpu_torch.core.device import resolve_device
    from multimodal_ad_tpu_torch.data.synthetic import make_volume
    from multimodal_ad_tpu_torch.ops.normalize import scale_intensity
    from multimodal_ad_tpu_torch.train import loop

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    rng = np.random.default_rng(0)
    vols = np.stack([make_volume(rng, tuple(args.shape), label=i % 2)
                     for i in range(8)])[..., None]
    x = scale_intensity(torch.from_numpy(vols).to(dev)).cpu()
    batch = {"image": x, "label": torch.tensor([0, 1] * 4, dtype=torch.int32),
             "mask": torch.ones(8)}
    sd = _model(torch, args.depth).state_dict()
    cw = torch.tensor([0.5, 0.5], device=dev)

    def step(dtype=torch.float32, global_bn=False, deterministic=False):
        if dev.type == "cuda":
            torch.backends.cudnn.deterministic = deterministic
            torch.backends.cudnn.benchmark = not deterministic
        m = _model(torch, args.depth, sd, dtype).to(dev)
        if global_bn:  # at one rank convert_sync_batchnorm leaves the model as it is
            from multimodal_ad_tpu_torch.parallel.mesh import _global_class

            for mod in m.modules():
                if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
                    mod.__class__ = _global_class(type(mod))
                    mod.mesh_group, mod.mesh_size = dist.group.WORLD, 1
        st = loop.create_train_state(m, loop.make_epoch_schedule(1e-3, 20))
        b = {k: v.to(dev) for k, v in batch.items()}
        b["image"] = b["image"].to(dtype)
        loop.train_step(st, b, cw.to(dtype))
        return _u(st)

    t0 = time.time()
    u64 = step(torch.float64)
    print(f"float64 step: {time.time() - t0:.1f} s", flush=True)
    u32 = step()
    compare(u32, u64, "float32 vs float64")
    compare(step(), u32, "float32 vs float32 (run to run)")
    compare(step(deterministic=True), u64, "float32, deterministic cuDNN, vs float64")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store1", rank=0,
                                world_size=1)
        ug = step(global_bn=True)
        dist.destroy_process_group()
        compare(ug, u64, "float32 global BatchNorm (one rank) vs float64")
        compare(ug, u32, "float32 global BatchNorm (one rank) vs float32")
        a = {"sd": sd, "batch": batch, "depth": args.depth,
             "device": "cuda:0" if dev.type == "cuda" else "cpu"}
        torch.save(a, f"{tmp}/args.pt")
        if dev.type == "cuda":
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, True
        mp.start_processes(_rank, args=(2, f"{tmp}/store2", f"{tmp}/args.pt", f"{tmp}/u.pt"),
                           nprocs=2, join=True, start_method="spawn")
        uw2 = {k: v.to(dev) for k, v in torch.load(f"{tmp}/u.pt").items()}
    compare(uw2, u64, "float32 W = 2 vs float64")
    compare(uw2, u32, "float32 W = 2 vs float32 one process")
    return 0


if __name__ == "__main__":
    sys.exit(main())
