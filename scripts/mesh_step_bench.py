#!/usr/bin/env python3
"""Time the data-parallel train step at W = 2 with both gloo ranks on one
card (chip_smoke.py phase 19 (b)'s step), for the port package found under
`--pkg-root`, so that two checkouts can be compared in one call.

    python3 scripts/mesh_step_bench.py --label change
    python3 scripts/mesh_step_bench.py --pkg-root build/parent --label parent

Each rank holds 4 rows of a seeded global batch of 8 full-size volumes
(91x109x91, float32, already normalized) and a seeded ResNet-18 B in fp32
(TF32 off); one train step is timed with CUDA events on rank 0, the median
of `--steps` after `--warmup`. With `--spatial` (a package that has
parallel/spatial.py), four ranks run the {"data": 2, "space": 2} bf16 step
instead. Prints one JSON line with the label, the median ms, the package
the ranks imported and the card's name and power limit (nvidia-smi).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (91, 109, 91, 1)
BATCH = 8


def _rank(rank, world, store, pkg_root, steps, warmup, spatial, out):
    import torch
    import torch.distributed as dist

    sys.path.insert(0, pkg_root)
    from multimodal_ad_tpu_torch.models.resnet3d import generate_model
    from multimodal_ad_tpu_torch.parallel import mesh as pmesh
    from multimodal_ad_tpu_torch.train import loop

    dev = pmesh.init_distributed(backend="gloo", device="cuda:0",
                                 init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        shape = {"data": 2, "space": 2} if spatial else {"data": 2}
        mesh = pmesh.make_mesh(shape)
        rng = np.random.default_rng(0)
        batch = {"image": torch.from_numpy(rng.random((BATCH, *SHAPE), np.float32)),
                 "label": torch.from_numpy((np.arange(BATCH) % 2).astype(np.int64)),
                 "mask": torch.ones(BATCH)}
        kw = {"spatial": 1} if spatial else {}
        local = {k: v.to(dev) for k, v in pmesh.shard_batch(batch, mesh, **kw).items()}
        dtype = torch.bfloat16 if spatial else torch.float32
        model = generate_model(model_depth=18, dropout_rate=0.0, compute_dtype=dtype,
                               generator=torch.Generator().manual_seed(0)).to(dev)
        state = loop.create_train_state(model, loop.make_epoch_schedule(1e-3, 20), mesh=mesh,
                                        **kw)
        cw = torch.tensor([0.5, 0.5], device=dev)
        times = []
        for i in range(warmup + steps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            loop.train_step(state, local, cw)
            b.record()
            if i >= warmup:
                times.append((a, b))
        torch.cuda.synchronize()
        if rank == 0:
            import multimodal_ad_tpu_torch

            with open(out, "w") as f:
                json.dump({"ms": statistics.median(a.elapsed_time(b) for a, b in times),
                           "package": os.path.dirname(multimodal_ad_tpu_torch.__file__)}, f)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pkg-root", default=ROOT)
    p.add_argument("--label", default="change")
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--spatial", action="store_true")
    args = p.parse_args(argv)
    import torch
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        print("mesh_step_bench: needs a CUDA device", file=sys.stderr)
        return 1
    pkg_root = os.path.abspath(args.pkg_root)
    world = 4 if args.spatial else 2
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "ms.json")
        mp.start_processes(_rank, args=(world, os.path.join(tmp, "store"), pkg_root, args.steps,
                                        args.warmup, args.spatial, out),
                           nprocs=world, join=True, start_method="spawn")
        with open(out) as f:
            res = json.load(f)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"label": args.label, "package": res["package"],
                      "step": "2-D bf16, 4 ranks" if args.spatial else "W = 2 fp32",
                      "median_ms": res["ms"], "steps": args.steps, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
