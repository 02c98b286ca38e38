#!/usr/bin/env python3
"""Time the port's two CUDA kernels, K1 (gather + min-max normalize) and
K2 (atlas ROI pooling), on one NVIDIA GPU at the shapes the main paths
give them, beside their bounds and a library yardstick.

    python3 scripts/kernel_bench.py [--pkg-root DIR] [--label NAME] [--reps N]

`--pkg-root` names the directory that holds the `multimodal_ad_tpu_torch`
package to time (default: this checkout), so one run on the card can
time a parent commit unpacked beside this one, in turns (parent, change,
change, parent). Only the wrappers' public calls are used, so any version
of the package runs. Times are medians of `--reps` launches between CUDA events,
with the L2 flushed and a device-side spin before each launch
(chip_smoke.py::time_cuda). Prints one line per case and, last, one JSON
object with every number and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pkg-root", default=ROOT)
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--reps", type=int, default=25)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_bench: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.pkg_root))
    sys.path.insert(1, ROOT)  # chip_smoke's helpers
    import chip_smoke as cs
    from multimodal_ad_tpu_torch.data.synthetic import make_atlas
    from multimodal_ad_tpu_torch.ops import fused_gather as fg
    from multimodal_ad_tpu_torch.ops import roi_pool as rp

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    dev = torch.device("cuda")
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.int32, device=dev)
    res = {"label": args.label, "pkg": os.path.abspath(args.pkg_root), "card": card,
           "k1": {}, "k2": {}}

    def timed(fn):
        return cs.time_cuda(torch, fn, reps=args.reps, flush=flush)

    def host_us(fn, n=200):
        """Host time to enqueue one call (no synchronise in the loop)."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return 1e6 * t / n

    # ---- K1 ----
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    shape = (cs.N_CORPUS, *cs.VOL_SHAPE, 1)
    u8 = torch.randint(0, 256, shape, generator=g, device=dev, dtype=torch.uint8)
    f32 = torch.randn(shape, generator=g, device=dev) * 100 + 20
    batch8 = f32[:cs.BATCH].contiguous()
    idx8 = torch.tensor([0, 5, 7, 7, 31, 12, 5, 3], device=dev)
    idx32 = torch.randint(0, cs.N_CORPUS, (32,), generator=g, device=dev)
    ar8 = torch.arange(cs.BATCH, device=dev)
    k1_cases = [("f32->bf16 B=8", batch8, ar8, torch.bfloat16),
                ("u8->bf16 B=8", u8, idx8, torch.bfloat16),
                ("u8->bf16 B=32", u8, idx32, torch.bfloat16),
                ("f32->f32 B=8", batch8, ar8, torch.float32)]
    for name, src, idx, odt in k1_cases:
        bound, by = cs.k1_bound_ms(idx.numel(), src.element_size(),
                                   torch.empty((), dtype=odt).element_size(),
                                   idx.element_size())
        ms = timed(lambda: fg.gather_normalize(src, idx, odt))
        row = {"ms": ms, "bound_ms": bound, "bound_by": by,
               "host_us": host_us(lambda: fg.gather_normalize(src, idx, odt))}
        mode = getattr(fg.gather_normalize, "mode", None)
        if mode is not None:
            row.update(mode=mode, blocks_per_volume=fg.gather_normalize.blocks_per_volume,
                       smem_bytes=fg.gather_normalize.smem_bytes)
        res["k1"][name] = row
        print(f"K1 {name:16s} {ms:.4f} ms  bound {bound:.4f} ms ({by}) -> {bound / ms:.1%}; "
              f"host {row['host_us']:.1f} us/call"
              + (f"; {mode} mode, {row['blocks_per_volume']} blocks a volume, "
                 f"{row['smem_bytes']} B shared each" if mode is not None else ""), flush=True)
    tiny = torch.randn((cs.BATCH, 4096), generator=g, device=dev)  # fixed cost of a launch
    tiny_ms = timed(lambda: fg.gather_normalize(tiny, ar8, torch.float32))
    res["k1"]["tiny_f32_b8_4096_ms"] = tiny_ms
    print(f"K1 on 8 volumes of 4,096 voxels (its fixed cost) {tiny_ms:.4f} ms", flush=True)
    dst = torch.empty_like(batch8)
    copy_ms = timed(lambda: dst.copy_(batch8))
    empty_ms = timed(lambda: torch.cuda._sleep(0))
    res["k1"]["copy_f32_b8_ms"] = copy_ms
    res["k1"]["empty_launch_ms"] = empty_ms
    print(f"library copy of one f32 batch of 8 (the f32->f32 bytes) {copy_ms:.4f} ms; "
          f"empty launch {empty_ms:.4f} ms", flush=True)
    del u8, f32, batch8, dst

    # ---- K2 ----
    labels = make_atlas(cs.VOL_SHAPE, n_rois=cs.N_ROIS, seed=cs.SEED)
    labels[labels == 100] = 0  # as chip_smoke.py phase 6
    atlas = rp.RoiAtlas.build(labels, cs.N_ROIS, dev)
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 2)
    feats = torch.randn((cs.BATCH, *cs.VOL_SHAPE, cs.ROI_CH), generator=g, device=dev)
    # the U-Net's tap: a crop of the channels-last map padded to 96x112x96
    padded = torch.randn((cs.BATCH, 96, 112, 96, cs.ROI_CH), generator=g, device=dev)
    tap = padded[:, :cs.VOL_SHAPE[0], :cs.VOL_SHAPE[1], :cs.VOL_SHAPE[2]]
    labels_1mm = cs.nearest_centre_labels(torch, dev, cs.SHAPE_1MM, cs.N_ROIS_1MM, cs.SEED)
    atlas_1mm = rp.RoiAtlas.build(labels_1mm, cs.N_ROIS_1MM, dev)
    feats_1mm = torch.randn((1, *cs.SHAPE_1MM, cs.ROI_CH), generator=g, device=dev)
    bound, by = cs.k2_bound_ms(atlas, cs.BATCH, cs.ROI_CH, 4)
    bound_1mm, _ = cs.k2_bound_ms(atlas_1mm, 1, cs.ROI_CH, 4)
    k2_cases = [("f32 B=8 contiguous", feats, atlas, cs.N_ROIS, bound),
                ("f32 B=8 tap", tap, atlas, cs.N_ROIS, bound),
                ("bf16 B=8 contiguous", feats.to(torch.bfloat16), atlas, cs.N_ROIS,
                 cs.k2_bound_ms(atlas, cs.BATCH, cs.ROI_CH, 2)[0]),
                ("f32 B=1 1-mm 600", feats_1mm, atlas_1mm, cs.N_ROIS_1MM, bound_1mm)]
    # the same map with a voxel stride of 66 channels: other layouts' variant
    padded66 = torch.randn((cs.BATCH, 96, 112, 96, 66), generator=g, device=dev)
    k2_cases.append(("f32 B=8 tap, voxel stride 66", padded66[
        :, :cs.VOL_SHAPE[0], :cs.VOL_SHAPE[1], :cs.VOL_SHAPE[2], :cs.ROI_CH],
        atlas, cs.N_ROIS, bound))
    if hasattr(atlas, "tile_size"):  # other tile sizes T on the tap
        k2_cases += [(f"f32 B=8 tap, T={t}", tap,
                      rp.RoiAtlas.build(labels, cs.N_ROIS, dev, tile_size=t),
                      cs.N_ROIS, bound) for t in (256, 1024)]
    for name, f, a, r, bnd in k2_cases:
        ms = timed(lambda: rp.roi_pool(f, a, r))
        row = {"ms": ms, "bound_ms": bnd, "bound_by": by,
               "host_us": host_us(lambda: rp.roi_pool(f, a, r), 50)}
        if hasattr(rp, "k2_path"):
            row["path"] = rp.k2_path(f, a)
        res["k2"][name] = row
        print(f"K2 {name:28s} {ms:.4f} ms  bound {bnd:.4f} ms ({by}) -> {bnd / ms:.1%}"
              + (f"; {row['path']} path" if "path" in row else ""), flush=True)
    for key, a in (("tiles_2mm", atlas), ("tiles_1mm", atlas_1mm)):
        if hasattr(a, "tile_size"):
            res["k2"][key] = {"tile_size": a.tile_size, "tiles": a.num_tiles,
                              "runs": int(a.runs.shape[0])}
            print(f"K2 plan {key}: T {a.tile_size}, {a.num_tiles} tiles, "
                  f"{a.runs.shape[0]} runs", flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
