#!/usr/bin/env python3
"""Time the port's CUDA kernels, K1 (gather + min-max normalize), K2
(atlas ROI pooling), K3 (int8 conv) and K4 (the tie-splitting max-pool
backward), on one NVIDIA GPU at the shapes the main paths give them,
beside their bounds and a library yardstick.

    python3 scripts/kernel_bench.py [--pkg-root DIR] [--label NAME] [--reps N]
                                    [--only k1,k2,k3,k4] [--k3-variants]
                                    [--k4-variants]

K3 runs the flagship's ten block-conv shapes of `chip_smoke.py::K3_SHAPES`
at B = 8, each in the epilogues the int8 path runs on it, and sums a
forward's 19 convs; a package without the block-output epilogue (before
it existed) runs its own main-path epilogue there, float32.

`--k3-variants` (this checkout only) also times, under the same public
`conv_i8`, copies of K3's source with a few lines replaced, built with the
port's nvcc flags into the gitignored multimodal_ad_tpu_torch/build/
variants/: where K3's time goes. `cp_async_a` gathers the activations
with cp.async instead of TMA and `no_sw64` takes C_in = 64 without the
64-byte-swizzle path (both checked bit-equal to the plain version);
`mul_for_div`, `no_epilogue` and `no_copies` replace the quant point's
division by a multiply, leave out the epilogue, leave out every copy
(timing only: their results are wrong). A replaced line that is no
longer in the source stops the run.

K4 runs chip_smoke.py phase 21's three shapes (the ResNet-18 stem pool
in bf16 and float32, the U-Net pool in bf16) on ReLU'd normal inputs,
beside the byte bound, ATen's max-pool backward from saved indices and
the plain version; it is in the default set only from the package that
has it. `--k4-variants` (this checkout only) times, at the stem pool, copies of K4's source with a part of the
staged kernel left out (timing only: their results are wrong), built like
K3's variants: `no_finalize` (no dx), `no_count` (no count and inv),
`no_compute` (neither: the copies and barriers alone), `no_copies` (no
staging into shared memory): where the staged kernel's time goes.

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
    ap.add_argument("--only", default="k1,k2,k3,k4", help="comma-separated kernels to time")
    ap.add_argument("--k3-variants", action="store_true",
                    help="also time patched copies of K3's source (this checkout only)")
    ap.add_argument("--k4-variants", action="store_true",
                    help="also time parts of K4 left out (this checkout only)")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    if (args.k3_variants or args.k4_variants) and os.path.abspath(args.pkg_root) != ROOT:
        ap.error("--k3-variants and --k4-variants use this checkout's source: "
                 "leave --pkg-root out")

    import torch

    if not torch.cuda.is_available():
        print("kernel_bench: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # this checkout's helpers and shapes, whatever --pkg-root holds
    sys.path.insert(0, os.path.abspath(args.pkg_root))
    from multimodal_ad_tpu_torch.data.synthetic import make_atlas
    from multimodal_ad_tpu_torch.ops import fused_gather as fg
    from multimodal_ad_tpu_torch.ops import int8_conv as k3
    from multimodal_ad_tpu_torch.ops import roi_pool as rp

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    dev = torch.device("cuda")
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.int32, device=dev)
    res = {"label": args.label, "pkg": os.path.abspath(args.pkg_root), "card": card,
           "k1": {}, "k2": {}, "k3": {}, "k4": {}}

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

    if "k1" in only:
        k1_bench(torch, cs, fg, dev, timed, host_us, res)
    if "k2" in only:
        k2_bench(torch, cs, rp, make_atlas, dev, timed, host_us, res)
    if "k3" in only:
        variants = {}
        if args.k3_variants:
            from multimodal_ad_tpu_torch.ops import _build
            variants = build_k3_variants(_build)
        k3_bench(torch, cs, k3, dev, timed, res, variants)
    if "k4" in only:
        try:
            from multimodal_ad_tpu_torch.ops import pool as k4
        except ImportError:  # a package from before K4
            k4 = None
        if k4 is not None:
            variants = {}
            if args.k4_variants:
                from multimodal_ad_tpu_torch.ops import _build
                variants = build_variants(_build, "max_pool", K4_VARIANTS)
            k4_bench(torch, cs, k4, dev, timed, res, variants)
    print(json.dumps(res), flush=True)
    return 0


def k1_bench(torch, cs, fg, dev, timed, host_us, res):
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


def k2_bench(torch, cs, rp, make_atlas, dev, timed, host_us, res):
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


_NO_COPIES = [("if (s + kStages - 2 < steps) load(", "if (false) load("),
              ("if (s < steps) load(s);", "if (false) load(s);"),
              ("    if (p.b_tma) mbar_wait(", "    if (false) mbar_wait(")]
# name: (the source's lines and their replacements, bit-equal to the plain version)
K3_VARIANTS = {
    "cp_async_a": ([("  p.a_tma = p.b_tma && stride == 1 && td > 0;", "  p.a_tma = 0;")], True),
    "no_sw64": ([("  p.sw64 = C == 64;", "  p.sw64 = 0;")], True),
    "mul_for_div": ([("rintf(__fdiv_rn(h, s_next))", "rintf(__fmul_rn(h, s_next))")], False),
    "no_epilogue": ([("  // Epilogue, in two passes",
                      "  if (p.N > 0) return;\n  // Epilogue, in two passes")], False),
    "no_copies": (_NO_COPIES, False),
}


def build_k3_variants(_build) -> dict:
    """Compile every K3 variant (one nvcc each, in parallel) -> {name: (CDLL, bit_equal)}."""
    return build_variants(_build, "int8_conv", K3_VARIANTS)


def build_variants(_build, source: str, table: dict) -> dict:
    """Compile each variant of csrc/<source>.cu in `table` ({name: (edits,
    bit_equal)}; one nvcc each, in parallel) -> {name: (CDLL, bit_equal)}."""
    import ctypes

    src = (_build.CSRC / f"{source}.cu").read_text()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, (edits, _) in table.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old.strip()!r} is no longer in the source")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        jobs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out_dir / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        libs[name] = (ctypes.CDLL(str(out_dir / f"lib{name}.so")), table[name][1])
    return libs


def k3_bench(torch, cs, k3, dev, timed, res, variants=None):
    """K3 at the flagship's shapes; `variants` ({name: (CDLL, bit_equal)}) are
    swapped in under `conv_i8` and timed beside it on the same inputs."""
    variants = variants or {}
    if variants:
        from multimodal_ad_tpu_torch.ops import _build
        kernel = _build.load("int8_conv")

        def use(lib):
            _build._loaded["int8_conv"] = lib
            k3._lib()  # declares the C signature on first use
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 50)
    has_block_out = "block_out" in k3.EPILOGUES
    total = {"ms": 0.0, "bound_ms": 0.0, "int_mm_ms": 0.0}
    total_variants = dict.fromkeys(variants, 0.0)
    for name, grid, c_in, c_out, ksize, stride, dil, epilogues in cs.K3_SHAPES:
        x = torch.randint(-127, 128, (cs.BATCH, *grid, c_in), generator=g, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (c_out, ksize, ksize, ksize, c_in), generator=g,
                          device=dev, dtype=torch.int8)
        kv = torch.rand(c_out, generator=g, device=dev) * 2e-5 + 1e-6
        bv = torch.randn(c_out, generator=g, device=dev) * 0.5
        kk = ksize ** 3 * c_in
        a_mat, b_mat = cs.im2col(torch, x, ksize, stride, dil), w.reshape(c_out, kk).t()
        m = a_mat.shape[0]
        lib_ms = timed(lambda: torch._int_mm(a_mat, b_mat))
        ops, in_bytes = cs.k3_work(cs.BATCH, grid, c_in, c_out, ksize, stride, dil)
        plan = (k3.tile_plan(tuple(x.shape), tuple(w.shape), stride, dil)
                if hasattr(k3, "tile_plan") else None)
        acc = k3.conv_i8_plain(x, w, stride, dil) if variants else None
        for spec, per_fwd in epilogues:
            epi, res_name, with_q, moved = cs.k3_epilogue(spec)
            r = None
            if epi == "block_out" and has_block_out:
                r = torch.randn(k3._out_shape(x.shape, w.shape, stride, dil), generator=g,
                                device=dev)
                r = r.to(torch.bfloat16) if res_name == "bf16" else r
                args = (epi, kv, bv, 0.05 if with_q else None, r)
            elif epi == "block_out":  # the package's own main path: float32 out
                epi, moved = "float32", 4
                args = (epi, kv, bv, None)
            else:
                args = (epi, kv, bv, 0.05)
            ms = timed(lambda: k3.conv_i8(x, w, stride, dil, *args))
            bound, by = cs.k3_bound_ms(ops, in_bytes, m, c_out, kk, moved)
            row = {"ms": ms, "bound_ms": bound, "bound_by": by, "int_mm_ms": lib_ms,
                   "per_forward": per_fwd, "epilogue_run": epi,
                   "executed_taps": plan.executed_taps if plan else None}
            res["k3"][f"{name} | {spec}"] = row
            for key in total:
                total[key] += per_fwd * row[key]
            print(f"K3 {name:36s} x{per_fwd} {spec:19s} ({epi:9s}) {ms:.4f} ms  bound "
                  f"{bound:.4f} ms ({by}) -> {bound / ms:.1%}; _int_mm {lib_ms:.4f}"
                  + (f"; taps executed {plan.executed_taps:.3f}" if plan else ""), flush=True)
            if variants:
                ref = k3.epilogue_plain(acc, *args)
                ref = ref if isinstance(ref, tuple) else (ref,)
                row["variants_ms"] = {}
                for vname, (lib, exact) in variants.items():
                    use(lib)
                    if exact:
                        got = k3.conv_i8(x, w, stride, dil, *args)
                        got = got if isinstance(got, tuple) else (got,)
                        if not all(torch.equal(a, b) for a, b in zip(got, ref) if a is not None):
                            raise RuntimeError(f"variant {vname} differs from the plain version "
                                               f"at {name} ({spec})")
                    row["variants_ms"][vname] = timed(lambda: k3.conv_i8(x, w, stride, dil, *args))
                    total_variants[vname] += per_fwd * row["variants_ms"][vname]
                use(kernel)
                print("   variants " + " ".join(f"{v} {t:.4f}" for v, t in
                                                row["variants_ms"].items()), flush=True)
            del r
        del x, w, a_mat, b_mat, acc
    res["k3"]["forward"] = total
    print(f"K3 the 19 block convs of a forward: {total['ms']:.3f} ms, bound "
          f"{total['bound_ms']:.3f}, _int_mm {total['int_mm_ms']:.3f}", flush=True)
    if variants:
        res["k3"]["forward_variants_ms"] = total_variants
        print("K3 variants, the 19 block convs of a forward (ms): "
              + ", ".join(f"{v} {t:.3f}" for v, t in total_variants.items()), flush=True)


K4_CASES = [("stem bf16", "POOL_STEM", 3, 1, "bfloat16"),
            ("stem f32", "POOL_STEM", 3, 1, "float32"),
            ("unet bf16", "POOL_UNET", 2, 0, "bfloat16")]


_K4_NO_FINALIZE = ("      finalize(bd, xsl, ysm, ism);", "")
_K4_NO_COUNT = ("      Counter<T, kVec, kPacked> cnt(yp[at]);",
                "      if (s.grid > 0) return;\n      Counter<T, kVec, kPacked> cnt(yp[at]);")
# name: (the source's lines and their replacements, bit_equal); none is bit-equal
K4_VARIANTS = {
    "no_finalize": ([_K4_NO_FINALIZE], False),
    "no_count": ([_K4_NO_COUNT], False),
    "no_compute": ([_K4_NO_FINALIZE, _K4_NO_COUNT], False),
    "no_copies": ([("  auto stage_x = [&](int xd) {\n",
                    "  auto stage_x = [&](int xd) {\n    if (s.grid > 0) return;\n"),
                   ("  auto stage_yg = [&](int md) {\n",
                    "  auto stage_yg = [&](int md) {\n    if (s.grid > 0) return;\n")], False),
}


def k4_bench(torch, cs, k4, dev, timed, res, variants=None):
    """K4 at phase 21's shapes beside its bound, ATen's backward and the
    plain version; with `variants` ({name: (CDLL, bit_equal)}), the stem
    pool through each."""
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(cs.SEED + 21)
    for name, shape_name, window, padding, dtype_name in K4_CASES:
        shape, dtype = getattr(cs, shape_name), getattr(torch, dtype_name)
        x = torch.randn(shape, generator=g, device=dev).clamp_(min=0).to(dtype)
        y = k4.max_pool_3d_fast(x, window, 2, padding)
        gy = torch.randn(tuple(y.shape), generator=g, device=dev).to(dtype)
        xp = x.permute(0, 4, 1, 2, 3)
        _, idx = F.max_pool3d(xp, window, 2, padding, return_indices=True)
        gp = gy.permute(0, 4, 1, 2, 3)

        def aten():
            return torch.ops.aten.max_pool3d_with_indices_backward(
                gp, xp, [window] * 3, [2] * 3, [padding] * 3, [1] * 3, False, idx)

        bound, by = cs.k4_bound_ms(x, y, window)
        ms = timed(lambda: k4.max_pool_3d_fast_backward(x, y, gy, window, padding))
        row = {"ms": ms, "bound_ms": bound, "bound_by": by, "aten_backward_ms": timed(aten),
               "plain_ms": timed(lambda: k4.max_pool_3d_fast_plain(x, y, gy, window, padding)),
               "gb_per_s": cs.k4_moved_bytes(x, y) / ms / 1e6}
        if hasattr(k4, "card_geometry"):
            geo = k4.card_geometry(x, window, padding)
            row["geometry"] = {"path": geo.path, "grid": geo.grid, "threads": geo.threads,
                               "smem": geo.smem, "per_sm": geo.per_sm, "waves": geo.waves,
                               "patch": [geo.th, geo.tw], "group_units": geo.nv, "kd": geo.kd}
        res["k4"][name] = row
        print(f"K4 {name:10s} {tuple(shape)} {ms:.4f} ms  bound {bound:.4f} ms ({by}) -> "
              f"{bound / ms:.1%}, {row['gb_per_s']:.0f} GB/s; ATen {row['aten_backward_ms']:.4f}, "
              f"plain {row['plain_ms']:.4f}"
              + (f"; {geo.path}, {geo.grid} CTAs x {geo.threads}, {geo.smem} B shared, "
                 f"{geo.per_sm} an SM, {geo.waves:.2f} waves" if "geometry" in row else ""),
              flush=True)
        if variants and shape_name == "POOL_STEM":
            from multimodal_ad_tpu_torch.ops import _build
            kernel = _build.load("max_pool")
            row["variants_ms"] = {}
            for vname, (lib, _) in variants.items():
                _build._loaded["max_pool"] = lib
                k4._lib()  # declares the C signature on first use
                row["variants_ms"][vname] = timed(
                    lambda: k4.max_pool_3d_fast_backward(x, y, gy, window, padding))
            _build._loaded["max_pool"] = kernel
            print("   variants " + " ".join(f"{v} {t:.4f}" for v, t in row["variants_ms"].items()),
                  flush=True)
        del x, y, gy, idx, xp, gp


if __name__ == "__main__":
    sys.exit(main())
