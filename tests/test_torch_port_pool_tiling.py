"""K4's launch geometry and schedule on the CPU (ops/pool.py::k4_geometry,
csrc/max_pool.cu), before any card runs the kernel:

- the geometry owns every input element exactly once (direct blocks;
  staged patches, D-chunks and channel groups);
- each staged CTA's windows cover every window its inputs need, and its x
  box and its march along D every x value those windows read;
- the shared-memory request fits a block (232,448 bytes);
- the grid holds at least MIN_WAVES waves at the stem and U-Net pools,
  counting the blocks an SM holds by shared memory, threads and the
  register cap of the kernel's __launch_bounds__ (the card's own count,
  which the wrapper asks for, is at least that);
- a numpy emulation of the kernel's per-CTA schedule (the patch and its
  halo in the parity-split x ring, y, g and float32 inv rings by slot, the
  plane-by-plane march with its prefetch, the finalize order: descending
  md, mh, mw) is bit-equal to `max_pool_3d_fast_plain` in float32 at the
  K4 cuda tests' shapes, at the default tiling and at others.

The six shapes are `K4_CASES` of test_torch_port_guards.py; the stem pool
is the ResNet-18's (8, 46, 55, 46, 64) 3^3/p1, the U-Net pool (2, 96, 112,
96, 64) 2^3/p0, as chip_smoke.py phase 21 drives them."""

import numpy as np
import pytest
import torch

from multimodal_ad_tpu_torch.ops import pool as tk4
from test_torch_port_guards import K4_CASES
from test_torch_port_support import cap_torch_threads

cap_torch_threads()

STEM = (3, 1, (8, 46, 55, 46, 64))
UNET = (2, 0, (2, 96, 112, 96, 64))
SHAPES = K4_CASES + [STEM, UNET]
SHAPE_IDS = [f"{w}^3p{p}-{'x'.join(map(str, s))}" for w, p, s in SHAPES]
ITEMSIZES = {"float32": 4, "bfloat16": 2}


def _geometries(window, padding, shape):
    for name, size in ITEMSIZES.items():
        for aligned in (True, False):
            yield f"{name}{'' if aligned else ' unaligned'}", tk4.k4_geometry(
                shape, size, window, padding, aligned)


def _window_range(i, n_out, window, padding):
    """The windows [lo, hi] holding input index i along an axis (may be empty)."""
    return max((i + padding - window + 2) // 2, 0), min((i + padding) // 2, n_out - 1)


def _staged_parts(n, ext, t, parts, window, padding, geo):
    """Per part P along an axis: (its inputs, first window, windows staged,
    first x index, x extent)."""
    for p_idx in range(parts):
        blocks = np.arange(t * p_idx, min(t * (p_idx + 1), ext))
        inputs = [i for m in blocks for i in (2 * m - padding, 2 * m - padding + 1) if 0 <= i < n]
        m0 = t * p_idx + geo.wlo
        yield inputs, m0, t - geo.wlo, 2 * m0 - padding, 2 * (t - geo.wlo) - 2 + window


@pytest.mark.parametrize("window,padding,shape", SHAPES, ids=SHAPE_IDS)
def test_geometry_owns_every_input_once(window, padding, shape):
    b, d, h, w, c = shape
    for name, geo in _geometries(window, padding, shape):
        assert geo.vec * geo.cvec == c, name
        if geo.path == "direct":
            # input i of an axis belongs to block floor((i + p) / 2) < ext
            for n, ext in ((d, geo.ext_d), (h, geo.ext_h), (w, geo.ext_w)):
                owner = (np.arange(n) + padding) // 2
                assert owner.min() == 0 and owner.max() == ext - 1, name
                # a block holds i in {2m - p, 2m - p + 1}: at most 2 an axis
                assert np.bincount(owner).max() <= 2, name
            assert geo.ncol * geo.threads >= geo.ext_w * geo.cvec, name
            assert geo.grid == b * geo.ext_d * geo.ext_h * geo.ncol, name
            continue
        counts = {}
        for axis, n, ext, t, parts in (("d", d, geo.ext_d, geo.kd, geo.ncd),
                                       ("h", h, geo.ext_h, geo.th, geo.nph),
                                       ("w", w, geo.ext_w, geo.tw, geo.npw)):
            # a part owns blocks [t P, t (P + 1)); block m the inputs 2m - p, 2m - p + 1
            hits = np.zeros(n, np.int64)
            for p_idx in range(parts):
                blocks = np.arange(t * p_idx, min(t * (p_idx + 1), ext))
                assert blocks.size, f"{name}: an empty {axis} part"
                inputs = np.concatenate([2 * blocks - padding, 2 * blocks - padding + 1])
                np.add.at(hits, inputs[(inputs >= 0) & (inputs < n)], 1)
            assert (hits == 1).all(), f"{name}: {axis} owned {hits.tolist()}"
            counts[axis] = parts
        units = np.zeros(geo.cvec, np.int64)
        for grp in range(geo.groups):
            units[grp * geo.nv:min((grp + 1) * geo.nv, geo.cvec)] += 1
        assert (units == 1).all(), name
        assert geo.nv & (geo.nv - 1) == 0 and geo.nv == 1 << geo.lg_nv, name
        assert geo.grid == b * geo.groups * counts["d"] * counts["h"] * counts["w"], name


@pytest.mark.parametrize("window,padding,shape", SHAPES, ids=SHAPE_IDS)
def test_staged_box_covers_every_window(window, padding, shape):
    """Along H and W, every window of every owned input is among the
    patch's staged windows, and every x index those windows read (in the
    volume) is in the staged box; along D, the march from the chunk's
    first window plane to its last covers the windows of every owned
    plane, and each window plane's x planes are staged by then."""
    _, d, h, w, _ = shape
    for name, geo in _geometries(window, padding, shape):
        if geo.path == "direct":
            continue
        for axis, n, n_out, ext, t, parts in (("h", h, geo.oh, geo.ext_h, geo.th, geo.nph),
                                              ("w", w, geo.ow, geo.ext_w, geo.tw, geo.npw)):
            for inputs, m0, nw, x0, nx in _staged_parts(n, ext, t, parts, window, padding, geo):
                for i in inputs:
                    lo, hi = _window_range(i, n_out, window, padding)
                    assert x0 <= i < x0 + nx, name
                    if lo > hi:
                        continue
                    assert m0 <= lo and hi < m0 + nw, f"{name}: {axis} {i} needs {lo}..{hi}"
                    for m in range(lo, hi + 1):
                        reads = [2 * m - padding + o for o in range(window)]
                        assert all(x0 <= r < x0 + nx for r in reads if 0 <= r < n), name
        for inputs, k0, _, _, _ in _staged_parts(d, geo.ext_d, geo.kd, geo.ncd, window,
                                                  padding, geo):
            k0 -= geo.wlo  # the chunk's first block plane
            k1 = min(k0 + geo.kd, geo.ext_d)
            mstart, mend = max(0, k0 + geo.wlo), min(geo.od - 1, k1 - 1)
            for i in inputs:
                lo, hi = _window_range(i, geo.od, window, padding)
                if lo > hi:
                    continue
                assert mstart <= lo and hi <= mend, f"{name}: plane {i} needs {lo}..{hi}"
                # written at window plane hi: the rings still hold its windows,
                # and window plane hi's x planes hold it
                assert hi - lo < geo.nis and hi - lo < geo.nys - 1, name
                assert 2 * hi - padding <= i < 2 * hi - padding + window, name


@pytest.mark.parametrize("window,padding,shape", SHAPES, ids=SHAPE_IDS)
def test_shared_memory_fits_a_block(window, padding, shape):
    for name, geo in _geometries(window, padding, shape):
        assert 0 <= geo.smem <= 232_448, f"{name}: {geo.smem} bytes"
        assert geo.off_y % 16 == 0 and geo.off_g % 16 == 0 and geo.off_inv % 16 == 0, name
        if geo.path == "staged":
            assert geo.per_sm >= 1 and geo.threads <= 256, name


@pytest.mark.parametrize("window,padding,shape,itemsize",
                         [(*STEM, 2), (*STEM, 4), (*UNET, 2)],
                         ids=["stem bf16", "stem f32", "unet bf16"])
def test_grid_meets_the_wave_target(window, padding, shape, itemsize):
    geo = tk4.k4_geometry(shape, itemsize, window, padding)
    assert geo.vec == 16 // itemsize  # 16-byte units at C = 64
    assert geo.waves >= tk4.MIN_WAVES, f"{geo.grid} CTAs, {geo.per_sm} an SM: {geo.waves:.2f}"


@pytest.mark.parametrize("threads,smem,regs,expect", [
    (128, 0, 77, 6), (128, 0, 128, 4), (256, 103_360, 127, 2), (256, 40_000, 64, 4),
    (256, 40_000, 128, 2), (256, 200_000, 32, 1),
], ids=["direct 77 regs", "direct at the cap", "stem bf16", "small rings",
        "small rings at the cap", "large rings"])
def test_blocks_per_sm_counts_registers(threads, smem, regs, expect):
    """The budget takes the register cap (128 a thread); an SM's count with
    `regs` registers a thread (allocated by warps, in steps of 8) is what
    the card reports, and never below the budget."""
    warp_regs = -(-regs // 8) * 8 * 32
    by_regs = 65_536 // (warp_regs * (threads // 32))
    by_smem = 233_472 // (smem + 1024) if smem else 32
    card = min(by_regs, by_smem, 2048 // threads, 32)
    assert card == expect
    budget = tk4.budget_blocks_per_sm(8, threads, smem)
    assert 1 <= budget <= card
    if regs == 128:
        assert budget == card


def test_geometry_takes_the_cards_count():
    """kd follows the blocks an SM holds; the waves are counted with it."""
    stem = STEM[2]
    two = tk4.k4_geometry(stem, 2, 3, 1, blocks_per_sm=lambda vec, threads, smem: 2)
    one = tk4.k4_geometry(stem, 2, 3, 1, blocks_per_sm=lambda vec, threads, smem: 1)
    assert (two.per_sm, one.per_sm) == (2, 1)
    assert two.kd < one.kd and two.waves >= tk4.MIN_WAVES and one.waves >= tk4.MIN_WAVES
    unet = tk4.k4_geometry(UNET[2], 2, 2, 0, blocks_per_sm=lambda vec, threads, smem: 6)
    assert unet.waves == unet.grid / (tk4.SMS * 6)


def test_geometry_refuses_rings_that_do_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        tk4.k4_geometry((1, 200, 200, 200, 64), 4, 41, 20)


# ---- the numpy emulation of the kernel's schedule ---------------------------

def _emulate_direct(x, y, g, geo):
    """The direct path: one block of inputs a thread, its window counted
    over its in-volume positions."""
    b, d, h, w, _ = x.shape
    win, p = geo.window, geo.padding
    dx = np.full(x.shape, np.nan, np.float32)
    for md in range(geo.ext_d):
        for mh in range(geo.ext_h):
            for mw in range(geo.ext_w):
                i0 = (2 * md - p, 2 * mh - p, 2 * mw - p)
                real = md < geo.od and mh < geo.oh and mw < geo.ow
                block = [(jd, jh, jw) for jd in (0, 1) for jh in (0, 1) for jw in (0, 1)
                         if 0 <= i0[0] + jd < d and 0 <= i0[1] + jh < h and 0 <= i0[2] + jw < w]
                if real:
                    yv, gv = y[:, md, mh, mw], g[:, md, mh, mw]
                    cnt = np.zeros_like(yv)
                    for jd, jh, jw in block:
                        if max(jd, jh, jw) < win:
                            cnt += x[:, i0[0] + jd, i0[1] + jh, i0[2] + jw] == yv
                    inv = gv / cnt
                for jd, jh, jw in block:
                    acc = np.zeros((b, x.shape[-1]), np.float32)
                    if real and max(jd, jh, jw) < win:
                        xv = x[:, i0[0] + jd, i0[1] + jh, i0[2] + jw]
                        acc = acc + (xv == yv).astype(np.float32) * inv
                    dx[:, i0[0] + jd, i0[1] + jh, i0[2] + jw] = acc
    return dx


def _emulate_staged(x, y, g, geo):
    """The staged path, CTA by CTA and step by step as csrc/max_pool.cu runs
    it: rings indexed by slot and overwritten in the kernel's order, so a
    slot reused too early or a window missing from a ring shows."""
    bsz, d, h, w, c = x.shape
    win, pad, nv, vec = geo.window, geo.padding, geo.nv, geo.vec
    aw = (win + 1) // 2
    xu = x.reshape(bsz, d, h, w, geo.cvec, vec)
    yu = y.reshape(bsz, geo.od, geo.oh, geo.ow, geo.cvec, vec)
    gu = g.reshape(bsz, geo.od, geo.oh, geo.ow, geo.cvec, vec)
    dx = np.full(xu.shape, np.nan, np.float32)
    rows, cols = np.arange(geo.xh)[:, None], np.arange(geo.xw)[None, :]
    wr, wc = np.arange(geo.nwh)[:, None], np.arange(geo.nww)[None, :]
    br, bc = np.arange(geo.th)[:, None], np.arange(geo.tw)[None, :]
    for b in range(bsz):
        for grp in range(geo.groups):
            units = slice(grp * nv, min(grp * nv + nv, geo.cvec))
            nvg = units.stop - units.start
            for cd in range(geo.ncd):
                for ph in range(geo.nph):
                    for pw in range(geo.npw):
                        bh0, bw0 = ph * geo.th, pw * geo.tw
                        mh0, mw0 = bh0 + geo.wlo, bw0 + geo.wlo
                        xh0, xw0 = 2 * mh0 - pad, 2 * mw0 - pad
                        k0 = cd * geo.kd
                        k1 = min(k0 + geo.kd, geo.ext_d)
                        mstart, mend = max(0, k0 + geo.wlo), min(geo.od - 1, k1 - 1)
                        mh, mw = bh0 + br, bw0 + bc  # the patch's blocks
                        blk = (mh < geo.ext_h) & (mw < geo.ext_w)

                        def store(dd, acc):
                            """acc (jh, jw, th, tw, units, vec) into dx where in the volume."""
                            for jh in (0, 1):
                                for jw in (0, 1):
                                    ih, iw = 2 * mh - pad + jh, 2 * mw - pad + jw
                                    ok = blk & (ih >= 0) & (ih < h) & (iw >= 0) & (iw < w)
                                    ihr = np.broadcast_to(ih, ok.shape)[ok]
                                    iwr = np.broadcast_to(iw, ok.shape)[ok]
                                    dx[b, dd, ihr, iwr, units] = acc[jh, jw][ok]

                        if mstart > mend:
                            for bd in range(k0, k1):
                                for jd in (0, 1):
                                    if 0 <= 2 * bd - pad + jd < d:
                                        store(2 * bd - pad + jd, np.zeros(
                                            (2, 2, geo.th, geo.tw, nvg, vec), np.float32))
                            continue
                        xs = np.full((geo.nxs, geo.xh, 2, geo.xws, nvg, vec), -1.5, np.float32)
                        ys = np.full((geo.nys, geo.nwh, geo.nww, nvg, vec), -2.5, np.float32)
                        gs = np.full((2, geo.nwh, geo.nww, nvg, vec), -3.5, np.float32)
                        inv = np.full((geo.nis, geo.nwh, geo.nww, nvg, vec), -4.5, np.float32)

                        def stage_x(xd):
                            box = np.full((geo.xh, geo.xw, nvg, vec), np.nan, np.float32)
                            ih, iw = xh0 + rows, xw0 + cols
                            ok = (ih >= 0) & (ih < h) & (iw >= 0) & (iw < w) & (0 <= xd < d)
                            if ok.any():
                                box[ok] = xu[b, xd, np.broadcast_to(ih, ok.shape)[ok],
                                             np.broadcast_to(iw, ok.shape)[ok], units]
                            slot = xd % geo.nxs
                            xs[slot, :, 0, :(geo.xw + 1) // 2] = box[:, 0::2]
                            xs[slot, :, 1, :geo.xw // 2] = box[:, 1::2]

                        def window_ok():
                            wh, wwi = mh0 + wr, mw0 + wc
                            return (wh >= 0) & (wh < geo.oh) & (wwi >= 0) & (wwi < geo.ow), wh, wwi

                        def stage_yg(md):
                            ok, wh, wwi = window_ok()
                            whr = np.broadcast_to(wh, ok.shape)[ok]
                            wwr = np.broadcast_to(wwi, ok.shape)[ok]
                            ys[md % geo.nys][ok] = yu[b, md, whr, wwr, units]
                            gs[md % 2][ok] = gu[b, md, whr, wwr, units]

                        def finalize(bd, jd, xsl, ysl, isl):
                            """The kernel's finalize of plane jd of block plane bd from
                            x slot xsl (of plane 2 bd - p) and the y and inv slots
                            of window plane min(bd, od - 1); no window range checks
                            (windows outside the output hold y NaN, inv 0)."""
                            dd = 2 * bd - pad + jd
                            if not 0 <= dd < d:
                                return
                            d_hi = min(bd, geo.od - 1)
                            n_d = d_hi - max((dd + pad - win + 2) // 2, 0)
                            xsl = xsl if jd == 0 else (0 if xsl + 1 == geo.nxs else xsl + 1)
                            rh = 2 * (mh - mh0)
                            rw = np.broadcast_to(mw - mw0, blk.shape)
                            at0h = np.broadcast_to(mh - mh0, blk.shape)
                            xf = np.stack([np.stack([
                                xs[xsl, np.broadcast_to(rh + jh, blk.shape), jw, rw]
                                for jw in (0, 1)]) for jh in (0, 1)])
                            acc = np.zeros_like(xf)
                            for ad in range(aw):
                                if ad > n_d:
                                    break
                                for ah in range(aw):
                                    for awi in range(aw):
                                        lh, lw = at0h - ah, rw - awi
                                        yv, iv = ys[ysl, lh, lw], inv[isl, lh, lw]
                                        for jh, jw in np.ndindex(2, 2):
                                            if 2 * ah <= win - 1 - jh and 2 * awi <= win - 1 - jw:
                                                ind = (xf[jh, jw] == yv).astype(np.float32)
                                                acc[jh, jw] = acc[jh, jw] + ind * iv
                                ysl = geo.nys - 1 if ysl == 0 else ysl - 1
                                isl = geo.nis - 1 if isl == 0 else isl - 1
                            store(dd, acc)

                        for xd in range(2 * mstart - pad, 2 * mstart - pad + win):
                            stage_x(xd)
                        stage_yg(mstart)
                        xsm = (2 * mstart - pad) % geo.nxs
                        ysm, ism = mstart % geo.nys, mstart % geo.nis
                        for md in range(mstart, mend + 1):
                            if md < mend:
                                last = 2 * (md + 1) - pad + win - 1
                                for xd in range(max(2 * (md + 1) - pad, last - 1), last + 1):
                                    stage_x(xd)
                                stage_yg(md + 1)
                            # count and inv of window plane md; outside the output y
                            # NaN and inv 0
                            ok, _, _ = window_ok()
                            yp = ys[ysm]
                            cnt = np.zeros_like(yp)
                            sl = xsm
                            for od in range(win):
                                for oh in range(win):
                                    for ow in range(win):
                                        xv = xs[sl, 2 * wr + oh, ow & 1, wc + (ow >> 1)]
                                        cnt += xv == yp
                                sl = 0 if sl + 1 == geo.nxs else sl + 1
                            with np.errstate(divide="ignore", invalid="ignore"):
                                inv[ism] = np.where(ok[..., None, None], gs[md % 2] / cnt, 0)
                            yp[~ok] = np.nan
                            # the chunk's block planes whose last window plane is md
                            bd_last = geo.ext_d - 1 if md == geo.od - 1 else md
                            bd0 = max(md, k0)
                            xsl = (xsm + 2 * (bd0 - md)) % geo.nxs
                            for bd in range(bd0, min(bd_last, k1 - 1) + 1):
                                for jd in (0, 1):
                                    finalize(bd, jd, xsl, ysm, ism)
                                xsl = xsl + 2 - geo.nxs if xsl + 2 >= geo.nxs else xsl + 2
                            xsm = xsm + 2 - geo.nxs if xsm + 2 >= geo.nxs else xsm + 2
                            ysm = 0 if ysm + 1 == geo.nys else ysm + 1
                            ism = 0 if ism + 1 == geo.nis else ism + 1
    return dx.reshape(x.shape)


def emulate(x, y, g, geo):
    """dx of K4's schedule on float32 numpy arrays, by `geo`'s path."""
    return (_emulate_direct if geo.path == "direct" else _emulate_staged)(x, y, g, geo)


TILINGS = {  # the default, and others that put patch and chunk edges elsewhere
    "default": {},
    "small": {"patch": (2, 3), "group_units": 2, "kd": 1},
    "wide": {"patch": (3, 16), "group_units": 8, "kd": 3},
}
LARGE_C_UNITS = 16  # "small" at C = 64 takes whole positions: 8x fewer CTAs to emulate


@pytest.mark.parametrize("tiling", sorted(TILINGS))
@pytest.mark.parametrize("window,padding,shape", K4_CASES,
                         ids=[f"{w}^3p{p}-{'x'.join(map(str, s))}" for w, p, s in K4_CASES])
def test_schedule_emulation_is_bit_equal_to_plain(window, padding, shape, tiling):
    """In float32, on a normal and a ReLU'd (tied) input, at 16-byte units
    and at one-element units (an unaligned tensor or a C off the vector)."""
    g_np = np.random.default_rng(sum(shape) + window)
    for relu in (False, True):
        x = g_np.standard_normal(shape).astype(np.float32)
        x = np.maximum(x, 0) if relu else x
        xt = torch.from_numpy(x)
        y = tk4.max_pool_3d_fast(xt, window, 2, padding).numpy()
        gy = g_np.standard_normal(y.shape).astype(np.float32)
        ref = tk4.max_pool_3d_fast_plain(xt, torch.from_numpy(y), torch.from_numpy(gy),
                                         window, padding).numpy()
        for aligned in ((True, False) if relu else (True,)):
            tiles = dict(TILINGS[tiling])
            if tiling == "small" and shape[-1] == 64:
                tiles["group_units"] = LARGE_C_UNITS
            geo = tk4.k4_geometry(shape, 4, window, padding, aligned, _tiling=tiles)
            got = emulate(x, y, gy, geo)
            assert not np.isnan(got).any(), f"{geo.path}: an input left unwritten"
            assert np.array_equal(got, ref), (
                f"{geo.path} {tiling} aligned={aligned}: max diff "
                f"{np.abs(got - ref).max():.3e}")


@pytest.mark.parametrize("window,padding,shape", [
    (3, 0, (1, 7, 6, 9, 4)), (4, 0, (1, 5, 9, 7, 4)), (4, 2, (1, 8, 6, 5, 4)),
    (5, 1, (1, 9, 8, 7, 4)), (5, 2, (1, 11, 9, 10, 4)), (2, 1, (1, 7, 6, 5, 4)),
    (1, 0, (1, 7, 6, 5, 4)),
], ids=["3p0", "4p0 (an empty chunk)", "4p2", "5p1", "5p2", "2p1", "1p0"])
def test_schedule_emulation_at_other_windows(window, padding, shape):
    """Paddings and windows the cuda tests do not take, down to chunks that
    hold no window (4^3/p0 at D = 5, kd = 1)."""
    g_np = np.random.default_rng(window * 10 + padding)
    x = np.maximum(g_np.standard_normal(shape).astype(np.float32), 0)
    xt = torch.from_numpy(x)
    y = tk4.max_pool_3d_fast(xt, window, 2, padding).numpy()
    gy = g_np.standard_normal(y.shape).astype(np.float32)
    ref = tk4.max_pool_3d_fast_plain(xt, torch.from_numpy(y), torch.from_numpy(gy),
                                     window, padding).numpy()
    for kd in (1, None):
        geo = tk4.k4_geometry(shape, 4, window, padding, _tiling={"kd": kd, "patch": (2, 2)})
        got = emulate(x, y, gy, geo)
        assert np.array_equal(got, ref), f"kd={kd}: max diff {np.abs(got - ref).max():.3e}"
