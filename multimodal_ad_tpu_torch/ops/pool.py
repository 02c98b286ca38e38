"""3-D max pooling whose backward splits each window's cotangent among its
tied maxima (K4; port of the TPU package's ops/pool.py).

`max_pool_3d_fast(x, window, stride, padding)` takes a channels-last
(B, D, H, W, C) input. Its forward is the ordinary max pool (-inf padding):
stock `F.max_pool3d` on the channels-last NCDHW view. Its backward follows
the TPU package's rule: for each output m,

    count[m] = number of window elements equal to y[m] (padding never counts)
    inv[m]   = g[m] / count[m]

and each input element gets the sum of inv[m] over the windows m that hold
it and whose maximum it equals, cast to x's type. A stock max-pool backward
(ATen's, XLA's select-and-scatter) gives a window's whole cotangent to one
of its maxima instead; the two agree where no window is tied and both keep
each window's gradient mass. Ties are common after a ReLU (zero plateaus).
Only stride 2 has a backward (NotImplementedError otherwise), as in the TPU
package; the forward takes any stride.

- On a CUDA tensor the backward is `max_pool_3d_fast_backward`, which
  launches the hand-written kernel in csrc/max_pool.cu, one launch a
  backward, with the launch geometry `k4_geometry` computes here (tiling,
  grid, shared memory; `card_geometry` on the card), and raises on
  anything it does not take.
- On a CPU tensor it runs `max_pool_3d_fast_plain`, the TPU package's dense
  per-offset form in plain PyTorch: strided slices of the padded input, the
  equality indicator, the g / count split, and the stride-phase assembly by
  pad / stack / reshape, with its offset order and its arithmetic in g's
  type, so the CPU rounds as the TPU package does.

No model routes this function (the ResNet's pool is `nn.MaxPool3d`, as the
TPU package's is `nn.max_pool`): it is an operator of the port's API.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import asdict, dataclass
from itertools import product

import torch
import torch.nn.functional as F

from . import _build

_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_ELEMS = 2 ** 31  # the kernel indexes in int32

# The H100 SXM the kernel is written for (NVIDIA's data sheet; CUDA's sm_90 limits)
SMS = 132
SMEM_BLOCK = 232_448  # shared memory one block may request
SMEM_SM = 233_472     # shared memory of an SM; each resident block also holds 1 KB
REGS_SM = 65_536      # 32-bit registers of an SM
REGS_THREAD = 128     # at most, by csrc/max_pool.cu's __launch_bounds__(256, 2)
# K4's tiling: the fastest at the stem pool of the tilings timed on an H100
# (PERF.md §6)
STAGED_THREADS = 256
DIRECT_THREADS = 128
PATCH = (4, 8)    # input blocks along H and W of a staged CTA's patch
GROUP_UNITS = 4   # 16-byte units of C a staged CTA takes (64 bytes a position)
MIN_WAVES = 4     # D-chunks are cut until the grid holds this many waves

# K4Geometry's fields in the order of csrc/max_pool.cu's struct Geo
GEO_FIELDS = ("b", "d", "h", "w", "c", "od", "oh", "ow", "window", "padding",
              "vec", "cvec", "nv", "lg_nv", "groups", "th", "tw", "kd", "nph", "npw", "ncd",
              "wlo", "nwh", "nww", "xh", "xw", "xws", "nxs", "nys", "nis",
              "ext_d", "ext_h", "ext_w", "ncol", "threads", "grid", "smem",
              "off_y", "off_g", "off_inv")


def _out_extent(n: int, window: int, stride: int, padding: int) -> int:
    return (n + 2 * padding - window) // stride + 1


@dataclass(frozen=True)
class K4Geometry:
    """K4's launch geometry (see csrc/max_pool.cu). Sizes are in units of
    `vec` channels (16 bytes, or one element); the fields of the other path
    are 0.

    Both paths cut the input into blocks: along an axis, block m holds the
    inputs i in {2m - p, 2m - p + 1}, those whose last window is m, for m <
    ext_* = ceil((n + p) / 2); its windows are m + wlo .. m, wlo = 1 -
    ceil(w / 2).
    direct (window <= 2): a thread a block and a unit; a CTA `threads` of
    them along a row (b, md, mh) of blocks, `ncol` CTAs a row.
    staged (window >= 3): a CTA takes th x tw blocks along (H, W) and kd
    block planes along D, of one batch row and one group of nv units; its
    windows start at the first block's + wlo (nwh x nww of them), which
    read the x box of xh x xw positions from twice that, minus p. Shared
    memory holds nxs x planes of the box (each row by column parity, xws
    positions a parity), nys y planes, 2 g planes and nis float32 inv
    planes of the windows."""

    b: int
    d: int
    h: int
    w: int
    c: int
    od: int
    oh: int
    ow: int
    window: int
    padding: int
    vec: int
    cvec: int
    nv: int
    lg_nv: int
    groups: int
    th: int
    tw: int
    kd: int
    nph: int
    npw: int
    ncd: int
    wlo: int
    nwh: int
    nww: int
    xh: int
    xw: int
    xws: int
    nxs: int
    nys: int
    nis: int
    ext_d: int
    ext_h: int
    ext_w: int
    ncol: int
    threads: int
    grid: int
    smem: int
    off_y: int
    off_g: int
    off_inv: int
    per_sm: int  # blocks an SM holds (not passed to the kernel)

    @property
    def path(self) -> str:
        return "direct" if self.window <= 2 else "staged"

    @property
    def waves(self) -> float:
        return self.grid / (SMS * self.per_sm)

    def as_ctypes(self):
        values = asdict(self)
        return (ctypes.c_int * len(GEO_FIELDS))(*(values[f] for f in GEO_FIELDS))


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _staged_smem(itemsize, vec, nv, window, nwh, nww, xh, xws):
    """(off_y, off_g, off_inv, total) bytes of a staged CTA's rings."""
    unit = vec * itemsize
    w_plane = nwh * nww * nv
    aw = _ceil_div(window, 2)
    off_y = _ceil_div((window + 2) * xh * 2 * xws * nv * unit, 16) * 16
    off_g = off_y + _ceil_div((aw + 1) * w_plane * unit, 16) * 16
    off_inv = off_g + _ceil_div(2 * w_plane * unit, 16) * 16
    return off_y, off_g, off_inv, off_inv + aw * w_plane * vec * 4


def budget_blocks_per_sm(vec: int, threads: int, smem: int) -> int:
    """Blocks of K4 an SM holds at the least: by shared memory, threads and
    REGS_THREAD registers a thread (the card's count, which `card_geometry`
    asks for, is at least this)."""
    by_smem = SMEM_SM // (smem + 1024) if smem else 32
    return min(by_smem, 2048 // threads, REGS_SM // (REGS_THREAD * threads), 32)


def k4_geometry(shape, itemsize: int, window: int, padding: int, aligned: bool = True,
                blocks_per_sm=budget_blocks_per_sm, *, _tiling=None) -> K4Geometry:
    """K4's launch geometry for an input of `shape` (B, D, H, W, C) of
    `itemsize`-byte elements at stride 2. `aligned`: x, y, g and dx start
    on 16 bytes (else one-element units). `blocks_per_sm(vec, threads,
    smem)`: the blocks of the kernel an SM holds; the staged path cuts D
    into chunks until the grid holds MIN_WAVES waves of them. `_tiling`
    ({"patch", "group_units", "kd"}) replaces the staged tiling's constants
    (tests). Raises ValueError when a staged CTA's rings do not fit in
    shared memory at any tiling."""
    tiling = {"patch": PATCH, "group_units": GROUP_UNITS, "kd": None, **(_tiling or {})}
    patch, group_units, kd = tiling["patch"], tiling["group_units"], tiling["kd"]
    b, d, h, w, c = shape
    od, oh, ow = (_out_extent(n, window, 2, padding) for n in (d, h, w))
    lanes = 16 // itemsize
    vec = lanes if aligned and c % lanes == 0 else 1
    cvec = c // vec
    ext_d, ext_h, ext_w = (_ceil_div(n + padding, 2) for n in (d, h, w))
    f = dict.fromkeys((*GEO_FIELDS, "per_sm"), 0)
    f.update(b=b, d=d, h=h, w=w, c=c, od=od, oh=oh, ow=ow, window=window, padding=padding,
             vec=vec, cvec=cvec, ext_d=ext_d, ext_h=ext_h, ext_w=ext_w)
    if window <= 2:
        ncol = _ceil_div(ext_w * cvec, DIRECT_THREADS)
        f.update(ncol=ncol, threads=DIRECT_THREADS, grid=b * ext_d * ext_h * ncol,
                 per_sm=blocks_per_sm(vec, DIRECT_THREADS, 0))
        return K4Geometry(**f)
    wlo = 1 - _ceil_div(window, 2)
    th, tw = min(patch[0], ext_h), min(patch[1], ext_w)
    nv = 1 << (min(group_units, cvec).bit_length() - 1)  # a power of two
    while True:
        nwh, nww = th - wlo, tw - wlo
        xh, xw = 2 * nwh - 2 + window, 2 * nww - 2 + window
        xws = _ceil_div(xw, 2) | 1  # odd: the two parities of a row on other banks
        off_y, off_g, off_inv, smem = _staged_smem(itemsize, vec, nv, window, nwh, nww, xh, xws)
        if smem <= SMEM_BLOCK:
            break
        if tw > 1:
            tw = _ceil_div(tw, 2)
        elif th > 1:
            th = _ceil_div(th, 2)
        elif nv > 1:
            nv //= 2
        else:
            raise ValueError(f"K4: a {window}^3 window's rings need {smem} bytes of shared "
                             f"memory, more than {SMEM_BLOCK}")
    groups = _ceil_div(cvec, nv)
    nph, npw = _ceil_div(ext_h, th), _ceil_div(ext_w, tw)
    aw = _ceil_div(window, 2)
    f.update(nv=nv, lg_nv=nv.bit_length() - 1, groups=groups, th=th, tw=tw, nph=nph, npw=npw,
             wlo=wlo, nwh=nwh, nww=nww, xh=xh, xw=xw, xws=xws, nxs=window + 2, nys=aw + 1,
             nis=aw, threads=STAGED_THREADS, smem=smem, off_y=off_y, off_g=off_g,
             off_inv=off_inv, per_sm=blocks_per_sm(vec, STAGED_THREADS, smem))
    if kd is None:
        base_grid = b * groups * nph * npw
        kd = _ceil_div(ext_d, min(ext_d, _ceil_div(MIN_WAVES * SMS * f["per_sm"], base_grid)))
    kd = max(1, min(kd, ext_d))
    ncd = _ceil_div(ext_d, kd)
    f.update(kd=kd, ncd=ncd, grid=b * groups * nph * npw * ncd)
    return K4Geometry(**f)


def _check_input(x: torch.Tensor) -> None:
    if x.dim() != 5:
        raise ValueError(f"max_pool_3d_fast takes (B, D, H, W, C), got {tuple(x.shape)}")


def max_pool_3d_fast_plain(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
                           window: int = 3, padding: int = 1) -> torch.Tensor:
    """Plain PyTorch version of `max_pool_3d_fast_backward` (stride 2):
    the TPU package's dense per-offset form, step for step."""
    b, d_in, h_in, w_in, c = x.shape
    out_sp = tuple(y.shape[1:4])
    spatial = (d_in, h_in, w_in)
    neg = (torch.finfo(x.dtype).min if x.is_floating_point()
           else torch.iinfo(x.dtype).min)
    # pad so every (offset, output-position) slice is in range:
    # input index i = 2m + o - p, m in [0, out), o in [0, window)
    hi = [max(0, 2 * (no - 1) + (window - 1) - padding - (n - 1))
          for n, no in zip(spatial, out_sp)]
    xpad = F.pad(x, (0, 0, padding, hi[2], padding, hi[1], padding, hi[0]), value=neg)

    def offset_slice(o):
        """x values each window reads at offset o, on the output grid."""
        return xpad[:, o[0]:o[0] + 2 * (out_sp[0] - 1) + 1:2,
                    o[1]:o[1] + 2 * (out_sp[1] - 1) + 1:2,
                    o[2]:o[2] + 2 * (out_sp[2] - 1) + 1:2, :]

    offsets = list(product(range(window), repeat=3))
    inds = {o: offset_slice(o) == y for o in offsets}
    count = sum(ind.to(g.dtype) for ind in inds.values())
    inv = g / count  # every window has >= 1 real max, so count >= 1

    # phase grids: i = 2q + r, r in {0, 1}; phase r covers q in [0, Qr)
    q_max = [(n + 1) // 2 for n in spatial]  # r = 0

    def q_len(ax, r):
        return (spatial[ax] - r + 1) // 2

    phases = {}
    for o in offsets:
        p_o = inds[o].to(g.dtype) * inv
        r = tuple((oa - padding) % 2 for oa in o)
        s = tuple((oa - padding - ra) // 2 for oa, ra in zip(o, r))
        # the contribution lands at q = m + s; clip to the phase's valid range
        lo = [max(0, -sa) for sa in s]
        hi_m = [min(out_sp[ax], q_len(ax, r[ax]) - s[ax]) for ax in range(3)]
        if any(lo[ax] >= hi_m[ax] for ax in range(3)):
            continue
        sl = p_o[:, lo[0]:hi_m[0], lo[1]:hi_m[1], lo[2]:hi_m[2], :]
        pads = [(lo[ax] + s[ax], q_max[ax] - (hi_m[ax] + s[ax])) for ax in range(3)]
        contrib = F.pad(sl, (0, 0, *pads[2], *pads[1], *pads[0]))
        phases[r] = contrib if r not in phases else phases[r] + contrib

    zeros = torch.zeros((b, *q_max, c), dtype=g.dtype, device=g.device)
    stacked = torch.stack([phases.get((rd, rh, rw), zeros)
                           for rd in (0, 1) for rh in (0, 1) for rw in (0, 1)])
    stacked = stacked.reshape(2, 2, 2, b, *q_max, c)
    # (rd, rh, rw, B, Qd, Qh, Qw, C) -> (B, Qd, rd, Qh, rh, Qw, rw, C) -> interleave
    grad = stacked.permute(3, 4, 0, 5, 1, 6, 2, 7).reshape(
        b, 2 * q_max[0], 2 * q_max[1], 2 * q_max[2], c)
    return grad[:, :d_in, :h_in, :w_in, :].to(x.dtype)


def _lib():
    lib = _build.load("max_pool")
    fn = lib.mad_max_pool_backward
    if fn.argtypes is None:  # first use: declare the C signatures
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, p, i, p, i, p]
        fn.restype = ctypes.c_int
        lib.mad_max_pool_blocks_per_sm.argtypes = [i, i, i, i, i, i, ctypes.POINTER(i)]
        lib.mad_max_pool_blocks_per_sm.restype = ctypes.c_int
        lib.mad_max_pool_error_string.argtypes = [ctypes.c_int]
        lib.mad_max_pool_error_string.restype = ctypes.c_char_p
    return lib


def _check_rc(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: {lib.mad_max_pool_error_string(rc).decode()}")


@functools.lru_cache(maxsize=None)
def _card_blocks_per_sm(device: int, dtype: torch.dtype, window: int, vec: int, threads: int,
                        smem: int) -> int:
    lib = _lib()
    blocks = ctypes.c_int(0)
    _check_rc(lib, lib.mad_max_pool_blocks_per_sm(_CODES[dtype], window, vec, threads, smem,
                                                  device, ctypes.byref(blocks)),
              "max_pool occupancy query")
    if blocks.value < 1:
        raise RuntimeError(f"K4: no block of {threads} threads and {smem} B of shared memory "
                           "fits an SM")
    return blocks.value


def card_geometry(x: torch.Tensor, window: int, padding: int, aligned: bool = True) -> K4Geometry:
    """`k4_geometry` of the CUDA tensor x, with the blocks an SM holds as
    its card counts them for the kernel the launch runs (registers too:
    cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    return k4_geometry(tuple(x.shape), x.element_size(), window, padding, aligned,
                       functools.partial(_card_blocks_per_sm, x.device.index or 0, x.dtype,
                                         window))


def max_pool_3d_fast_backward(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
                              window: int = 3, padding: int = 1) -> torch.Tensor:
    """The input's gradient (B, D, H, W, C) in x's type, at stride 2, from
    x, its pooled max y and y's cotangent g (both (B, OD, OH, OW, C)).

    On CUDA, x, y and g share one type (float32, bfloat16 or float16) and
    one device, and 0 <= padding < window."""
    if x.device.type == "cpu":
        return max_pool_3d_fast_plain(x, y, g, window, padding)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_input(x)
    if x.dtype not in _CODES:
        raise TypeError(f"K4 takes float32, bfloat16 or float16, got {x.dtype}")
    if y.dtype != x.dtype or g.dtype != x.dtype:
        raise TypeError(f"K4 takes one type: x {x.dtype}, y {y.dtype}, g {g.dtype}")
    if y.device != x.device or g.device != x.device:
        raise ValueError(f"x on {x.device}, y on {y.device}, g on {g.device}")
    if not 0 <= padding < window:
        raise ValueError(f"K4 needs 0 <= padding < window, got {padding}, {window}")
    b, d, h, w, c = x.shape
    out = (b, *(_out_extent(n, window, 2, padding) for n in (d, h, w)), c)
    if tuple(y.shape) != out or tuple(g.shape) != out:
        raise ValueError(f"y {tuple(y.shape)} and g {tuple(g.shape)} must be {out}")
    if x.numel() >= _MAX_ELEMS:
        raise ValueError(f"K4 indexes in int32: {x.numel()} elements")
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    if x.numel() == 0:
        return dx
    x, y, g = x.contiguous(), y.contiguous(), g.contiguous()
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, y, g, dx))
    geo = card_geometry(x, window, padding, aligned).as_ctypes()
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _check_rc(lib, lib.mad_max_pool_backward(x.data_ptr(), y.data_ptr(), g.data_ptr(),
                                             _CODES[x.dtype], geo, len(geo), dx.data_ptr(),
                                             x.device.index or 0, stream),
              "max_pool backward launch")
    max_pool_3d_fast_backward.launches += 1
    return dx


max_pool_3d_fast_backward.launches = 0  # K4 launches; chip_smoke.py resets and reads it


def _max_pool(x: torch.Tensor, window: int, stride: int, padding: int) -> torch.Tensor:
    y = F.max_pool3d(x.permute(0, 4, 1, 2, 3), window, stride, padding)
    return y.permute(0, 2, 3, 4, 1).contiguous()


class _MaxPool3dFast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, window, stride, padding):
        y = _max_pool(x, window, stride, padding)
        ctx.save_for_backward(x, y)
        ctx.pool = (window, stride, padding)
        return y

    @staticmethod
    def backward(ctx, g):
        window, stride, padding = ctx.pool
        if stride != 2:
            raise NotImplementedError("max_pool_3d_fast backward: stride 2 only")
        x, y = ctx.saved_tensors
        return max_pool_3d_fast_backward(x, y, g, window, padding), None, None, None


def max_pool_3d_fast(x: torch.Tensor, window: int = 3, stride: int = 2,
                     padding: int = 1) -> torch.Tensor:
    """Max pool of a channels-last (B, D, H, W, C) tensor -> (B, OD, OH,
    OW, C), with the tie-splitting backward (see the module docstring)."""
    _check_input(x)
    return _MaxPool3dFast.apply(x, window, stride, padding)
