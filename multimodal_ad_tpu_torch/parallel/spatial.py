"""Spatial sharding of the 3-D ResNet over a mesh's 'space' axis: halo-
exchanged convolutions, pools and BatchNorm (the TPU package's
`spatial_sharding` path, where GSPMD partitions the convolutions of a volume
sharded along X and inserts their halo exchanges by itself; here they are
explicit).

On a mesh with a 'space' axis (parallel/mesh.py) the ranks of one data row
each hold a slab of the row's volumes along their first spatial axis X
(`spatial_sharding`). Every tensor on that axis has a layout, `Slabs`: its
whole extent and each space rank's [start, stop). A layer owns its output
extent split in `torch.tensor_split` order (`split_ranges`: balanced, the
larger slabs first, empty slabs where the ranks outnumber the planes),
except the 2^3/s2 transposed convolution, whose output ownership is its
input's doubled (no halo).

The plan (`plan_window`). For kernel k, stride s, padding p and dilation d,
output plane o reads input planes o*s - p + t*d, t < k. From the two
layouts alone, every rank works out for every rank which input planes its
outputs read, and who owns each: itself, a neighbour, a rank further away
(a halo wider than a slab), or nobody (a global edge, padded on the rank
with zeros for a convolution and -inf for a max pool). The planes some rank
borrows get one slot each in an exchange buffer. Plans are cached by
layout, so a shape is planned once.

`HaloExchange` (an autograd Function) is the only communication of a
layer. Its forward writes the planes this rank lends into their slots
(zeros elsewhere), all_reduces the buffer over the space group and
assembles the rank's window: its own planes, the borrowed ones, the edge
padding. The backward writes the gradients of the planes this rank
borrowed into their slots, all_reduces, and each owner adds its planes'
slots to its gradient. So an exchange moves the borrowed planes, never the
whole volume, with `all_reduce` alone: gloo runs it on CUDA tensors, which
is how several ranks share one card (NCCL refuses that).

A rank whose output slab is empty skips the layer's compute but joins every
exchange, forward and backward: its empty output is tied to the exchange's
window and the layer's parameters by empty sums, so autograd reaches the
exchange's backward and gives the parameters (zero) gradients, which DDP
waits for.

The stem. `StemConv` becomes `SpatialStemConv`: the plain 7^3 / s2 / p3
halo plan, and with ``s2d`` its window convolved by space-to-depth, as the
one-process stem; so a slab may have any X extent, odd or even.

Rematerialization. With ``remat=True`` each residual block runs under
`torch.utils.checkpoint` while training with gradients, as in one process;
its recomputation in the backward replays the block's halo exchanges (the
space group) and its global BatchNorm sums (the mesh group), in the block's
own order on every rank (checkpoint's early stop is off). DDP averages the
gradients over a group of its own (`parallel/mesh.py::grad_group`), so its
buckets, whose readiness may fall at other points of the backward on
different ranks, never share a communicator with the replayed sums.

The heads. The global average pool is a local sum, a differentiable sum
over the space group and a division by the whole volume's voxel count;
dropout (its generator seeded by the data coordinate, train/loop.py) and
the Linear layer follow, the same on every space rank. The 'none' and 'seg'
heads return this rank's slab of their map and its [start, stop).

Gradients. Each rank's share of the loss is its data row's share, scaled
by the data axes' size; DistributedDataParallel over the whole mesh
averages the parameter gradients over data x space ranks, so every rank in
effect takes 1 / S of its row's loss (S the space axis' size). The pool's
sum and BatchNorm's statistics have sum-over-ranks backwards, so the
partial gradients of the slabs add up to the row's gradient, and the
head's parameters, computed S times, are averaged back to one copy.

`convert_spatial(model, mesh)` turns a `ResNet3D` (any depth, shortcut A
or B, any head) into this, in place: each module's class becomes a
subclass of its own (parameters, buffers and state_dict keys unchanged, so
the plain model's checkpoints load), and its BatchNorms take their
statistics over the whole mesh (`convert_sync_batchnorm`, which counts
each rank's elements: slabs are uneven).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.nn.modules.utils import _triple
from torch.utils.checkpoint import set_checkpoint_early_stop

from ..models.resnet3d import (BasicBlock, Bottleneck, ResNet3D, ShortcutA, StemConv,
                               _remat_block)
from . import mesh as pmesh


@dataclass(frozen=True)
class Slabs:
    """The layout of a tensor on the sharded axis: its whole `extent` and
    each space rank's [start, stop)."""

    extent: int
    ranges: tuple

    @classmethod
    def split(cls, extent: int, parts: int) -> "Slabs":
        return cls(int(extent), pmesh.split_ranges(extent, parts))

    def size(self, rank: int) -> int:
        lo, hi = self.ranges[rank]
        return hi - lo

    def owners(self) -> np.ndarray:
        """The owning rank of each plane."""
        own = np.empty(self.extent, np.int64)
        for r, (lo, hi) in enumerate(self.ranges):
            own[lo:hi] = r
        return own


def out_extent(n: int, k: int, s: int, p: int, d: int) -> int:
    """Output planes of a window of size k, stride s, padding p, dilation d
    over n input planes (floor mode), at least 0."""
    return max(0, (n + 2 * p - d * (k - 1) - 1) // s + 1)


@dataclass(frozen=True)
class HaloPlan:
    """One rank's part of a windowed layer's exchange.

    The rank's window buffer covers the global input planes [lo, lo +
    length), those beyond the volume's edges filled: its own planes copied
    from local offset `own_src` to buffer offset `own_dst` (`own_count` of
    them), and the borrowed planes `recv` ((buffer offset, slot) pairs).
    It lends `send` ((slot, local offset) pairs). The exchange buffer has
    `n_slots` planes, the same on every rank; none means no exchange."""

    lo: int
    length: int
    own_src: int
    own_dst: int
    own_count: int
    recv: tuple
    send: tuple
    n_slots: int
    index_cache: dict = field(default_factory=dict, compare=False, hash=False, repr=False)

    def indices(self, device) -> tuple:
        """(recv buffer offsets, recv slots, send slots, send local offsets)
        as int64 tensors on `device`, made once a device."""
        key = str(device)
        if key not in self.index_cache:
            def t(pairs, i):
                return torch.tensor([p[i] for p in pairs], dtype=torch.int64, device=device)
            self.index_cache[key] = (t(self.recv, 0), t(self.recv, 1),
                                     t(self.send, 0), t(self.send, 1))
        return self.index_cache[key]


@functools.lru_cache(maxsize=4096)
def plan_window(src: Slabs, dst: Slabs, k: int, s: int, p: int, d: int, me: int) -> HaloPlan:
    """Rank `me`'s `HaloPlan` for a window layer (kernel k, stride s,
    padding p, dilation d) from layout `src` to layout `dst`: for each
    rank, the input planes its output planes read (o*s - p + t*d), their
    owners, and the slots of the planes borrowed by any rank."""
    owner = src.owners()
    taps = np.arange(k) * d
    needed, borrowed = [], set()
    for r, (o0, o1) in enumerate(dst.ranges):
        planes = np.unique((np.arange(o0, o1)[:, None] * s - p + taps[None, :]).ravel())
        planes = planes[(planes >= 0) & (planes < src.extent)]
        needed.append(planes)
        borrowed.update(int(i) for i in planes if owner[i] != r)
    slots = {plane: j for j, plane in enumerate(sorted(borrowed))}
    o0, o1 = dst.ranges[me]
    a, b = src.ranges[me]
    if o1 > o0:
        lo, length = o0 * s - p, (o1 - o0 - 1) * s + (k - 1) * d + 1
    else:
        lo, length = 0, 0
    c0, c1 = max(lo, a), min(lo + length, b)  # own planes inside the window
    own_count = max(0, c1 - c0)
    recv = tuple((int(i) - lo, slots[int(i)]) for i in needed[me] if owner[i] != me)
    send = tuple((j, plane - a) for plane, j in slots.items() if owner[plane] == me)
    return HaloPlan(lo, length, c0 - a if own_count else 0,
                    c0 - lo if own_count else 0, own_count, recv, send, len(slots))


class HaloExchange(torch.autograd.Function):
    """(x, plan, group, fill) -> this rank's window buffer (B, C, length,
    Y, Z): its own planes of `x` (B, C, x_r, Y, Z), the planes it borrows
    (one all_reduce of the slot buffer over `group`) and `fill` beyond the
    volume's edges (and at planes of the window no output reads). The
    backward returns the window's gradients to the planes' owners (one
    all_reduce). `exchanges` and `bytes` count this process's all_reduces
    and the bytes of their slot buffers, forward and backward."""

    exchanges = 0
    bytes = 0

    @staticmethod
    def _slots(like: torch.Tensor, plan: HaloPlan, shape) -> torch.Tensor:
        b, c, _, y, z = shape
        return like.new_zeros((b, c, plan.n_slots, y, z))

    @staticmethod
    def _reduce(buf: torch.Tensor, group) -> None:
        dist.all_reduce(buf, group=group)
        HaloExchange.exchanges += 1
        HaloExchange.bytes += buf.numel() * buf.element_size()

    @staticmethod
    def forward(ctx, x, plan: HaloPlan, group, fill: float):
        ctx.plan, ctx.group, ctx.shape = plan, group, x.shape
        b, c, _, y, z = x.shape
        out = x.new_full((b, c, plan.length, y, z), fill)
        if plan.own_count:
            out[:, :, plan.own_dst:plan.own_dst + plan.own_count] = \
                x[:, :, plan.own_src:plan.own_src + plan.own_count]
        if plan.n_slots:
            recv_pos, recv_slot, send_slot, send_src = plan.indices(x.device)
            slots = HaloExchange._slots(x, plan, x.shape)
            if plan.send:
                slots.index_copy_(2, send_slot, x.index_select(2, send_src))
            HaloExchange._reduce(slots, group)
            if plan.recv:
                out.index_copy_(2, recv_pos, slots.index_select(2, recv_slot))
        return out

    @staticmethod
    def backward(ctx, grad):
        plan = ctx.plan
        grad = grad.contiguous()
        gx = grad.new_zeros(ctx.shape)
        if plan.own_count:
            gx[:, :, plan.own_src:plan.own_src + plan.own_count] = \
                grad[:, :, plan.own_dst:plan.own_dst + plan.own_count]
        if plan.n_slots:
            recv_pos, recv_slot, send_slot, send_src = plan.indices(grad.device)
            slots = HaloExchange._slots(grad, plan, ctx.shape)
            if plan.recv:
                slots.index_copy_(2, recv_slot, grad.index_select(2, recv_pos))
            HaloExchange._reduce(slots, ctx.group)
            if plan.send:
                gx.index_add_(2, send_src, slots.index_select(2, send_slot))
        return gx, None, None, None


@dataclass(frozen=True)
class SpaceAxis:
    """The space axis as one rank sees it: its group, its size and this
    rank's index along it."""

    group: object
    parts: int
    index: int

    @classmethod
    def of(cls, mesh) -> "SpaceAxis":
        if pmesh.SPACE_AXIS not in tuple(mesh.mesh_dim_names or ()):
            raise ValueError(f"mesh axes {tuple(mesh.mesh_dim_names)} have no "
                             f"{pmesh.SPACE_AXIS!r} axis to shard a volume over")
        return cls(pmesh.space_group(mesh), pmesh.space_size(mesh), pmesh.space_rank(mesh))


def _tied_empty(shape, dtype, window: torch.Tensor, *params) -> torch.Tensor:
    """An empty tensor of `shape` whose graph reaches `window` (the
    exchange's output) and `params`: empty sums, zero in value and in
    gradient."""
    tie = window.flatten()[:0].sum().to(torch.float32)
    for t in params:
        if t is not None:
            tie = tie + t.flatten()[:0].sum()
    return window.new_empty(shape, dtype=dtype) + tie.to(dtype)


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    t = x.device.type
    return torch.get_autocast_dtype(t) if torch.is_autocast_enabled(t) else x.dtype


class _SpatialWindow:
    """A layer with a window on the sharded axis: `window()` gives (k, s, p,
    d) along X; `exchange` plans it and runs the `HaloExchange`."""

    space: SpaceAxis = None
    fill = 0.0

    def exchange(self, x: torch.Tensor, src: Slabs):
        k, s, p, d = self.window()
        dst = Slabs.split(out_extent(src.extent, k, s, p, d), self.space.parts)
        plan = plan_window(src, dst, k, s, p, d, self.space.index)
        return HaloExchange.apply(x, plan, self.space.group, self.fill), dst

    def yz_extents(self, x: torch.Tensor) -> tuple:
        k, s, p, d = (_triple(v) for v in self.yz_params())
        return tuple(out_extent(x.shape[3 + i], k[1 + i], s[1 + i], p[1 + i], d[1 + i])
                     for i in range(2))


class SpatialConv3d(_SpatialWindow, nn.Conv3d):
    """`nn.Conv3d` on a slab: any kernel, stride, padding and dilation,
    zero padding along X at the volume's edges only. ``forward(x, slabs)
    -> (y, its slabs)``."""

    def window(self):
        return (self.kernel_size[0], self.stride[0], self.padding[0], self.dilation[0])

    def yz_params(self):
        return self.kernel_size, self.stride, self.padding, self.dilation

    def forward(self, x, src: Slabs):
        if self.padding_mode != "zeros":
            raise ValueError("a spatial convolution pads with zeros")
        win, dst = self.exchange(x, src)
        if dst.size(self.space.index) == 0:
            shape = (x.shape[0], self.out_channels, 0, *self.yz_extents(x))
            return _tied_empty(shape, _compute_dtype(win), win, self.weight, self.bias), dst
        return self.conv_window(win), dst

    def conv_window(self, win: torch.Tensor) -> torch.Tensor:
        """The convolution of the exchanged window, valid along X."""
        return F.conv3d(win, self.weight, self.bias, self.stride, (0, *self.padding[1:]),
                        self.dilation, self.groups)


class SpatialStemConv(SpatialConv3d, StemConv):
    """`StemConv` (7^3 / s2 / p3) on a slab, by the plain halo plan. With
    `s2d` the window's convolution is the space-to-depth one: the window of
    output planes [o0, o1) starts at global plane 2 * o0 - 3, phase 1 of
    block o0 - 2, so one zero plane before it (a phase the kernel has no tap
    for) makes it n + 3 whole blocks (n = o1 - o0), packed without blocks of
    zeros along X (`stem_s2d_pack`) and convolved by the 4^3 kernel, valid
    along X: n output planes. A slab may have any X extent, odd or even.
    Without `s2d`, the plain halo convolution on the same weight."""

    def conv_window(self, win: torch.Tensor) -> torch.Tensor:
        if not self.s2d:
            return super().conv_window(win)
        return self.s2d_conv(F.pad(win, (0, 0, 0, 0, 1, 0)), pad_depth=False)


class SpatialMaxPool3d(_SpatialWindow, nn.MaxPool3d):
    """`nn.MaxPool3d` on a slab, -inf beyond the volume's edges along X."""

    fill = float("-inf")

    def window(self):
        k, s, p, d = self.yz_params()
        return (_triple(k)[0], _triple(s)[0], _triple(p)[0], _triple(d)[0])

    def yz_params(self):
        return self.kernel_size, self.stride, self.padding, self.dilation

    def forward(self, x, src: Slabs):
        if self.ceil_mode or self.return_indices:
            raise ValueError("a spatial max pool takes floor mode and no indices")
        win, dst = self.exchange(x, src)
        if dst.size(self.space.index) == 0:
            shape = (x.shape[0], x.shape[1], 0, *self.yz_extents(x))
            return _tied_empty(shape, win.dtype, win), dst
        k, s, p, d = (_triple(v) for v in self.yz_params())
        return F.max_pool3d(win, k, s, (0, *p[1:]), d), dst


class SpatialShortcutA(_SpatialWindow, ShortcutA):
    """Shortcut A on a slab: the strided 1^3 average pool (a window of one
    plane, stride s) and the zero channel pad."""

    def window(self):
        return (1, self.stride, 0, 1)

    def forward(self, x, src: Slabs):
        win, dst = self.exchange(x, src)
        s = self.stride
        y = win[:, :, ::s, ::s, ::s]
        pad = self.out_features - y.shape[1]
        if pad > 0:
            y = F.pad(y, (0, 0, 0, 0, 0, 0, 0, pad))
        return y, dst


class SpatialConvTranspose3d(nn.ConvTranspose3d):
    """`nn.ConvTranspose3d` with kernel = stride and no padding along X (the
    seg head's 2^3/s2) on a slab: each output plane comes from one input
    plane, so there is no halo; a rank's output planes are its input's
    scaled by the stride."""

    space: SpaceAxis = None

    def forward(self, x, src: Slabs):
        k, s = self.kernel_size[0], self.stride[0]
        if (k != s or self.padding[0] or self.output_padding[0] or self.dilation[0] != 1
                or self.padding_mode != "zeros"):
            raise ValueError("a spatial transposed convolution needs kernel = stride and "
                             "no padding along X")
        dst = Slabs(src.extent * s, tuple((a * s, b * s) for a, b in src.ranges))
        if x.shape[2] == 0:
            yz = tuple((x.shape[3 + i] - 1) * self.stride[1 + i] - 2 * self.padding[1 + i]
                       + self.dilation[1 + i] * (self.kernel_size[1 + i] - 1)
                       + self.output_padding[1 + i] + 1 for i in range(2))
            shape = (x.shape[0], self.out_channels, 0, *yz)
            return _tied_empty(shape, _compute_dtype(x), x, self.weight, self.bias), dst
        y = F.conv_transpose3d(x, self.weight, self.bias, self.stride, self.padding,
                               self.output_padding, self.groups, self.dilation)
        return y, dst


def _shortcut(downsample, x, src: Slabs):
    if isinstance(downsample, SpatialShortcutA):
        return downsample(x, src)
    conv, bn = downsample
    y, dst = conv(x, src)
    return bn(y), dst


def _add(out, out_slabs: Slabs, residual, res_slabs: Slabs):
    if out_slabs != res_slabs:
        raise RuntimeError(f"a residual on layout {res_slabs} added to one on {out_slabs}")
    return F.relu(out + residual)


class SpatialBasicBlock(BasicBlock):
    """`BasicBlock` on (slab, slabs) pairs."""

    def forward(self, xs):
        x, src = xs
        out, lay = self.conv1(x, src)
        out = F.relu(self.bn1(out))
        out, lay = self.conv2(out, lay)
        out = self.bn2(out)
        residual, rlay = (x, src) if self.downsample is None else _shortcut(self.downsample,
                                                                            x, src)
        return _add(out, lay, residual, rlay), lay


class SpatialBottleneck(Bottleneck):
    """`Bottleneck` on (slab, slabs) pairs."""

    def forward(self, xs):
        x, src = xs
        out, lay = self.conv1(x, src)
        out = F.relu(self.bn1(out))
        out, lay = self.conv2(out, lay)
        out = F.relu(self.bn2(out))
        out, lay = self.conv3(out, lay)
        out = self.bn3(out)
        residual, rlay = (x, src) if self.downsample is None else _shortcut(self.downsample,
                                                                            x, src)
        return _add(out, lay, residual, rlay), lay


def _remat_spatial_block(block: nn.Module, x: torch.Tensor, src: Slabs):
    """`block((x, src))` rematerialized (`models/resnet3d.py::_remat_block`):
    the recomputation in the backward replays the block's halo exchanges
    and global BatchNorm sums. Checkpoint's early stop is off, so it replays
    every one of them: a rank whose slab is empty saves other tensors than
    its neighbours, and a recomputation cut short where the last of them is
    rebuilt would skip collectives the others run."""
    with set_checkpoint_early_stop(False):
        return _remat_block(block, (x, src))


class SpatialResNet3D(ResNet3D):
    """`ResNet3D` over a volume sharded along X on the space axis
    (`convert_spatial`). ``forward(x)`` takes this rank's slab (B, x_r, Y,
    Z, C) of its data row's volumes (`spatial_sharding(mesh).slab`) and
    returns the head's output: the logits (B, classes) f32 or the pooled
    (B, F) f32, the same on every space rank; for 'none' and 'seg', this
    rank's slab of the map, channels-last, and its [start, stop) along X.
    With `return_taps`, the four stage outputs' slabs too."""

    space: SpaceAxis = None

    def _pool(self, h: torch.Tensor, lay: Slabs) -> torch.Tensor:
        """Global average over the whole volume: local sum, a sum over the
        space ranks, a division by the voxel count (f32)."""
        total = pmesh.group_sum(h.float().sum(dim=(2, 3, 4)), self.space.group)
        return total / float(lay.extent * h.shape[3] * h.shape[4])

    def forward(self, x, return_taps: bool = False):
        if x.shape[-1] != self.in_channels:
            raise ValueError(
                f"input has {x.shape[-1]} channels, model declares "
                f"in_channels={self.in_channels}")
        ax = self.space
        src = Slabs.split(pmesh.whole_extent(x.shape[1], ax.group, x.device), ax.parts)
        if x.shape[1] != src.size(ax.index):
            raise ValueError(f"slab of {x.shape[1]} planes where rank {ax.index} of the space "
                             f"axis owns {src.ranges[ax.index]} of {src.extent}")
        x = x.permute(0, 4, 1, 2, 3)
        bf16 = self.compute_dtype == torch.bfloat16
        if not bf16:
            x = x.to(torch.float32)
        taps = []
        with torch.autocast(device_type=x.device.type, dtype=torch.bfloat16, enabled=bf16):
            h, lay = self.conv1(x, src)
            h = F.relu(self.bn1(h))
            h, lay = self.maxpool(h, lay)
            remat = self.remat and self.training and torch.is_grad_enabled()
            for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
                if remat:
                    for block in stage:
                        h, lay = _remat_spatial_block(block, h, lay)
                else:
                    h, lay = stage((h, lay))
                taps.append(h)
            bounds = lay.ranges[ax.index]
            if self.head == "none":
                out = (h.permute(0, 2, 3, 4, 1), bounds)
            elif self.head == "pool":
                out = self._pool(h, lay)
            elif self.head == "seg":
                seg = self.conv_seg
                y, slay = seg[0](h, lay)
                y = seg[2](seg[1](y))
                y, slay = seg[3](y, slay)
                y = seg[5](seg[4](y))
                y, slay = seg[6](y, slay)
                out = (y.permute(0, 2, 3, 4, 1), slay.ranges[ax.index])
            else:
                pooled = self._pool(h, lay).to(h.dtype)
                out = self.conv_seg[3](self.conv_seg[2](pooled)).float()
        if return_taps:
            return out, [t.permute(0, 2, 3, 4, 1) for t in taps]
        return out


_SWAPS = {nn.Conv3d: SpatialConv3d, StemConv: SpatialStemConv, nn.MaxPool3d: SpatialMaxPool3d,
          nn.ConvTranspose3d: SpatialConvTranspose3d, ShortcutA: SpatialShortcutA,
          BasicBlock: SpatialBasicBlock, Bottleneck: SpatialBottleneck,
          ResNet3D: SpatialResNet3D}


def convert_spatial(model: nn.Module, mesh) -> nn.Module:
    """Shard `model` over the mesh's 'space' axis in place (see the module
    docstring); the BatchNorms take their statistics over the whole mesh.
    A `ResNet3D` becomes a `SpatialResNet3D`, whose forward takes a slab.
    Of another module, the layers above are converted (Conv3d, MaxPool3d,
    ConvTranspose3d, the ResNet's blocks): they then take and return
    (slab, `Slabs`) pairs, and the caller passes the layouts along.
    Returns `model`."""
    axis = SpaceAxis.of(mesh)
    pmesh.convert_sync_batchnorm(model, mesh)
    for m in model.modules():
        cls = _SWAPS.get(type(m))
        if cls is not None:
            m.__class__ = cls
        if isinstance(m, (_SpatialWindow, SpatialConvTranspose3d, SpatialResNet3D)):
            m.space = axis
    return model
