"""Device mesh and data parallelism (port of the TPU package's
parallel/mesh.py).

The reference's only parallelism is single-node ``nn.DataParallel``
(reference models/Resnet3D.py:89-99). The TPU package runs it as GSPMD: a
mesh over the chips with the batch sharded along its ``data`` axis, so
sharded training matches single-device statistics at matched global batch.
Here each device is a process (one rank a card, launched by
``python -m torch.distributed.run``) and the mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the ranks of the default
process group, with the TPU package's axis names:

- each rank takes its contiguous rows of every global batch
  (`shard_batch`, `local_rows`) and runs the kernels and the model on them;
- parameters start equal on every rank (`replicate`, a broadcast from the
  mesh's first rank) and the gradients are averaged over the ranks
  (DistributedDataParallel, train/loop.py);
- BatchNorm takes its training statistics over the global batch
  (`convert_sync_batchnorm`): per-channel sums all-reduced over the mesh,
  with an autograd backward, so a step at world size W and global batch B
  gives the numbers of one process at batch B up to the order of the sums;
- the losses divide by the global weight sum, and results that every rank
  needs whole are assembled by `gather_rows`.

The layer runs only two collectives, ``all_reduce`` and ``broadcast``: gloo
runs those two on CUDA tensors, and gloo is how two ranks share one card
(NCCL refuses two ranks on one GPU). `init_distributed` takes NCCL for a
card and gloo for the host; gloo on a card only when the caller names it.

A mesh may also have a ``space`` axis (`SPACE_AXIS`), as the TPU package's
2-D ``{"data": a, "space": b}`` mesh has. A rank then has two coordinates:
`data_rank`, its position along the data axes, and `space_rank`, along
``space``. The batch splits over the data axes and is replicated over
``space`` (the TPU package's `data_sharding`), unless a model is spatially
sharded (parallel/spatial.py), whose ranks of one data row each hold a
slab of the row's volumes (`spatial_sharding`). The groups: `data_group`
(the ranks that share this rank's space coordinate: batch sums and
`gather_rows`), `space_group` (the ranks of this rank's data row: halo
exchanges and the pooled sums), `mesh_group` (every rank: the global
BatchNorm, `replicate`, `barrier`) and `grad_group` (every rank again, a
communicator of its own: DDP's gradient sum, which then never interleaves
with the BatchNorm sums a rematerialized block replays in the backward).
Rank 0 of both axes writes the files (`is_main`).
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..models.resnet3d import recomputing

#: mesh axes the batch shards over; a multislice mesh has both
DATA_AXES = ("replica", "data")
#: the mesh axis a volume's first spatial axis shards over
SPACE_AXIS = "space"
AXES = DATA_AXES + (SPACE_AXIS,)

# process groups over several of a mesh's ranks that its DeviceMesh does not
# hold (a flattened multi-axis mesh, the data axes under a space axis), by
# their ranks in order
_FLAT_GROUPS: dict = {}
# each mesh's gradient group (`grad_group`), by its ranks in order: a second
# group over ranks that `_FLAT_GROUPS` or the DeviceMesh may already cover
_GRAD_GROUPS: dict = {}


def init_distributed(backend: str | None = None, device: str | torch.device = "cuda",
                     init_method: str | None = None, rank: int | None = None,
                     world_size: int | None = None) -> torch.device:
    """Join the default process group and return this rank's device.

    `backend` defaults to NCCL for a CUDA device and gloo for the CPU; gloo
    on a card only when named (two ranks sharing one card), NCCL on the CPU
    raises. A CUDA device without an index becomes ``cuda:LOCAL_RANK`` (the
    launcher's variable, 0 when absent), which must exist. `init_method`
    defaults to ``env://`` (what ``torch.distributed.run`` sets), `rank` and
    `world_size` to the environment's. Where the group is already
    initialized, its backend must be the one asked for."""
    from ..core.device import resolve_device

    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}; use 'nccl' or 'gloo'")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the NCCL backend needs a CUDA device, not {str(dev)!r}")
    if dev.type == "cuda":
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", "0"))
            if torch.cuda.is_available() and local >= torch.cuda.device_count():
                raise RuntimeError(
                    f"local rank {local} needs card {local}, but only "
                    f"{torch.cuda.device_count()} are visible; start fewer processes "
                    "or name the device and the gloo backend to share a card")
            dev = torch.device("cuda", local)
        dev = resolve_device(dev)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        have = dist.get_backend()
        if have != backend:
            raise RuntimeError(f"the process group runs {have}, not {backend}")
        return dev
    kw = {}
    if rank is not None:
        kw["rank"] = rank
    if world_size is not None:
        kw["world_size"] = world_size
    dist.init_process_group(backend, init_method=init_method or "env://", **kw)
    return dev


def _world() -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialized process group: launch with "
            "`python -m torch.distributed.run` and call init_distributed() first; "
            "a single process runs without a mesh (mesh=None)")
    return dist.get_world_size()


def _device_type(device_type: str | None) -> str:
    if device_type is not None:
        return device_type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _check_axes(names: tuple) -> None:
    other = [a for a in names if a not in AXES]
    if other:
        raise ValueError(f"unknown mesh axes {other}: a mesh's axes are among {AXES}")
    if len(set(names)) != len(names):
        raise ValueError(f"mesh axes {names} name an axis twice")


def _flat_group(ranks: tuple) -> None:
    """Create the group over `ranks` unless it is the world's; every rank of
    the world calls this, in one order."""
    if ranks != tuple(range(dist.get_world_size())) and ranks not in _FLAT_GROUPS:
        _FLAT_GROUPS[ranks] = dist.new_group(list(ranks))


def _build(ranks: np.ndarray, names: tuple, device_type: str | None):
    from torch.distributed.device_mesh import DeviceMesh

    _check_axes(names)
    mesh = DeviceMesh(_device_type(device_type), torch.from_numpy(ranks),
                      mesh_dim_names=names)
    flat = tuple(int(r) for r in ranks.ravel())
    if flat not in _GRAD_GROUPS:
        _GRAD_GROUPS[flat] = dist.new_group(list(flat))
    if ranks.ndim > 1:
        _flat_group(flat)
        data_dims = [i for i, a in enumerate(names) if a in DATA_AXES]
        if SPACE_AXIS in names and len(data_dims) > 1:  # the data axes of each space column
            sp = names.index(SPACE_AXIS)
            for j in range(ranks.shape[sp]):
                _flat_group(tuple(int(r) for r in np.take(ranks, j, axis=sp).ravel()))
    return mesh


def make_mesh(shape: dict | None = None, device_type: str | None = None):
    """Build a mesh from an axis-name -> size dict over the ranks of the
    default process group, row-major in the dict's order (so
    ``{"data": a, "space": b}`` puts the b ranks of one data row next to
    each other). Size -1 absorbs all remaining ranks (like a reshape
    wildcard). The axes are among `AXES`; another name raises ValueError.

    A shape smaller than the world takes the FIRST prod(sizes) ranks and
    warns; the others stay idle (the entry points return at once on them)
    — the mesh analogue of the reference's ``gpu_id`` list selecting a
    subset of GPUs (reference models/Resnet3D.py:89-99). `device_type`
    defaults to "cuda" under NCCL and "cpu" under gloo."""
    n = _world()
    shape = dict(shape or {"data": -1})
    sizes = list(shape.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one mesh axis may be -1")
    fixed = int(np.prod([s for s in sizes if s != -1])) if sizes else 1
    if -1 in sizes:
        if n % fixed:
            raise ValueError(f"{n} devices not divisible by fixed axes {fixed}")
        sizes[sizes.index(-1)] = n // fixed
    want = int(np.prod(sizes))
    if want > n:
        raise ValueError(f"mesh {dict(zip(shape, sizes))} needs {want} "
                         f"devices, only {n} available")
    if want < n:
        warnings.warn(
            f"mesh {dict(zip(shape, sizes))} uses {want} of {n} available "
            f"devices; the remaining {n - want} stay idle", stacklevel=2)
    return _build(np.arange(want).reshape(sizes), tuple(shape), device_type)


def make_multislice_mesh(n_slices: int, device_type: str | None = None):
    """('replica', 'data') mesh for multi-slice data parallelism: the batch
    shards over both axes, the slice axis outermost so that each row is a
    contiguous block of ranks (one host's cards under a launcher that
    numbers ranks host by host). The gradient average spans the whole mesh
    (one flattened group)."""
    n = _world()
    if n % n_slices:
        raise ValueError(f"{n} devices not divisible into {n_slices} slices")
    return _build(np.arange(n).reshape(n_slices, -1), ("replica", "data"),
                  device_type)


def default_mesh(mesh=None, shape: dict | None = None):
    """`mesh` if given; else `make_mesh(shape)` when a process group is
    initialized (as under ``python -m torch.distributed.run`` after
    `init_distributed`), else None: one process, no mesh."""
    if mesh is not None:
        return mesh
    if dist.is_available() and dist.is_initialized():
        return make_mesh(shape)
    return None


def resolve_mesh(mesh, shape: dict | None, batch_size: int):
    """(mesh, main) for an entry point: `default_mesh(mesh, shape)`, whose
    data axis must divide `batch_size` (ValueError), and whether this rank
    writes the files; main is None on a rank outside the mesh, which then
    has nothing to do."""
    mesh = default_mesh(mesh, shape)
    if data_rank(mesh) is None:
        return mesh, None
    local_rows(batch_size, mesh)
    return mesh, is_main(mesh)


def _names(mesh) -> tuple:
    names = tuple(mesh.mesh_dim_names or ())
    _check_axes(names)
    return names


def _ranks(mesh) -> list:
    return [int(r) for r in mesh.mesh.flatten().tolist()]


def _group_of(ranks: tuple):
    if ranks == tuple(range(dist.get_world_size())):
        return dist.group.WORLD
    return _FLAT_GROUPS[ranks]


def _data_dims(mesh) -> list:
    return [i for i, a in enumerate(_names(mesh)) if a in DATA_AXES]


def mesh_size(mesh) -> int:
    """Ranks of the mesh, over every axis (1 without a mesh)."""
    return 1 if mesh is None else int(mesh.mesh.numel())


def mesh_group(mesh):
    """The process group over every rank of `mesh`: the global BatchNorm,
    `replicate` and `barrier` run over it (the gradient sum over
    `grad_group`)."""
    _names(mesh)
    if mesh.ndim == 1:
        return mesh.get_group(0)
    return _group_of(tuple(_ranks(mesh)))


def grad_group(mesh):
    """The process group DDP sums the gradients over: every rank of `mesh`,
    a communicator apart from `mesh_group`. A rank's gradient buckets fire
    as its backward reaches them, and on a 'space' axis the ranks' backward
    graphs differ (empty slabs), so a bucket may come before a replayed
    BatchNorm sum on one rank and after it on another; on two communicators
    each keeps its own order."""
    ranks = tuple(_ranks(mesh))
    if ranks not in _GRAD_GROUPS:
        raise ValueError(f"the mesh over ranks {ranks} was not built by make_mesh or "
                         "make_multislice_mesh, which make its gradient group")
    return _GRAD_GROUPS[ranks]


def data_group(mesh):
    """The process group over the ranks that share this rank's space
    coordinate: one rank of each data row (every rank of a mesh without a
    'space' axis). None on a mesh without data axes."""
    dims = _data_dims(mesh)
    if not dims:
        return None
    if len(dims) == 1:
        return mesh.get_group(dims[0])
    names = _names(mesh)
    ranks = mesh.mesh
    if SPACE_AXIS in names:
        ranks = ranks.select(names.index(SPACE_AXIS), space_rank(mesh))
    return _group_of(tuple(int(r) for r in ranks.flatten().tolist()))


def space_group(mesh):
    """The process group over this rank's data row: the ranks that share its
    data coordinate, along 'space'. None on a mesh without a 'space' axis."""
    if mesh is None or SPACE_AXIS not in _names(mesh):
        return None
    return mesh.get_group(SPACE_AXIS)


def data_size(mesh) -> int:
    """Ranks the batch shards over: the product of the data axes' sizes (1
    without a mesh)."""
    if mesh is None:
        return 1
    return int(np.prod([mesh.size(i) for i in _data_dims(mesh)]))


def space_size(mesh) -> int:
    """Ranks a volume's slabs spread over: the 'space' axis' size (1 without
    one)."""
    if mesh is None or SPACE_AXIS not in _names(mesh):
        return 1
    return int(mesh.size(_names(mesh).index(SPACE_AXIS)))


def data_rank(mesh) -> int | None:
    """This rank's coordinate along the data axes, row-major (0 without a
    mesh or on a mesh without data axes); None where the rank is not in the
    mesh."""
    if mesh is None:
        return 0
    dims = _data_dims(mesh)
    coord = mesh.get_coordinate()
    if coord is None:
        return None
    if not dims:
        return 0
    return int(np.ravel_multi_index([coord[i] for i in dims], [mesh.size(i) for i in dims]))


def space_rank(mesh) -> int | None:
    """This rank's coordinate along 'space' (0 without one); None where the
    rank is not in the mesh."""
    if mesh is None:
        return 0
    coord = mesh.get_coordinate()
    if coord is None:
        return None
    names = _names(mesh)
    return int(coord[names.index(SPACE_AXIS)]) if SPACE_AXIS in names else 0


def is_main(mesh) -> bool:
    """True on the rank that writes files: coordinate 0 along the data axes
    and along 'space' (or the only process, without a mesh)."""
    return data_rank(mesh) == 0 and space_rank(mesh) == 0


def local_rows(n: int, mesh) -> slice:
    """This rank's contiguous rows of a global batch of `n` rows. `n` must
    divide by the mesh's size."""
    w = data_size(mesh)
    if n % w:
        raise ValueError(f"batch_size={n} not divisible by the mesh data axis ({w})")
    r = data_rank(mesh)
    if r is None:
        raise RuntimeError("this rank is not in the mesh")
    per = n // w
    return slice(r * per, (r + 1) * per)


def shard_batch(batch, mesh, axis="data", spatial: int | None = None):
    """This rank's contiguous rows of every tensor or array in `batch` (a
    dict, list, tuple or one tensor), the batch dimension split over the
    mesh axis `axis` (a name or a tuple of names, whose product it then
    splits over) and replicated over the others; other entries pass
    through. The batch dimension must divide by the axes' size. With
    `spatial` (a dimension, 1 for the X of (B, X, Y, Z, C)), each 5-D
    entry's rows are then cut to this rank's slab along it
    (`spatial_sharding`)."""
    names = tuple(mesh.mesh_dim_names)
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    for a in axes:
        if a not in names:
            raise ValueError(f"mesh has no axis {a!r} (axes {names})")
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError("this rank is not in the mesh")
    sizes = [mesh.size(names.index(a)) for a in axes]
    w = int(np.prod(sizes))
    r = int(np.ravel_multi_index([coord[names.index(a)] for a in axes], sizes))
    slab = spatial_sharding(mesh, spatial_dim=spatial) if spatial is not None else None

    def take(x):
        if isinstance(x, (torch.Tensor, np.ndarray)):
            if x.shape[0] % w:
                raise ValueError(f"batch dimension {x.shape[0]} not divisible by the "
                                 f"mesh axes {axes} ({w})")
            per = x.shape[0] // w
            x = x[r * per:(r + 1) * per]
            return slab.slab(x) if slab is not None and x.ndim == 5 else x
        return x

    if isinstance(batch, dict):
        return {k: take(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(take(v) for v in batch)
    return take(batch)


def split_ranges(extent: int, parts: int) -> tuple:
    """((start, stop), ...) of `parts` slabs of `extent` planes in
    `torch.tensor_split` order: balanced, the larger slabs first, empty
    ones where `parts` exceeds `extent`."""
    per, extra = divmod(int(extent), int(parts))
    starts = [r * per + min(r, extra) for r in range(parts + 1)]
    return tuple((starts[r], starts[r + 1]) for r in range(parts))


def whole_extent(local: int, group, device) -> int:
    """The sum of every rank's `local` extent over `group` (an all_reduce on
    `device`, read back)."""
    n = torch.tensor([int(local)], dtype=torch.int64, device=device)
    dist.all_reduce(n, group=group)
    return int(n.item())


class SpatialSharding:
    """This rank's slab of a volume batch along one spatial dimension, split
    over a mesh axis (`spatial_sharding`): `ranges(extent)` the slabs of
    every rank of the axis, `bounds(extent)` this rank's, `slab(x)` its
    planes of a whole tensor, `gather(slab)` the whole tensor back from
    every rank's slab (an all_reduce of a zero buffer over the axis' group;
    for checks, not for a model's path)."""

    def __init__(self, mesh, axis: str, spatial_dim: int):
        names = _names(mesh)
        if axis not in names:
            raise ValueError(f"mesh has no axis {axis!r} (axes {names})")
        coord = mesh.get_coordinate()
        if coord is None:
            raise RuntimeError("this rank is not in the mesh")
        self.dim = int(spatial_dim)
        self.parts = int(mesh.size(names.index(axis)))
        self.index = int(coord[names.index(axis)])
        self.group = mesh.get_group(axis)

    def ranges(self, extent: int) -> tuple:
        return split_ranges(extent, self.parts)

    def bounds(self, extent: int) -> tuple:
        return self.ranges(extent)[self.index]

    def slab(self, x):
        """This rank's planes of `x` along `dim` (a contiguous copy of a
        tensor, so the whole one can be freed)."""
        lo, hi = self.bounds(x.shape[self.dim])
        idx = [slice(None)] * x.ndim
        idx[self.dim] = slice(lo, hi)
        part = x[tuple(idx)]
        return part.contiguous() if isinstance(part, torch.Tensor) else part

    def gather(self, slab: torch.Tensor, extent: int | None = None) -> torch.Tensor:
        """The whole tensor, on every rank of the axis, from each rank's
        `slab` (its planes along `dim`)."""
        if extent is None:
            extent = whole_extent(slab.shape[self.dim], self.group, slab.device)
        lo, hi = self.bounds(extent)
        if slab.shape[self.dim] != hi - lo:
            raise ValueError(f"a slab of {slab.shape[self.dim]} planes where this rank "
                             f"holds {hi - lo} of {extent}")
        shape = list(slab.shape)
        shape[self.dim] = extent
        out = slab.new_zeros(shape)
        out.narrow(self.dim, lo, hi - lo).copy_(slab)
        dist.all_reduce(out, group=self.group)
        return out


def spatial_sharding(mesh, axis: str = SPACE_AXIS, spatial_dim: int = 1) -> SpatialSharding:
    """Shard a (B, X, Y, Z, C) volume batch along spatial dimension
    `spatial_dim` over the mesh axis `axis`, instead of along the batch
    (the TPU package's `spatial_sharding`; there GSPMD inserts the halo
    exchanges, here parallel/spatial.py does). The split is
    `torch.tensor_split`'s (`split_ranges`): where the axis divides the
    extent, each rank's range is the one the TPU package's NamedSharding
    gives its device."""
    return SpatialSharding(mesh, axis, spatial_dim)


def replicate(obj, mesh):
    """Make `obj` equal on every rank of the mesh: a module's parameters and
    buffers, or a tensor, or a dict / list of tensors, broadcast in place
    from the mesh's first rank. Returns `obj`."""
    group = mesh_group(mesh)
    src = _ranks(mesh)[0]
    if isinstance(obj, nn.Module):
        tensors = [t.data for t in obj.parameters()] + list(obj.buffers())
    elif isinstance(obj, dict):
        tensors = list(obj.values())
    elif isinstance(obj, (list, tuple)):
        tensors = list(obj)
    else:
        tensors = [obj]
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=src, group=group)
    return obj


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of `group`; the backward sums the gradients over
    them (each rank's loss is its share of the global objective)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """`x` summed over the mesh's data axes (`data_group`: one rank of each
    data row), differentiable."""
    return group_sum(x, data_group(mesh))


def group_sum(x: torch.Tensor, group) -> torch.Tensor:
    """`x` summed over the ranks of `group`, differentiable (the backward
    sums the gradients over them); `x` itself where `group` is None."""
    return x if group is None else _AllReduceSum.apply(x, group)


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """The (W * n, ...) concatenation in mesh order of every data row's (n,
    ...) rows, W the data axes' size, on every rank: a zero buffer with this
    rank's rows in place, summed over `data_group` (all_reduce; adding zeros
    leaves each value as it was; the ranks of a data row hold the same
    rows). Without a mesh, or at W = 1, `x` itself."""
    w = data_size(mesh)
    if w == 1:
        return x
    n = x.shape[0]
    r = data_rank(mesh)
    out = torch.zeros((w * n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    out[r * n:(r + 1) * n] = x
    dist.all_reduce(out, group=data_group(mesh))
    return out


def barrier(mesh, device) -> None:
    """Wait until every rank of the mesh has arrived (an all_reduce of one
    element on `device`, read back)."""
    if mesh_size(mesh) == 1:
        return
    t = torch.zeros(1, device=device)
    dist.all_reduce(t, group=mesh_group(mesh))
    t.item()


class GlobalBatchNormMixin:
    """Training-mode BatchNorm over every rank of a mesh: per channel, the
    mean is the all-reduced sum over the all-reduced count of elements (one
    all_reduce: the count rides with the sums, exact in float32 up to 2^24
    elements a channel), the (biased) variance the all-reduced sum of
    squared deviations from it (two passes, as precise as the stock
    module's); the output and its gradients follow through
    `_AllReduceSum`. Counting, not assuming equal shares, is what keeps the
    statistics exact where the ranks hold different numbers of elements:
    the uneven and empty slabs of a spatially sharded volume, or a space
    axis whose ranks each hold the same rows (each sum and the count then
    both grow S times). The running statistics take the global mean and
    biased variance, as flax's BatchNorm does (`FlaxBatchNorm3d`), with
    the stock momentum rule (1/count with ``momentum=None``), and so stay
    equal on every rank; a rematerialized block's recomputation
    (`recomputing`) leaves them as they are. Eval mode is the stock
    module's. Set `mesh_group` (`convert_sync_batchnorm` does)."""

    mesh_group = None

    def forward(self, x):
        if not (self.training and self.track_running_stats) or self.mesh_group is None:
            return super().forward(x)
        c = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        view = (1, c) + (1,) * (x.dim() - 2)
        xf = x.float()
        local = torch.cat([xf.sum(dims), xf.new_full((1,), float(x.numel() // c))])
        tot = _AllReduceSum.apply(local, self.mesh_group)
        n = tot[c].detach()
        mean = tot[:c] / n
        d = xf - mean.view(view)
        var = _AllReduceSum.apply((d * d).sum(dims), self.mesh_group) / n
        y = d * torch.rsqrt(var + self.eps).view(view)
        if self.affine:
            y = y * self.weight.view(view) + self.bias.view(view)
        if recomputing():  # a rematerialized block's second forward
            return y.to(x.dtype)
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            f = (1.0 / float(self.num_batches_tracked) if self.momentum is None
                 else self.momentum)
            self.running_mean.mul_(1.0 - f).add_(mean.detach(), alpha=f)
            self.running_var.mul_(1.0 - f).add_(var.detach(), alpha=f)
        return y.to(x.dtype)


_GLOBAL_CLASSES: dict = {}


def _global_class(cls):
    if cls not in _GLOBAL_CLASSES:
        _GLOBAL_CLASSES[cls] = type(f"Global{cls.__name__}", (GlobalBatchNormMixin, cls), {})
    return _GLOBAL_CLASSES[cls]


def convert_sync_batchnorm(model: nn.Module, mesh) -> nn.Module:
    """Make every BatchNorm of `model` take its training statistics over
    every rank of the mesh (`GlobalBatchNormMixin`, over `mesh_group`), in
    place: each module's class becomes a subclass of its own, so its
    parameters, buffers and state_dict keys stay as they were (checkpoints
    load either way). At one rank the model is left as it is. Returns
    `model`."""
    if mesh_size(mesh) == 1:
        return model
    group = mesh_group(mesh)
    for m in model.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            if not isinstance(m, GlobalBatchNormMixin):
                m.__class__ = _global_class(type(m))
            m.mesh_group = group
    return model


def pad_to_multiple(batch_np: dict, multiple: int):
    """Pad every array in a host batch dict along dim 0 to a multiple of
    `multiple`, returning (padded_batch, mask): the pad rows repeat the
    last real row and the mask marks the real ones, so shapes stay static
    (the TPU package's own rule for ragged final batches)."""
    n = next(iter(batch_np.values())).shape[0]
    rem = (-n) % multiple
    mask = np.ones((n + rem,), dtype=np.float32)
    if rem:
        mask[n:] = 0.0
        batch_np = {
            k: np.concatenate([v, np.repeat(v[-1:], rem, axis=0)], axis=0)
            for k, v in batch_np.items()
        }
    return batch_np, mask
