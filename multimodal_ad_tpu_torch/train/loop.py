"""Train and eval steps, optimizer and learning-rate schedule (port of the
TPU package's train/loop.py).

Optimization as the TPU package runs it:

- class-weighted cross entropy, sum(w * nll) / sum(w) over the real rows
  of a padded batch (`weighted_ce`); unweighted masked CE at evaluation;
- clip the gradients to a global norm of 1.0, add wd * param to them, then
  Adam (`kind="adam"`: torch Adam's weight_decay); `kind="adamw"` decays
  the weights decoupled from the moments (torch AdamW);
- warmup 0.1 -> 1.0 over clamp(int(0.1 * epochs), 1, 10) counts, then a
  cosine to lr * 1e-4 (`make_epoch_schedule`); the single-split trainers
  use a plain cosine to 0 over max(1, epochs) counts
  (`cosine_decay_schedule`). The TPU package hands these schedules to
  optax, which evaluates them at the optimizer's *update count*, not at
  the epoch their docstrings name; the port does the same, so both apply
  one rate at every update (with the plain cosine the rate is 0 from
  update `epochs` on). What the logs record is ``schedule(epoch)``, as
  there.

A step runs the model's forward under its own autocast (bf16 over fp32
parameters by default) and keeps the loss and the probabilities on the
device: nothing in a step waits for the card.

Under a mesh (parallel/mesh.py; `create_train_state(mesh=)`) each rank
holds its data row's rows of the global batch: all of each volume, or with
``spatial=True`` on a mesh with a 'space' axis its slab of them, the
ResNet then sharded over that axis (parallel/spatial.py). The model's
BatchNorms take their statistics over every rank of the mesh
(`convert_sync_batchnorm`), the forward and backward run on a
DistributedDataParallel wrapper over the whole mesh, on a process group
of its own (`grad_group`; ``broadcast_buffers=False``: the global
statistics keep the ranks' running buffers equal), which averages the
gradients over all D x S ranks inside the backward;
clipping and the update follow on the averaged gradients, the same on
every rank. The losses divide by the global weight (or mask) sum: each
rank's share is its data row's Σ w·nll / global Σ w, scaled by D, the
data axes' size, for DDP's average. Each rank thus takes 1 / S of its
row's loss, S the space axis' size, and the S ranks of a row together
take the row's whole gradient, whether they hold its volumes whole or in
slabs (the sums over ranks in BatchNorm and the pool have sum-over-ranks
backwards). A ragged batch whose real rows sit on some rows only weighs
each row as one process would. The loss a step returns is the global
one. Each data row draws its own dropout masks (the seed offset by the
data coordinate), so the S ranks of a row draw the same ones.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.resnet3d import set_dropout_generator
from ..parallel import mesh as pmesh
from ..parallel.spatial import convert_spatial

#: per-data-row offset of the dropout seed under a mesh (row 0 keeps the seed)
DROPOUT_RANK_STRIDE = 1_000_003


def make_epoch_schedule(base_lr: float, num_epochs: int, warmup_frac: float = 0.1,
                        min_lr_factor: float = 1e-4, start_factor: float = 0.1):
    """Warmup -> cosine, as optax's join_schedules([linear_schedule,
    cosine_decay_schedule], [warmup]) computes it: the same float32
    operations in the same order. Returns ``schedule(count) -> float``."""
    warmup = max(1, min(10, int(num_epochs * warmup_frac)))
    cosine = max(1, num_epochs - warmup)
    f32 = np.float32
    init, end = f32(base_lr * start_factor), f32(base_lr)
    alpha = f32(base_lr * min_lr_factor / base_lr)

    def schedule(count) -> float:
        count = int(count)
        if count < warmup:
            c = f32(min(max(count, 0), warmup))
            frac = f32(1) - c / f32(warmup)
            return float((init - end) * frac + end)
        return float(end * ((f32(1) - alpha) * _cosine(count - warmup, cosine) + alpha))

    return schedule


def _cosine(count: int, steps: int) -> np.float32:
    """optax's cosine factor 0.5 * (1 + cos(pi * min(count, steps) / steps))
    in float32."""
    f32 = np.float32
    c = f32(min(count, steps))
    return f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(steps)))


def cosine_decay_schedule(base_lr: float, decay_steps: int):
    """optax.cosine_decay_schedule(base_lr, decay_steps) (alpha 0) in
    float32: the rate is 0 from count `decay_steps` on. Returns
    ``schedule(count) -> float``."""
    if decay_steps <= 0:
        raise ValueError(f"decay_steps must be positive, got {decay_steps}")
    init = np.float32(base_lr)
    return lambda count: float(init * _cosine(int(count), decay_steps))


def make_optimizer(params, schedule, weight_decay: float = 1e-4,
                   kind: str = "adam") -> torch.optim.Optimizer:
    """Adam with wd folded into the gradient (`kind="adam"`), or decoupled
    weight decay (`kind="adamw"`), both at eps 1e-8 and betas (0.9, 0.999)
    as optax's defaults. The rate is set before each update from
    `schedule(update count)` (`apply_gradients`); gradient clipping is
    `clip_by_global_norm_`. On a card the update is torch's fused kernel
    (one launch for all parameters), elsewhere its reference loop."""
    params = list(params)
    lr0 = schedule(0)
    fused = bool(params) and all(p.device.type == "cuda" for p in params)
    if kind == "adam":
        return torch.optim.Adam(params, lr=lr0, weight_decay=weight_decay, fused=fused)
    if kind == "adamw":
        return torch.optim.AdamW(params, lr=lr0, weight_decay=weight_decay, fused=fused)
    raise ValueError(kind)


def clip_by_global_norm_(grads: list, max_norm: float) -> torch.Tensor:
    """optax's clip_by_global_norm in place: gradients whose global norm is
    at least `max_norm` are scaled by max_norm / norm (torch's
    clip_grad_norm_ adds 1e-6 to the norm, optax does not). Decided on the
    device, so nothing waits for the card. Returns the norm."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class TrainState:
    """One fold's model, optimizer and counters.

    `step` counts optimizer updates (it indexes the schedule, as optax's
    count does, and names the update a checkpoint resumes after); `epoch`
    counts finished epochs (the CV log's rate is ``schedule(epoch)``).
    `dropout_generator` is the model's dropout stream. Under a mesh,
    `mesh` is set and `ddp` is the DistributedDataParallel wrapper of
    `model` that train steps run (`model` itself is what checkpoints and
    eval steps use)."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 schedule, grad_clip_norm: float = 1.0,
                 dropout_generator: torch.Generator | None = None,
                 epoch: int = 0, step: int = 0, mesh=None, ddp: nn.Module | None = None):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.grad_clip_norm = grad_clip_norm
        self.dropout_generator = dropout_generator
        self.epoch = epoch
        self.step = step
        self.mesh = mesh
        self.ddp = ddp

    @property
    def train_module(self) -> nn.Module:
        """The module a train step runs: the DDP wrapper under a mesh."""
        return self.ddp if self.ddp is not None else self.model

    def lr(self) -> float:
        """The rate the CV log records: ``schedule(epoch)``."""
        return self.schedule(self.epoch)


def create_train_state(model: nn.Module, schedule, weight_decay: float = 1e-4,
                       grad_clip_norm: float = 1.0, optimizer: str = "adam",
                       dropout_seed: int | None = None, mesh=None,
                       spatial: bool = False) -> TrainState:
    """TrainState over `model` (already on its device). With `dropout_seed`
    the model's dropout draws from a generator on that device seeded with
    it (train_cv seeds it with seed * 1000 + fold; under a mesh, plus
    `DROPOUT_RANK_STRIDE` times the data coordinate). With `mesh` the
    BatchNorms turn global and the model is wrapped for DDP over the whole
    mesh, whose construction broadcasts the mesh's first rank's parameters
    and buffers to the others; with `spatial` too, the ResNet is sharded
    over the mesh's 'space' axis (`convert_spatial`) and takes slabs, its
    stem and `remat` as in one process."""
    device = next(model.parameters()).device
    ddp = None
    rank = 0
    if spatial and mesh is None:
        raise ValueError("spatial=True needs a mesh with a 'space' axis")
    if mesh is not None:
        rank = pmesh.data_rank(mesh)
        if spatial:
            convert_spatial(model, mesh)
        else:
            pmesh.convert_sync_batchnorm(model, mesh)
        ddp = nn.parallel.DistributedDataParallel(
            model, device_ids=[device] if device.type == "cuda" else None,
            process_group=pmesh.grad_group(mesh), broadcast_buffers=False)
    gen = None
    if dropout_seed is not None:
        seed = int(dropout_seed) + DROPOUT_RANK_STRIDE * rank
        gen = torch.Generator(device=device).manual_seed(seed)
        set_dropout_generator(model, gen)
    opt = make_optimizer(model.parameters(), schedule, weight_decay, optimizer)
    return TrainState(model, opt, schedule, grad_clip_norm, gen, mesh=mesh, ddp=ddp)


def mean_share(num, den, mesh):
    """(this rank's share of num / den, the global value or None): without
    a mesh num / max(den, 1e-8) and None; under one num / global den and
    global num / global den, both sums over the data rows (`data_group`) in
    one all_reduce (outside autograd)."""
    if mesh is None:
        return num / den.clamp(min=1e-8), None
    tot = pmesh.all_reduce_sum(torch.stack([num.detach(), den.detach()]), mesh)
    den_g = tot[1].clamp(min=1e-8)
    return num / den_g, tot[0] / den_g


def global_mean(num, den, mesh):
    """num / den over the global batch (sums over this rank's rows)."""
    loss, total = mean_share(num, den, mesh)
    return loss if total is None else total


def _nll(logits, labels):
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels.long()[:, None])[:, 0]


def _weighted_sums(logits, labels, class_weights, mask):
    w = class_weights[labels.long()] * mask
    return (w * _nll(logits, labels)).sum(), w.sum()


def weighted_ce(logits, labels, class_weights, mask, mesh=None):
    """Class-weighted cross entropy over the real rows, reduced as torch's
    CrossEntropyLoss(weight=w) does: sum(w_i * nll_i) / sum(w_i), with the
    denominator at least 1e-8. Under a mesh, this rank's share: its rows'
    sum over the global sum of w (the shares add up to the global loss)."""
    return mean_share(*_weighted_sums(logits, labels, class_weights, mask), mesh)[0]


def masked_ce(logits, labels, mask, mesh=None):
    """Unweighted cross entropy averaged over the real rows (evaluation);
    under a mesh, the global value."""
    return global_mean((_nll(logits, labels) * mask).sum(), mask.sum(), mesh)


def backward_mean(state: TrainState, num, den):
    """Backward of the loss num / den (sums over this rank's rows); returns
    the global loss, detached. Under a mesh the rank's share of the loss is
    scaled by the data axes' size D; DDP's gradient average over the D x S
    ranks of the mesh divides it out (see the module docstring)."""
    loss, total = mean_share(num, den, state.mesh)
    if total is None:
        loss.backward()
        return loss.detach()
    (loss * pmesh.data_size(state.mesh)).backward()
    return total


def backward_weighted_ce(state: TrainState, logits, batch: dict, class_weights):
    """`backward_mean` of the batch's class-weighted cross entropy."""
    return backward_mean(state, *_weighted_sums(logits, batch["label"], class_weights,
                                                batch["mask"]))


def forward_backward(state: TrainState, batch: dict, class_weights):
    """Train-mode forward, weighted CE and its gradients. Returns the loss
    (the global one under a mesh) and this rank's float32 logits,
    detached."""
    state.model.train()
    state.optimizer.zero_grad(set_to_none=True)
    logits = state.train_module(batch["image"]).float()
    return backward_weighted_ce(state, logits, batch, class_weights), logits.detach()


def apply_gradients(state: TrainState):
    """Clip, set the rate ``schedule(step)``, take one optimizer update."""
    grads = [p.grad for g in state.optimizer.param_groups for p in g["params"]
             if p.grad is not None]
    if state.grad_clip_norm:
        clip_by_global_norm_(grads, state.grad_clip_norm)
    lr = state.schedule(state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.step += 1


def train_step(state: TrainState, batch: dict, class_weights):
    """One update. Returns (loss, train-mode softmax probabilities of this
    rank's rows), both on the device."""
    loss, logits = forward_backward(state, batch, class_weights)
    apply_gradients(state)
    return loss, torch.softmax(logits, dim=-1)


@torch.no_grad()
def eval_step(state: TrainState, batch: dict):
    """Eval-mode forward. Returns (unweighted masked CE, global under a
    mesh; this rank's probabilities)."""
    state.model.eval()
    logits = state.model(batch["image"]).float()
    return (masked_ce(logits, batch["label"], batch["mask"], state.mesh),
            torch.softmax(logits, dim=-1))


def next_epoch(state: TrainState) -> TrainState:
    state.epoch += 1
    return state


def _batchnorms(model: nn.Module) -> list:
    return [m for m in model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]


@torch.no_grad()
def recompute_batch_stats(state: TrainState, batches, max_batches: int | None = None
                          ) -> TrainState:
    """Precise-BN: replace every BatchNorm's running statistics by the mean
    of its raw batch statistics over `batches`, under the current
    parameters (the TPU package inverts flax's EMA for the raw statistics;
    here each BatchNorm runs with ``momentum=None``, torch's cumulative
    average, from reset statistics). Only the BatchNorms run in train mode,
    so dropout draws nothing. With no batches the state is left as it was.
    Under a mesh the batches are each rank's rows and the statistics are the
    global batches' (the BatchNorms are global)."""
    model = state.model
    bns = _batchnorms(model)
    saved = [(bn.momentum, bn.running_mean.clone(), bn.running_var.clone(),
              bn.num_batches_tracked.clone()) for bn in bns]
    was_training = model.training
    model.eval()
    for bn in bns:
        bn.reset_running_stats()
        bn.momentum = None
        bn.train()
    n = 0
    for batch in batches:
        model(batch["image"])
        n += 1
        if max_batches is not None and n >= max_batches:
            break
    for bn, (momentum, mean, var, tracked) in zip(bns, saved):
        bn.momentum = momentum
        bn.num_batches_tracked.copy_(tracked)
        if n == 0:
            bn.running_mean.copy_(mean)
            bn.running_var.copy_(var)
    model.train(was_training)
    return state
