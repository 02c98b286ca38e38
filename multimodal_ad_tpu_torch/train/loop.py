"""Train and eval steps, optimizer and learning-rate schedule (port of the
TPU package's train/loop.py).

Optimization as the TPU package runs it:

- class-weighted cross entropy, sum(w * nll) / sum(w) over the real rows
  of a padded batch (`weighted_ce`); unweighted masked CE at evaluation;
- clip the gradients to a global norm of 1.0, add wd * param to them, then
  Adam (`kind="adam"`: torch Adam's weight_decay); `kind="adamw"` decays
  the weights decoupled from the moments (torch AdamW);
- warmup 0.1 -> 1.0 over clamp(int(0.1 * epochs), 1, 10) counts, then a
  cosine to lr * 1e-4 (`make_epoch_schedule`). The TPU package hands this
  schedule to optax, which evaluates it at the optimizer's *update count*,
  not at the epoch its docstring names; the port does the same, so both
  apply one rate at every update. What the CV log records is
  ``schedule(epoch)``, as there.

A step runs the model's forward under its own autocast (bf16 over fp32
parameters by default) and keeps the loss and the probabilities on the
device: nothing in a step waits for the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.resnet3d import set_dropout_generator


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
        c = f32(min(count - warmup, cosine))
        decay = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(cosine)))
        return float(end * ((f32(1) - alpha) * decay + alpha))

    return schedule


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
    `dropout_generator` is the model's dropout stream."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 schedule, grad_clip_norm: float = 1.0,
                 dropout_generator: torch.Generator | None = None,
                 epoch: int = 0, step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.grad_clip_norm = grad_clip_norm
        self.dropout_generator = dropout_generator
        self.epoch = epoch
        self.step = step

    def lr(self) -> float:
        """The rate the CV log records: ``schedule(epoch)``."""
        return self.schedule(self.epoch)


def create_train_state(model: nn.Module, schedule, weight_decay: float = 1e-4,
                       grad_clip_norm: float = 1.0, optimizer: str = "adam",
                       dropout_seed: int | None = None) -> TrainState:
    """TrainState over `model` (already on its device). With `dropout_seed`
    the model's dropout draws from a generator on that device seeded with
    it (train_cv seeds it with seed * 1000 + fold)."""
    gen = None
    if dropout_seed is not None:
        device = next(model.parameters()).device
        gen = torch.Generator(device=device).manual_seed(int(dropout_seed))
        set_dropout_generator(model, gen)
    opt = make_optimizer(model.parameters(), schedule, weight_decay, optimizer)
    return TrainState(model, opt, schedule, grad_clip_norm, gen)


def weighted_ce(logits, labels, class_weights, mask):
    """Class-weighted cross entropy over the real rows, reduced as torch's
    CrossEntropyLoss(weight=w) does: sum(w_i * nll_i) / sum(w_i), with the
    denominator at least 1e-8."""
    logp = F.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    nll = -logp.gather(1, labels[:, None])[:, 0]
    w = class_weights[labels] * mask
    return (w * nll).sum() / w.sum().clamp(min=1e-8)


def masked_ce(logits, labels, mask):
    """Unweighted cross entropy averaged over the real rows (evaluation)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    return (nll * mask).sum() / mask.sum().clamp(min=1e-8)


def forward_backward(state: TrainState, batch: dict, class_weights):
    """Train-mode forward, weighted CE and its gradients. Returns the loss
    and the float32 logits, detached."""
    state.model.train()
    state.optimizer.zero_grad(set_to_none=True)
    logits = state.model(batch["image"]).float()
    loss = weighted_ce(logits, batch["label"], class_weights, batch["mask"])
    loss.backward()
    return loss.detach(), logits.detach()


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
    """One update. Returns (loss, train-mode softmax probabilities), both on
    the device."""
    loss, logits = forward_backward(state, batch, class_weights)
    apply_gradients(state)
    return loss, torch.softmax(logits, dim=-1)


@torch.no_grad()
def eval_step(state: TrainState, batch: dict):
    """Eval-mode forward. Returns (unweighted masked CE, probabilities)."""
    state.model.eval()
    logits = state.model(batch["image"]).float()
    return masked_ce(logits, batch["label"], batch["mask"]), torch.softmax(logits, dim=-1)


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
    so dropout draws nothing. With no batches the state is left as it was."""
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
