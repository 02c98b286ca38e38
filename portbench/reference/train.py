"""Plain float32 reference of the cross-validation training step: the
class-weighted cross entropy, its gradients, the clip to a global norm,
Adam with the weight decay added to the gradient, the warmup-cosine rate,
and the eval-mode forward with its masked cross entropy.

The forward is the model family's reference (`portbench/lib/family.py`).
Each step returns what the check compares: the loss, each parameter's
gradient as the optimizer gets it (clipped, plus the decay), and the
parameters after the update. Imports neither JAX nor the program."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def epoch_schedule(base_lr: float, num_epochs: int, warmup_frac: float = 0.1,
                   min_lr_factor: float = 1e-4, start_factor: float = 0.1):
    """Linear warmup from start_factor * lr over clamp(int(epochs *
    warmup_frac), 1, 10) updates, then a cosine to lr * min_lr_factor over
    the remaining epochs' count, indexed by the update count."""
    warmup = max(1, min(10, int(num_epochs * warmup_frac)))
    cosine = max(1, num_epochs - warmup)
    alpha = min_lr_factor

    def rate(count: int) -> float:
        if count < warmup:
            return base_lr * (start_factor + (1 - start_factor) * count / warmup)
        c = min(count - warmup, cosine)
        return base_lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / cosine)) + alpha)

    return rate


def weighted_ce(logits, labels, weights, mask):
    """sum(w * nll) / sum(w) over the real rows, w the class weight."""
    nll = -F.log_softmax(logits.float(), dim=-1).gather(1, labels.long()[:, None])[:, 0]
    w = weights[labels.long()] * mask
    return (w * nll).sum() / w.sum().clamp(min=1e-8)


class Trainer:
    """Parameters (float32 leaves), buffers (running statistics, integer
    tensors) and Adam's moments of one fold of configuration `cfg`, stepped
    in float32 through its model family's reference forward. `quant` puts
    the fp8 control's rounding into every product
    (`portbench/reference/lowp.py`)."""

    def __init__(self, sd: dict, family, cfg: dict, class_weights, schedule, quant=None):
        self.family, self.cfg = family, cfg
        self.params = {k: v.detach().clone().float().requires_grad_(True)
                       for k, v in sd.items() if _is_param(k, v)}
        self.buffers = {k: v.detach().clone() for k, v in sd.items() if not _is_param(k, v)}
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.cw = class_weights
        self.schedule = schedule
        self.wd, self.clip = cfg["weight_decay"], cfg["grad_clip_norm"]
        self.quant = quant
        self.count = 0

    def _sd(self):
        return {**self.params, **self.buffers}

    def step(self, x, labels, mask, dropout_keep):
        """One update on NCDHW float32 `x`. Returns (loss, {leaf: gradient
        as the optimizer gets it})."""
        stats = {}
        logits = self.family.reference_forward(self._sd(), x, self.cfg, train=True,
                                               dropout_keep=dropout_keep, stats=stats,
                                               quant=self.quant)
        loss = weighted_ce(logits, labels, self.cw, mask)
        names = list(self.params)
        grads = torch.autograd.grad(loss, [self.params[k] for k in names])
        with torch.no_grad():
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
            scale = 1.0 if float(norm) < self.clip else self.clip / norm
            self.count += 1
            lr = self.schedule(self.count - 1)
            b1, b2 = BETAS
            seen = {}
            for k, g in zip(names, grads):
                p = self.params[k]
                g = g * scale + self.wd * p
                seen[k] = g
                self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                mh = self.m[k] / (1 - b1 ** self.count)
                vh = self.v[k] / (1 - b2 ** self.count)
                p.sub_(lr * mh / (vh.sqrt() + ADAM_EPS))
            self.family.update_running_stats(self.buffers, stats)
            for k in self.buffers:
                if k.endswith("num_batches_tracked"):
                    self.buffers[k] = self.buffers[k] + 1
        return float(loss.detach()), seen

    @torch.no_grad()
    def evaluate(self, x, labels, mask):
        """Eval-mode forward: (masked mean cross entropy, probabilities)."""
        logits = self.family.reference_forward(self._sd(), x, self.cfg, quant=self.quant)
        nll = -F.log_softmax(logits, dim=-1).gather(1, labels.long()[:, None])[:, 0]
        return float((nll * mask).sum() / mask.sum()), torch.softmax(logits, dim=-1)


def _is_param(key: str, value: torch.Tensor) -> bool:
    return value.is_floating_point() and not key.endswith(("running_mean", "running_var"))
