"""What the in-context networks' meta-training shares (the classifier's
`icl.pretrain_icl` and the regressor's `icl_regression.pretrain_icl_regression`):

- `flax_init_tree`: fresh weights in flax's layout, drawn leaf by leaf
  from flax's initializers (the TPU package's distributions, the port's
  own draws): LeCun-normal truncated at two standard deviations for
  Dense and attention kernels (fan-in = the input width; for the
  attention output, heads x head_dim), flax's `default_embed_init`
  (normal, std 1/sqrt(d)) for embeddings, normal(0.02) for the query
  token, zeros for biases and for the zero-init categorical projections,
  ones for LayerNorm scales;
- `MetaTrainer`: the TPU package's optax chain, clip_by_global_norm(1.0)
  then adamw(cosine_decay_schedule(lr, steps)) with optax's defaults
  (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4 on every leaf), the
  rate taken at the update count (train/loop.py); a step keeps its loss
  on the device;
- `run_device_chunks`: meta-training on tasks drawn on the device, read
  back once a chunk;
- `supervised_contrastive`: the masked InfoNCE term of the auxiliary
  losses.
"""

from __future__ import annotations

import numpy as np
import torch

from ..train.loop import (TrainState, apply_gradients, cosine_decay_schedule,
                          make_optimizer)

#: flax's truncated-normal correction: the std of a unit normal cut at +-2
_TRUNC_STD = 0.87962566103423978


def _truncated_normal(rng: np.random.Generator, shape) -> np.ndarray:
    z = rng.standard_normal(shape)
    bad = np.abs(z) > 2
    while bad.any():
        z[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(z) > 2
    return z


def _leaf_init(rng, path: tuple, shape: tuple, zero: tuple) -> np.ndarray:
    name, owner = path[-1], path[-2] if len(path) > 1 else ""
    if name == "bias" or owner in zero:
        return np.zeros(shape, np.float32)
    if name == "scale":
        return np.ones(shape, np.float32)
    if name == "embedding":
        return (rng.standard_normal(shape) / np.sqrt(shape[-1])).astype(np.float32)
    if name == "query_token":
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)
    if name == "kernel":
        # DenseGeneral flattens the attention kernels: q/k/v (d, heads,
        # head_dim) take d inputs, the output (heads, head_dim, d) takes
        # heads x head_dim
        fan_in = int(np.prod(shape[:-1])) if owner == "out" else shape[0]
        std = np.sqrt(1.0 / fan_in) / _TRUNC_STD
        return (_truncated_normal(rng, shape) * std).astype(np.float32)
    raise ValueError(f"no initializer for the leaf {path}")


def flax_init_tree(rows, seed: int, zero: tuple = ()) -> dict:
    """A flax-layout weight tree ({'params': {...}} of float32 arrays) for
    the name-map `rows` (torch name, flax path, flax shape, transform) of
    utils/torch_weights.py, drawn from ``np.random.default_rng(seed)``;
    the kernels of the modules named in `zero` start at zero."""
    rng = np.random.default_rng(seed)
    tree: dict = {}
    for _, path, shape, _ in rows:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _leaf_init(rng, path, tuple(shape), zero)
    return tree


def supervised_contrastive(sim, keys, same):
    """The mean over anchors with a positive of -mean_{positives}
    log softmax(sim)[positive]: `sim` (B, M, K) scores, `keys` (B, M, K)
    the keys each anchor may see, `same` (B, M, K) its positives. Hidden
    keys get float32's minimum rather than -inf, so that no gradient
    carries inf * 0: the loss is the same (exp underflows to 0 either way)."""
    sim = sim.masked_fill(~keys, torch.finfo(sim.dtype).min)
    log_z = torch.logsumexp(sim, dim=-1, keepdim=True)
    pos_lp = torch.where(same, sim - log_z, 0.0).sum(-1)
    n_pos = same.sum(-1)
    has_pos = n_pos > 0
    con = -torch.where(has_pos, pos_lp / n_pos.clamp(min=1), 0.0)
    return con.sum() / has_pos.sum().clamp(min=1)


def unit_rows(h):
    """h / max(||h||, 1e-6) along the last axis."""
    return h / torch.linalg.vector_norm(h, dim=-1, keepdim=True).clamp(min=1e-6)


class MetaTrainer:
    """clip_by_global_norm(1.0) -> adamw(cosine_decay_schedule(lr, steps))
    over `net`'s parameters; `step(task)` takes one update on
    ``loss_fn(net, task)`` and returns the loss, on the device."""

    def __init__(self, net: torch.nn.Module, lr: float, steps: int, loss_fn):
        self.net = net
        self.loss_fn = loss_fn
        schedule = cosine_decay_schedule(lr, steps)
        opt = make_optimizer(net.parameters(), schedule, weight_decay=1e-4, kind="adamw")
        self.state = TrainState(net, opt, schedule, grad_clip_norm=1.0)

    def step(self, task: dict) -> torch.Tensor:
        self.state.optimizer.zero_grad(set_to_none=True)
        loss = self.loss_fn(self.net, task)
        loss.backward()
        for p in self.net.parameters():
            if p.grad is None:  # optax updates (decays) every leaf
                p.grad = torch.zeros_like(p)
        apply_gradients(self.state)
        return loss.detach()


def run_device_chunks(trainer: MetaTrainer, draw, steps: int, chunk: int,
                      verbose: bool, tag: str):
    """`steps` updates on tasks from `draw()` (on the device), `chunk` at a
    time; the last chunk is cut to the remainder, so exactly `steps`
    updates run. The losses stay on the device inside a chunk and are read
    once at its end."""
    done = 0
    while done < steps:
        n = min(chunk, steps - done)
        losses = [trainer.step(draw()) for _ in range(n)]
        done += n
        mean = float(torch.stack(losses).mean())
        if verbose:
            print(f"{tag} step {done}/{steps} loss {mean:.4f}", flush=True)
