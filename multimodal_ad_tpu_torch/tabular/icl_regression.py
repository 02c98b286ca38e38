"""In-context regression network with bar-distribution (Riemann) decoding,
in PyTorch (own copy of the TPU package's tabular/icl_regression.py).

- context rows embed a CONTINUOUS target (z-scored by context statistics)
  through a learned projection instead of a class-label embedding;
- the head emits logits over `n_bins` equal-width bars spanning
  [-y_clip, y_clip] in context-normalized target space;
- decoding (regression.py): mean = E[bar centers], median/quantiles from
  the bar CDF.

The trunk is the classifier's (icl.py: flax's LayerNorm, GELU and masked
attention). The bundled asset follows the classifier's policy
(`resolve_asset_params`), with its own override MAD_ICL_REG_ASSET.
`pretrain_icl_regression` meta-trains the network on the continuous-target
prior, always sampled on the device (`icl_prior.sample_reg_tasks_device`):
the soft two-hot cross entropy of the bar distribution against the
context-normalized target.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .icl import ICLTrunk, _assets_dir, float32_tree, resolve_asset_params


@dataclass(frozen=True)
class RegICLConfig:
    d_model: int = 256
    n_heads: int = 8
    n_layers: int = 6
    d_ff: int = 1024
    max_features: int = 192
    max_context: int = 512
    n_bins: int = 32
    y_clip: float = 3.0
    dropout: float = 0.0


def bin_centers(cfg: RegICLConfig) -> np.ndarray:
    edges = np.linspace(-cfg.y_clip, cfg.y_clip, cfg.n_bins + 1)
    return ((edges[:-1] + edges[1:]) / 2).astype(np.float32)


class RegICLTransformer(ICLTrunk):
    """Forward over a batch of in-context regression tasks.

    Inputs: x_ctx (B, N, F), y_ctx (B, N) float32 (context-normalized),
    ctx_mask (B, N) {0,1}, x_qry (B, M, F).
    Returns bar logits (B, M, n_bins), qry_emb (B, M, d_model), ctx_emb
    (B, N, d_model).
    """

    def __init__(self, cfg: RegICLConfig):
        super().__init__(cfg)
        self.cfg = cfg
        d = cfg.d_model
        self.feature_proj = nn.Linear(cfg.max_features, d)
        self.target_proj = nn.Linear(1, d)
        self.query_token = nn.Parameter(torch.randn(d) * 0.02)
        self.reg_head = nn.Linear(d, cfg.n_bins)

    def forward(self, x_ctx, y_ctx, ctx_mask, x_qry):
        n = x_ctx.shape[1]
        h_ctx = self.feature_proj(x_ctx) + self.target_proj(y_ctx[..., None])
        h_qry = self.feature_proj(x_qry) + self.query_token
        h, _ = self.run(torch.cat([h_ctx, h_qry], 1), ctx_mask, n, False)
        return self.reg_head(h[:, n:]), h[:, n:], h[:, :n]


def soft_two_hot(y, centers):
    """Linearly-interpolated two-hot target over equal-width bar centers
    (the meta-training target); `y` is a tensor or an array."""
    y = torch.as_tensor(y, dtype=torch.float32)
    c = torch.as_tensor(centers, dtype=torch.float32, device=y.device)
    k = c.shape[0]
    pos = (torch.clamp(y, c[0], c[-1]) - c[0]) / (c[1] - c[0])
    lo = torch.floor(pos).long().clamp(0, k - 2)
    w_hi = (pos - lo)[..., None]
    return (F.one_hot(lo, k) * (1 - w_hi) + F.one_hot(lo + 1, k) * w_hi)


def _zscore_y_by_ctx(y_ctx, ctx_mask, y_qry=None):
    """Normalize targets by VALID-context statistics (mask-aware, torch)."""
    denom = torch.clamp(ctx_mask.sum(-1, keepdim=True), min=1.0)
    mean = (y_ctx * ctx_mask).sum(-1, keepdim=True) / denom
    var = (((y_ctx - mean) ** 2) * ctx_mask).sum(-1, keepdim=True) / denom
    std = torch.sqrt(var + 1e-9)
    z_ctx = (y_ctx - mean) / std * ctx_mask
    if y_qry is None:
        return z_ctx, mean, std
    return z_ctx, (y_qry - mean) / std


def default_reg_asset_path() -> str:
    """Bundled regression asset; override with MAD_ICL_REG_ASSET."""
    return os.environ.get("MAD_ICL_REG_ASSET") or os.path.join(
        _assets_dir(), "icl_regression_default.msgpack")


def _load_reg_params_file(cfg: RegICLConfig, path: str):
    from ..utils.torch_weights import reg_icl_state_dict_from_flax
    from .flax_msgpack import read_state

    tree = read_state(path)
    reg_icl_state_dict_from_flax(tree, cfg)
    return float32_tree(tree)


def load_default_reg_params(cfg: RegICLConfig):
    """Meta-trained regression weights for `cfg` under the classifier's
    `resolve_asset_params` policy; None when no asset applies."""
    return resolve_asset_params(
        lambda p: _load_reg_params_file(cfg, p), "MAD_ICL_REG_ASSET",
        default_reg_asset_path(), cfg == RegICLConfig(), f"RegICLConfig {cfg}")


def sample_template_task(cfg: RegICLConfig) -> dict:
    """The small fixed task (1 context of 8 rows, 4 queries) the TPU
    package builds its weight template from, as float32 numpy arrays."""
    rng = np.random.default_rng(0)
    return {
        "x_ctx": rng.normal(size=(1, 8, cfg.max_features)).astype(np.float32),
        "y_ctx": np.zeros((1, 8), np.float32),
        "ctx_mask": np.ones((1, 8), np.float32),
        "x_qry": rng.normal(size=(1, 4, cfg.max_features)).astype(np.float32),
    }


def init_reg_icl_params(cfg: RegICLConfig, seed: int = 0) -> dict:
    """Fresh regression weights in flax's layout, drawn from flax's
    initializers (`meta_train.flax_init_tree`)."""
    from ..utils.torch_weights import reg_icl_name_map
    from .meta_train import flax_init_tree

    return flax_init_tree(reg_icl_name_map(cfg), seed)


def reg_meta_loss(net: RegICLTransformer, task: dict, centers: torch.Tensor):
    """Soft two-hot cross entropy of the bar logits against the queries'
    context-normalized targets, averaged over tasks and queries."""
    from .icl import _zscore_by_ctx

    mask = task["ctx_mask"]
    xc, xq = _zscore_by_ctx(task["x_ctx"], task["x_qry"], mask)
    zc, zq = _zscore_y_by_ctx(task["y_ctx"], mask, task["y_qry"])
    logits, _, _ = net(xc, zc, mask, xq)
    target = soft_two_hot(zq, centers)
    return -(target * F.log_softmax(logits, -1)).sum(-1).mean()


def pretrain_icl_regression(cfg: RegICLConfig = RegICLConfig(), steps: int = 3000,
                            batch: int = 32, n_ctx: int = 96, n_qry: int = 32,
                            lr: float = 3e-4, seed: int = 0, verbose: bool = False,
                            init_params=None, chunk: int = 100,
                            device: str | torch.device = "cuda"):
    """Meta-train the regression network on `device`; returns (params,
    cfg), params a flax-layout float32 tree. Tasks always come from
    `icl_prior.sample_reg_tasks_device` (a generator seeded ``seed + 1``,
    as the TPU package's key), ``chunk`` steps at a time with the losses
    read once a chunk; weights from ``init_params`` or
    `init_reg_icl_params(cfg, seed)`; the optimizer is the classifier's
    (`meta_train.MetaTrainer`)."""
    from ..core.device import resolve_device
    from ..utils.torch_weights import (reg_icl_flax_from_state_dict,
                                       reg_icl_state_dict_from_flax)
    from .icl_prior import sample_reg_tasks_device
    from .meta_train import MetaTrainer, run_device_chunks

    dev = resolve_device(device)
    params = init_params if init_params is not None else init_reg_icl_params(cfg, seed)
    centers = torch.from_numpy(bin_centers(cfg)).to(dev)
    with torch.inference_mode(False), torch.enable_grad():
        net = RegICLTransformer(cfg)
        net.load_state_dict(reg_icl_state_dict_from_flax(params, cfg))
        net = net.to(dev).train()
        trainer = MetaTrainer(net, lr, steps, lambda m, t: reg_meta_loss(m, t, centers))
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        run_device_chunks(trainer, lambda: sample_reg_tasks_device(
            gen, batch, cfg, n_ctx, n_qry), steps, chunk, verbose, "[icl-reg pretrain]")
        return reg_icl_flax_from_state_dict(net.state_dict(), cfg), cfg
