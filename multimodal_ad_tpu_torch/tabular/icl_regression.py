"""In-context regression network with bar-distribution (Riemann) decoding:
the inference path, in PyTorch (own copy of the TPU package's
tabular/icl_regression.py, minus meta-training).

- context rows embed a CONTINUOUS target (z-scored by context statistics)
  through a learned projection instead of a class-label embedding;
- the head emits logits over `n_bins` equal-width bars spanning
  [-y_clip, y_clip] in context-normalized target space;
- decoding (regression.py): mean = E[bar centers], median/quantiles from
  the bar CDF.

The trunk is the classifier's (icl.py: flax's LayerNorm, GELU and masked
attention). The bundled asset follows the classifier's policy
(`resolve_asset_params`), with its own override MAD_ICL_REG_ASSET.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
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
    (numpy; the meta-training target)."""
    y = np.asarray(y, np.float32)
    centers = np.asarray(centers, np.float32)
    k = centers.shape[0]
    step = centers[1] - centers[0]
    pos = (np.clip(y, centers[0], centers[-1]) - centers[0]) / step
    lo = np.clip(np.floor(pos).astype(np.int32), 0, k - 2)
    w_hi = pos - lo
    eye = np.eye(k, dtype=np.float32)
    return eye[lo] * (1 - w_hi)[..., None] + eye[lo + 1] * w_hi[..., None]


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
