"""Multi-scale hypergraph time-series forecaster, MSHyper (port of the TPU
package's models/hypergraph.py).

- instance normalization of the input window, undone on the forecast
  (``y * std + mean``);
- a multi-scale pyramid: the sequence embedded by a linear layer, then
  repeatedly downsampled by strided 1-D convs (window `w`, stride `w`, no
  padding), all scales' nodes concatenated;
- hyperedges: sliding windows of `inner_size` nodes within each scale, and
  each coarse node with its children one scale down
  (`build_pyramid_incidence`, a dense (N, E) incidence matrix in numpy);
- two-pass hypergraph convolution with degree normalization
  (`hypergraph_conv`: node -> edge scaled by 1/edge degree, edge -> node
  by 1/node degree), with optional hyperedge attention (a softmax over the
  edges incident to each node, the others masked with -1e9);
- a DLinear-style trunk (a linear map seq_len -> pred_len per channel)
  summed with the hypergraph branch, then a linear mixing layer.

Both message-passing passes are dense matrix products (torch.matmul /
einsum), as in the TPU package: no scatter, no gather. Layout is (B, L, C)
as there; flax's Dense on the last axis is `nn.Linear`, its strided conv
on (B, L, C) a `Conv1d` on (B, C, L). `mshyper_state_dict_from_flax` in
utils/torch_weights.py converts the TPU package's variables.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn


def build_pyramid_sizes(seq_len: int, window_sizes: Sequence[int]) -> list[int]:
    """Node count per scale: seq_len, then repeated integer division."""
    sizes = [seq_len]
    for w in window_sizes:
        sizes.append(max(1, sizes[-1] // w))
    return sizes


def build_pyramid_incidence(seq_len: int, window_sizes: Sequence[int],
                            inner_size: int = 3) -> np.ndarray:
    """Dense incidence matrix H (N_total, E) float32: H[n, e] = 1 iff node n
    is in hyperedge e. Intra-scale sliding-window edges (stride 1), then
    inter-scale parent-child edges."""
    sizes = build_pyramid_sizes(seq_len, window_sizes)
    offsets = np.cumsum([0] + sizes)
    edges = []
    for s, size in enumerate(sizes):
        base = offsets[s]
        for start in range(max(1, size - inner_size + 1)):
            edges.append([base + start + k for k in range(min(inner_size, size))])
    for s, w in enumerate(window_sizes):
        fine_base, coarse_base = offsets[s], offsets[s + 1]
        for c in range(sizes[s + 1]):
            edges.append([coarse_base + c] + [fine_base + c * w + k for k in range(w)
                                              if c * w + k < sizes[s]])
    H = np.zeros((offsets[-1], len(edges)), np.float32)
    for e, nodes in enumerate(edges):
        H[nodes, e] = 1.0
    return H


def _edge_mean(x: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """(B, N, F) node features -> (B, E, F): each hyperedge's mean node."""
    edge_deg = H.sum(dim=0).clamp(min=1.0)
    return torch.einsum("ne,bnf->bef", H, x) / edge_deg[None, :, None]


def hypergraph_conv(x: torch.Tensor, H: torch.Tensor,
                    attention_scores: torch.Tensor | None = None) -> torch.Tensor:
    """Two-pass degree-normalized hypergraph convolution.

    x: (B, N, F) node features; H: (N, E) incidence.
    edge_feat = diag(1/edge_deg) H^T x        (node -> hyperedge)
    out       = diag(1/node_deg) H edge_feat  (hyperedge -> node)
    Optional attention_scores (B, N, E) reweight the second pass."""
    H = H.to(x.dtype)
    node_deg = H.sum(dim=1).clamp(min=1.0)
    edge_feat = _edge_mean(x, H)
    Hw = H[None] if attention_scores is None else H[None] * attention_scores
    return torch.einsum("bne,bef->bnf", Hw, edge_feat) / node_deg[None, :, None]


class HyperedgeAttention(nn.Module):
    """Per-node softmax attention over its incident hyperedges: queries from
    the nodes, keys from the hyperedges' mean nodes."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.features = features
        self.query = nn.Linear(in_features, features)
        self.key = nn.Linear(in_features, features)

    def forward(self, x: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
        q = self.query(x)                                        # (B, N, F)
        k = self.key(_edge_mean(x, H.to(x.dtype)))               # (B, E, F)
        scores = torch.einsum("bnf,bef->bne", q, k) / math.sqrt(float(self.features))
        scores = torch.where(H[None] > 0, scores, torch.full_like(scores, -1e9))
        return torch.softmax(scores, dim=-1)


class PyramidConstruct(nn.Module):
    """Coarser scales by strided 1-D convs; all scales' nodes concatenated:
    (B, L, C) -> (B, N_total, d_model)."""

    def __init__(self, channels: int, d_model: int, window_sizes: Sequence[int]):
        super().__init__()
        self.embed = nn.Linear(channels, d_model)
        self.convs = nn.ModuleList(nn.Conv1d(d_model, d_model, w, stride=w)
                                   for w in window_sizes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.embed(x)
        scales, cur = [x], x.transpose(1, 2)                     # (B, d, L)
        for conv in self.convs:
            cur = conv(cur)
            scales.append(cur.transpose(1, 2))
        return torch.cat(scales, dim=1)


class MSHyperModel(nn.Module):
    """Forecaster: x (B, seq_len, channels) -> (B, pred_len, channels)."""

    def __init__(self, seq_len: int, pred_len: int, channels: int, d_model: int = 64,
                 window_sizes: Sequence[int] = (4, 4), inner_size: int = 3,
                 use_attention: bool = True):
        super().__init__()
        H = torch.from_numpy(build_pyramid_incidence(seq_len, window_sizes, inner_size))
        self.register_buffer("H", H, persistent=False)
        n_nodes = H.shape[0]
        self.pyramid = PyramidConstruct(channels, d_model, window_sizes)
        self.attention = HyperedgeAttention(d_model, d_model) if use_attention else None
        self.node_out = nn.Linear(d_model, channels)
        self.out_tran = nn.Linear(n_nodes, pred_len)
        self.trunk = nn.Linear(seq_len, pred_len)
        self.mix = nn.Linear(pred_len, pred_len)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=1, keepdim=True)
        std = torch.sqrt(x.var(dim=1, unbiased=False, keepdim=True) + 1e-5)
        xn = (x - mean) / std

        nodes = self.pyramid(xn)
        attn = self.attention(nodes, self.H) if self.attention is not None else None
        conv = torch.relu(hypergraph_conv(nodes, self.H, attn) + nodes)  # residual

        g = self.out_tran(self.node_out(conv).transpose(1, 2))   # (B, C, pred)
        t = self.trunk(xn.transpose(1, 2))                       # (B, C, pred)
        y = self.mix(t + g).transpose(1, 2)                      # (B, pred, C)
        return y * std + mean
