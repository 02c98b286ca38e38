"""Cross-modal transformer toolkit and small 3-D CNN tokenizers (port of the
TPU package's models/transformer.py):

- `SmallCNN3D`: four conv stages (dim/4 -> dim/4, dim/2 -> dim/2, dim ->
  2 dim, dim) with max / max / max / avg 2^3 pooling, /16 spatially with
  floors (91 -> 45 -> 22 -> 11 -> 5: a 91x109x91 volume gives 5x6x5 = 150
  tokens); `SFCN`: 32/64/128/128 pooled stages and a 1^3 head to 64;
- `ConvBNAct`: conv (with bias) -> BatchNorm -> leaky ReLU (slope 0.01,
  flax's) or ReLU; BatchNorm is `FlaxBatchNorm3d` (eps 1e-5, flax
  momentum 0.9, flax's biased running variance);
- `CrossAttention` (optional context, `kv_include_self`), `FeedForward`
  (tanh GELU), `positional_encoding_1d`, the pre-LN `Transformer`,
  `CrossTransformer` (each modality attends to both token sets; `share`
  reuses one encoder pair) and `CrossTransformerModAvg` (cross-attention,
  then mean and max pooled tokens of both modalities, (B, 4 dim));
- `MultimodalClassifier`: SmallCNN3D tokens of the MRI (+ the PET's), an
  optional table token, fused by CrossTransformerModAvg (MRI + PET) or a
  Transformer over the token union (mean and max pooled), dropout, linear
  head.

Layout: volumes are channels-last (B, X, Y, Z, C), as in the TPU package;
the CNNs work on channels-first tensors inside. Precision as the TPU
package's: with ``compute_dtype=torch.bfloat16`` (the default) the CNNs
run under bf16 autocast over float32 parameters and the positional
encoding is added in bf16; the tokens are float32 from there on, and the
attention, table projection and head run in float32 with autocast off.
flax's LayerNorm epsilon (1e-6) and initializers (LeCun-normal kernels,
zero biases; `generator` draws them). Dropout draws from
`GeneratorDropout`'s generator. A flax Dense infers its input width; here
the table's width is given (`table_dim`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .resnet3d import FlaxBatchNorm3d, GeneratorDropout
from .unet3d import _autocast, _check_dtype, _flax_init_

LN_EPS = 1e-6  # flax's LayerNorm epsilon


class ConvBNAct(nn.Module):
    """k^3 conv (padding (k-1)//2, with bias) -> BatchNorm -> activation."""

    def __init__(self, cin: int, features: int, kernel: int = 3, act: str = "leaky_relu"):
        super().__init__()
        self.conv = nn.Conv3d(cin, features, kernel, padding=(kernel - 1) // 2)
        self.bn = FlaxBatchNorm3d(features, eps=1e-5, momentum=0.1)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.leaky_relu(x, 0.01) if self.act == "leaky_relu" else F.relu(x)


class SmallCNN3D(nn.Module):
    """sNet: (B, C, X, Y, Z) -> (B, dim, X/16, Y/16, Z/16) (floors)."""

    def __init__(self, dim: int = 128, in_channels: int = 1):
        super().__init__()
        d = dim
        widths = [(in_channels, d // 4, 3), (d // 4, d // 4, 3), (d // 4, d // 2, 3),
                  (d // 2, d // 2, 3), (d // 2, d, 3), (d, d * 2, 3), (d * 2, d, 1)]
        self.blocks = nn.ModuleList(ConvBNAct(i, o, k) for i, o, k in widths)

    def forward(self, x):
        b = self.blocks
        x = F.max_pool3d(b[0](x), 2)
        x = F.max_pool3d(b[2](b[1](x)), 2)
        x = F.max_pool3d(b[4](b[3](x)), 2)
        return F.avg_pool3d(b[6](b[5](x)), 2)


class SFCN(nn.Module):
    """32/64/128/128 conv + ReLU + max-pool stages, then a 1^3 conv to 64."""

    def __init__(self, in_channels: int = 1):
        super().__init__()
        chans = [in_channels, 32, 64, 128, 128]
        self.blocks = nn.ModuleList(ConvBNAct(chans[i], chans[i + 1], act="relu")
                                    for i in range(4))
        self.head = ConvBNAct(128, 64, kernel=1, act="relu")

    def forward(self, x):
        for blk in self.blocks:
            x = F.max_pool3d(blk(x), 2)
        return self.head(x)


class CrossAttention(nn.Module):
    """Multi-head attention of `x` over `context` (default `x` itself; with
    `kv_include_self` over [x, context])."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 64, dropout: float = 0.0):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        self.to_out = nn.Linear(inner, dim)
        self.dropout = GeneratorDropout(dropout)

    def forward(self, x, context=None, kv_include_self: bool = False):
        ctx = x if context is None else context
        if kv_include_self:
            ctx = torch.cat([x, ctx], 1)
        k, v = self.to_kv(ctx).chunk(2, dim=-1)

        def heads(t):
            b, n, _ = t.shape
            return t.view(b, n, self.heads, self.dim_head).transpose(1, 2)

        q, k, v = heads(self.to_q(x)), heads(k), heads(v)
        attn = torch.softmax((q @ k.transpose(-1, -2)) * self.dim_head ** -0.5, dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(x.shape[0], x.shape[1], -1)
        return self.dropout(self.to_out(out))


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, dim)
        self.drop1 = GeneratorDropout(dropout)
        self.drop2 = GeneratorDropout(dropout)

    def forward(self, x):
        return self.drop2(self.fc2(self.drop1(F.gelu(self.fc1(x), approximate="tanh"))))


def positional_encoding_1d(n: int, channels: int) -> np.ndarray:
    """Sin/cos 1-D positional encoding (n, channels), float32."""
    ch = int(np.ceil(channels / 2) * 2)
    inv_freq = 1.0 / (10000 ** (np.arange(0, ch, 2) / ch))
    pos = np.arange(n)[:, None] * inv_freq[None, :]
    emb = np.concatenate([np.sin(pos), np.cos(pos)], axis=-1)
    return emb[:, :channels].astype(np.float32)


class _Layer(nn.Module):
    def __init__(self, dim, heads, dim_head, mlp_dim, dropout):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = CrossAttention(dim, heads, dim_head, dropout)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ff = FeedForward(dim, mlp_dim, dropout)


class Transformer(nn.Module):
    """Pre-LN encoder stack with an optional cross-attention context and a
    final LayerNorm."""

    def __init__(self, dim: int, depth: int, heads: int = 4, dim_head: int = 64,
                 mlp_dim: int = 256, dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList(_Layer(dim, heads, dim_head, mlp_dim, dropout)
                                    for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x, context=None):
        for layer in self.layers:
            x = x + layer.attn(layer.norm1(x), context=context)
            x = x + layer.ff(layer.norm2(x))
        return self.norm(x)


class CrossTransformer(nn.Module):
    """Bidirectional token cross-attention: each modality's encoder attends
    to the concatenation of both token sets, `depth` times; `share` reuses
    one encoder pair."""

    def __init__(self, dim: int, depth: int, heads: int = 4, dim_head: int = 64,
                 mlp_dim: int = 256, dropout: float = 0.0, share: bool = False):
        super().__init__()
        self.depth, self.share = depth, share
        n_pairs = 1 if share else depth
        self.mri_enc = nn.ModuleList(Transformer(dim, 1, heads, dim_head, mlp_dim, dropout)
                                     for _ in range(n_pairs))
        self.pet_enc = nn.ModuleList(Transformer(dim, 1, heads, dim_head, mlp_dim, dropout)
                                     for _ in range(n_pairs))

    def forward(self, mri_tokens, pet_tokens):
        for step in range(self.depth):
            i = 0 if self.share else step
            both = torch.cat([mri_tokens, pet_tokens], 1)
            mri_tokens = self.mri_enc[i](mri_tokens, context=both) + mri_tokens
            both = torch.cat([mri_tokens, pet_tokens], 1)
            pet_tokens = self.pet_enc[i](pet_tokens, context=both) + pet_tokens
        return mri_tokens, pet_tokens


class CrossTransformerModAvg(nn.Module):
    """Each modality attends to the other, `depth` times; returns the mean
    and max pooled tokens of both, (B, 4 dim)."""

    def __init__(self, dim: int, depth: int, heads: int = 4, dim_head: int = 64,
                 mlp_dim: int = 256, dropout: float = 0.0):
        super().__init__()
        self.mri_enc = nn.ModuleList(Transformer(dim, 1, heads, dim_head, mlp_dim, dropout)
                                     for _ in range(depth))
        self.pet_enc = nn.ModuleList(Transformer(dim, 1, heads, dim_head, mlp_dim, dropout)
                                     for _ in range(depth))

    def forward(self, mri_tokens, pet_tokens):
        for mri_enc, pet_enc in zip(self.mri_enc, self.pet_enc):
            mri_tokens = mri_enc(mri_tokens, context=pet_tokens) + mri_tokens
            pet_tokens = pet_enc(pet_tokens, context=mri_tokens) + pet_tokens
        return torch.cat([mri_tokens.mean(1), pet_tokens.mean(1),
                          mri_tokens.amax(1), pet_tokens.amax(1)], -1)


def volume_to_tokens(feat_map, add_pos: bool = True):
    """(B, C, X, Y, Z) feature map -> (B, X*Y*Z, C) tokens (X-major, as the
    channels-last reshape), plus the sinusoidal positions in the map's
    dtype."""
    b, c = feat_map.shape[:2]
    tokens = feat_map.flatten(2).transpose(1, 2)
    if add_pos:
        pos = torch.from_numpy(positional_encoding_1d(tokens.shape[1], c))
        tokens = tokens + pos.to(tokens.device, tokens.dtype)[None]
    return tokens


class MultimodalClassifier(nn.Module):
    """End-to-end fusion classifier over 'image' (MRI, required), optional
    'pet' and an optional 'table' vector of `table_dim` values (e.g. the
    in-context embedder's output). Returns float32 logits (B, classes)."""

    def __init__(self, num_classes: int = 2, dim: int = 128, depth: int = 2, heads: int = 4,
                 dim_head: int = 32, mlp_dim: int = 256, dropout: float = 0.1,
                 use_pet: bool = False, use_table: bool = False, table_dim: int | None = None,
                 in_channels: int = 1, compute_dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None):
        super().__init__()
        if use_table and not table_dim:
            raise ValueError("use_table=True requires table_dim (the table vector's width)")
        self.use_pet, self.use_table = use_pet, use_table
        self.compute_dtype = _check_dtype(compute_dtype)
        self.mri_cnn = SmallCNN3D(dim, in_channels)
        if use_table:
            self.table_proj = nn.Linear(table_dim, dim)
        if use_pet:
            self.pet_cnn = SmallCNN3D(dim, in_channels)
            self.fusion = CrossTransformerModAvg(dim, depth, heads, dim_head, mlp_dim, dropout)
        else:
            self.fusion = Transformer(dim, depth, heads, dim_head, mlp_dim, dropout)
        self.dropout = GeneratorDropout(dropout)
        self.head = nn.Linear((4 if use_pet else 2) * dim, num_classes)
        _flax_init_(self, generator)

    def _tokens(self, cnn, vol):
        x = vol.permute(0, 4, 1, 2, 3)
        if self.compute_dtype == torch.float32:
            x = x.float()
        with _autocast(x, self.compute_dtype):
            return volume_to_tokens(cnn(x)).float()

    def forward(self, image, pet=None, table=None):
        mri_tokens = self._tokens(self.mri_cnn, image)
        with torch.autocast(device_type=image.device.type, enabled=False):
            extra = []
            if self.use_table:
                if table is None:
                    raise ValueError("use_table=True requires `table`")
                extra.append(self.table_proj(table.float())[:, None, :])
            if self.use_pet:
                if pet is None:
                    raise ValueError("use_pet=True requires `pet`")
                pet_tokens = torch.cat([self._tokens(self.pet_cnn, pet)] + extra, 1)
                cls = self.fusion(mri_tokens, pet_tokens)
            else:
                enc = self.fusion(torch.cat([mri_tokens] + extra, 1))
                cls = torch.cat([enc.mean(1), enc.amax(1)], -1)
            return self.head(self.dropout(cls)).float()
