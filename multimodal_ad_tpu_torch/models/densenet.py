"""Dilated depthwise-separable DenseNet, 2-D and 3-D (port of the TPU
package's models/densenet.py).

- a DenseNet-121-style layout: a 7/s2 conv stem, BN, ReLU, a 3/s2 max
  pool (padded with -inf), dense blocks of (6, 12, 24, 16) layers with
  dilations (1, 1, 2, 4), a transition after every block but the last
  (BN, ReLU, 1x1 conv to `compression` times the width, a 2/s2 average
  pool that drops an odd last row), a final BN + ReLU, global average
  pooling, dropout and a linear classifier;
- each dense layer: BN -> ReLU -> 1x1 conv to 4g -> BN -> ReLU -> a
  dilated depthwise 3x3(x3) conv (``groups`` = 4g) -> 1x1 conv to g, and
  its output concatenated after its input on the channel axis.

Public layout is channels-last ((B, X, Y, Z, C), or (B, H, W, C) in 2-D),
as in the TPU package; inside, the layers work on channels-first tensors.
``compute_dtype`` selects the forward's precision: float32, or bf16
autocast over float32 parameters (the TPU package's default); logits are
float32 either way.

Parameter names (`densenet_name_map` in utils/torch_weights.py pairs them
with the flax module names): `conv0` / `norm0` the stem; `block{b}.{i}.
{norm1, conv1, norm2, conv2, conv3}` the dense layers (conv2 the depthwise
conv); `transition{b}.{norm, conv}`; `norm_final`;
`classifier`. Initialization follows flax's defaults (lecun_normal kernels
from `generator`, zero biases, BN scale 1 and bias 0), though not its
draws. The BatchNorms keep flax's biased running variance
(`FlaxBatchNorm3d` / `FlaxBatchNorm2d`, eps 1e-5, flax momentum 0.9);
dropout draws from `GeneratorDropout`'s generator.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .resnet3d import FlaxBatchNorm2d, FlaxBatchNorm3d, GeneratorDropout
from .unet3d import _autocast, _check_dtype, _flax_init_

_LAYERS = {2: (nn.Conv2d, FlaxBatchNorm2d, nn.MaxPool2d, nn.AvgPool2d),
           3: (nn.Conv3d, FlaxBatchNorm3d, nn.MaxPool3d, nn.AvgPool3d)}


def _bn(k: int, c: int) -> nn.Module:
    # eps 1e-5 as in the TPU package; torch momentum 0.1 == flax momentum 0.9
    return _LAYERS[k][1](c, eps=1e-5, momentum=0.1)


class DenseLayer(nn.Module):
    def __init__(self, in_features: int, growth: int, dilation: int = 1,
                 spatial_dims: int = 3):
        super().__init__()
        conv = _LAYERS[spatial_dims][0]
        bottleneck = 4 * growth
        self.norm1 = _bn(spatial_dims, in_features)
        self.conv1 = conv(in_features, bottleneck, 1, bias=False)
        self.norm2 = _bn(spatial_dims, bottleneck)
        self.conv2 = conv(bottleneck, bottleneck, 3, padding=dilation, dilation=dilation,
                          groups=bottleneck, bias=False)
        self.conv3 = conv(bottleneck, growth, 1, bias=False)

    def forward(self, x):
        y = self.conv1(torch.relu(self.norm1(x)))
        y = self.conv3(self.conv2(torch.relu(self.norm2(y))))
        return torch.cat([x, y], dim=1)


class Transition(nn.Module):
    def __init__(self, in_features: int, out_features: int, spatial_dims: int = 3):
        super().__init__()
        conv, _, _, avg_pool = _LAYERS[spatial_dims]
        self.norm = _bn(spatial_dims, in_features)
        self.conv = conv(in_features, out_features, 1, bias=False)
        self.pool = avg_pool(2, 2)

    def forward(self, x):
        return self.pool(self.conv(torch.relu(self.norm(x))))


class DilatedDenseNet(nn.Module):
    """DenseNet classifier over 2-D slices or 3-D volumes."""

    def __init__(self, num_classes: int = 2, in_channels: int = 1, growth: int = 16,
                 block_config: Sequence[int] = (6, 12, 24, 16),
                 dilations: Sequence[int] = (1, 1, 2, 4), init_features: int = 64,
                 compression: float = 0.5, spatial_dims: int = 3,
                 dropout_rate: float = 0.2, compute_dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None):
        super().__init__()
        if spatial_dims not in _LAYERS:
            raise ValueError(f"spatial_dims must be 2 or 3, got {spatial_dims}")
        self.in_channels = in_channels
        self.spatial_dims = k = spatial_dims
        self.compute_dtype = _check_dtype(compute_dtype)
        conv, _, max_pool, _ = _LAYERS[k]
        self.conv0 = conv(in_channels, init_features, 7, stride=2, padding=3, bias=False)
        self.norm0 = _bn(k, init_features)
        self.pool0 = max_pool(3, 2, 1)

        features = init_features
        for bi, (n_layers, dilation) in enumerate(zip(block_config, dilations)):
            layers = []
            for _ in range(n_layers):
                layers.append(DenseLayer(features, growth, dilation, k))
                features += growth
            setattr(self, f"block{bi}", nn.Sequential(*layers))
            if bi != len(block_config) - 1:
                out = int(features * compression)
                setattr(self, f"transition{bi}", Transition(features, out, k))
                features = out
        self.num_blocks = len(block_config)
        self.norm_final = _bn(k, features)
        self.dropout = GeneratorDropout(dropout_rate)
        self.classifier = nn.Linear(features, num_classes)
        _flax_init_(self, generator)

    def forward(self, x):
        """(B, *spatial, C) -> logits (B, classes) float32."""
        if x.shape[-1] != self.in_channels:
            raise ValueError(f"input has {x.shape[-1]} channels, model declares "
                             f"in_channels={self.in_channels}")
        x = torch.movedim(x, -1, 1)
        if self.compute_dtype == torch.float32:
            x = x.to(torch.float32)
        with _autocast(x, self.compute_dtype):
            x = self.pool0(torch.relu(self.norm0(self.conv0(x))))
            for bi in range(self.num_blocks):
                x = getattr(self, f"block{bi}")(x)
                if bi != self.num_blocks - 1:
                    x = getattr(self, f"transition{bi}")(x)
            x = torch.relu(self.norm_final(x))
            x = x.mean(dim=tuple(range(2, 2 + self.spatial_dims)))  # GAP
            return self.classifier(self.dropout(x)).float()


def densenet_3d(num_classes=2, in_channels=1, **kw):
    return DilatedDenseNet(num_classes=num_classes, in_channels=in_channels,
                           spatial_dims=3, **kw)


def densenet_2d(num_classes=2, in_channels=3, **kw):
    """2-D variant (the reference's original 3-channel surface)."""
    return DilatedDenseNet(num_classes=num_classes, in_channels=in_channels,
                           spatial_dims=2, **kw)
