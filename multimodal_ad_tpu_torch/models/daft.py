"""DAFT: the Dynamic Affine Feature Map Transform for image + table fusion
(port of the TPU package's models/daft.py; arXiv:2107.05990).

The clinical-table vector conditions a late convolutional block: an
auxiliary MLP maps [global mean of the block's second conv output, table]
through a bottleneck of max(4, width // 7) units to a per-channel scale
and shift, and the block computes relu((1 + scale) * F + shift +
residual).

`DAFTResNet`: the 3-D ResNet stem (7^3/s2 conv, BN, ReLU, 3^3/s2 max
pool), three stages of `models/resnet3d.py` BasicBlocks at 64 (stride 1),
128 (stride 2) and 256 (stride 1, dilation 2) planes, then a DAFT block
opening the last stage at 512 planes (stride 1, dilation 4) and
``layers[3] - 1`` more BasicBlocks there; global mean, dropout, linear.

Precision as the TPU package's: with ``compute_dtype=torch.bfloat16`` the
network runs under bf16 autocast over float32 parameters; the block's
pooled mean is taken in bf16 and then cast to float32, the auxiliary MLP
runs in float32 with autocast off, and its scale and shift are cast back
to bf16 before they touch the feature map. Layout channels-last (B, X,
Y, Z, C); logits float32. Initialization follows flax's: the stem conv
and the Dense layers LeCun-normal, the blocks' convs variance_scaling(2,
fan_out, truncated normal), zero biases (drawn from `generator`). The
table's width is given (`table_dim`).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .resnet3d import BasicBlock, GeneratorDropout, _bn, _conv
from .unet3d import _TRUNC_STD, _autocast, _check_dtype, _flax_init_


class DAFTBlock(nn.Module):
    """Residual block whose second conv output F is modulated as
    (1 + scale) * F + shift, (scale, shift) predicted from [GAP(F), table]."""

    def __init__(self, inplanes: int, planes: int, table_dim: int, stride: int = 1,
                 dilation: int = 1, bottleneck_factor: int = 7):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, dilation)
        self.bn1 = _bn(planes)
        self.conv2 = _conv(planes, planes, 3, 1, dilation)
        self.bn2 = _bn(planes)
        hidden = max(4, (planes + table_dim) // bottleneck_factor)
        self.aux_hidden = nn.Linear(planes + table_dim, hidden)
        self.aux_out = nn.Linear(hidden, 2 * planes)
        self.downsample = (nn.Sequential(_conv(inplanes, planes, 1, stride), _bn(planes))
                           if stride != 1 or inplanes != planes else None)

    def forward(self, x, table):
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        pooled = out.mean(dim=(2, 3, 4)).float()  # in the compute dtype, then cast
        with torch.autocast(device_type=x.device.type, enabled=False):
            h = F.relu(self.aux_hidden(torch.cat([pooled, table.float()], -1)))
            scale, shift = self.aux_out(h).chunk(2, dim=-1)
        out = (out * (1.0 + scale)[:, :, None, None, None].to(out.dtype)
               + shift[:, :, None, None, None].to(out.dtype))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class DAFTResNet(nn.Module):
    """ResNet-ish 3-D backbone with a DAFT block opening the last stage."""

    STAGES = ((64, 1, 1), (128, 2, 1), (256, 1, 2))  # planes, stride, dilation

    def __init__(self, num_classes: int = 2, layers: Sequence[int] = (1, 1, 1, 1),
                 dropout_rate: float = 0.3, table_dim: int = 1, in_channels: int = 1,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.compute_dtype = _check_dtype(compute_dtype)
        self.conv1 = nn.Conv3d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        inplanes = 64
        for si, ((planes, stride, dilation), n) in enumerate(zip(self.STAGES, layers)):
            blocks = [BasicBlock(inplanes if bi == 0 else planes, planes,
                                 stride if bi == 0 else 1, dilation) for bi in range(n)]
            inplanes = planes
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))
        self.daft = DAFTBlock(inplanes, 512, table_dim, stride=1, dilation=4)
        self.layer4 = nn.Sequential(*[BasicBlock(512, 512, 1, 4) for _ in range(layers[3] - 1)])
        self.dropout = GeneratorDropout(dropout_rate)
        self.fc = nn.Linear(512, num_classes)
        _flax_init_(self, generator)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (BasicBlock, DAFTBlock)):
                    for conv in m.modules():
                        if isinstance(conv, nn.Conv3d):  # ConvBN's variance_scaling(2, fan_out)
                            fan_out = conv.weight.shape[0] * conv.weight[0, 0].numel()
                            std = math.sqrt(2.0 / fan_out) / _TRUNC_STD
                            nn.init.trunc_normal_(conv.weight, std=std, a=-2 * std, b=2 * std,
                                                  generator=generator)

    def forward(self, image, table):
        x = image.permute(0, 4, 1, 2, 3)
        if self.compute_dtype == torch.float32:
            x = x.float()
        with _autocast(x, self.compute_dtype):
            x = F.max_pool3d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
            x = self.layer3(self.layer2(self.layer1(x)))
            x = self.layer4(self.daft(x, table))
            x = self.fc(self.dropout(x.mean(dim=(2, 3, 4))))
        return x.float()
