"""3-D U-Nets (port of the TPU package's models/unet3d.py).

`UNet3D`, for segmentation, atlas-ROI features and the denoising
autoencoder:

- a 3-level encoder (64/128/256 by default) and a 512 bottleneck, each a
  double 3x3x3 conv with BatchNorm and ReLU, the first conv at half width;
- three up-blocks: a 2x2x2 stride-2 transposed conv at the block's input
  width, concatenation with the skip, then a double conv at half width;
  the last (`head_block`) ends in a 1x1x1 conv to `num_classes`;
- odd inputs are padded right/bottom to a multiple of 8 and cropped back
  (91x109x91 runs as 96x112x96).

`forward(x, return_features=True)` also returns the 64-channel map of
`head_block` before its head conv, cropped to the input: the source of
atlas ROI pooling. It takes the place of the TPU package's `sow` tap.

`UNet3DClassifier`, the single-split classifier: a 4-level encoder (base
32: 32/64/128/256) and a 16x-base bottleneck, each a double conv at
constant width; max-pool 2 in floor mode (91 -> 45 -> 22 -> 11 -> 5); four
up steps, each a 2x2x2 stride-2 transposed conv, a centre pad to the
skip's size (diff // 2 before, the rest after) and the concatenation
``[skip, x]`` (the skip first, the reverse of `UNet3D`'s up-blocks), then a
double conv; global average pooling and a linear layer.

Public layout is channels-last (B, X, Y, Z, C), as in models/resnet3d.py;
inside, the layers work on NCDHW tensors. ``compute_dtype`` selects the
forward's precision: float32, or bf16 autocast over fp32 parameters as
the TPU package's default; outputs are float32 either way. `UNet3D`
defaults to float32 (what extraction runs), `UNet3DClassifier` to bf16.

Initialization follows flax's defaults, so an untrained network (what
feature extraction runs) has the TPU package's weight statistics, though
not its draws: conv, transposed-conv and dense kernels lecun_normal (a
normal truncated at two standard deviations, std sqrt(1/fan_in) /
0.8796...), zero biases, BatchNorm scale 1, bias 0, mean 0, var 1 (eps
1e-5). The BatchNorms are `FlaxBatchNorm3d`: in training they keep
flax's biased running variance.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .resnet3d import FlaxBatchNorm3d

# std of a unit normal truncated to [-2, 2]; flax's variance_scaling divides by it
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator=None) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


def _bn(c: int) -> FlaxBatchNorm3d:
    # eps 1e-5 as flax's default; torch momentum 0.1 == flax momentum 0.9
    return FlaxBatchNorm3d(c, eps=1e-5, momentum=0.1)


@torch.no_grad()
def _flax_init_(model: nn.Module, generator: torch.Generator | None) -> None:
    """flax-default initialization of every conv, transposed conv, linear
    layer and BatchNorm of `model` (2-D or 3-D), drawn from `generator`."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear)):
            # in / groups * kernel volume; in for a linear
            fan_in = m.weight[0].numel()
        elif isinstance(m, nn.ConvTranspose3d):
            fan_in = m.weight.shape[0] * m.weight[0, 0].numel()
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
            continue
        else:
            continue
        _lecun_normal_(m.weight, fan_in, generator)
        if m.bias is not None:
            nn.init.zeros_(m.bias)


def _check_dtype(compute_dtype: torch.dtype) -> torch.dtype:
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported compute_dtype {compute_dtype}")
    return compute_dtype


def _autocast(x: torch.Tensor, compute_dtype: torch.dtype):
    return torch.autocast(device_type=x.device.type, dtype=torch.bfloat16,
                          enabled=compute_dtype == torch.bfloat16)


class ConvBlock3D(nn.Module):
    """Double 3x3x3 conv + BN + ReLU; with `halved_first` the first conv
    has `features // 2` outputs."""

    def __init__(self, in_features: int, features: int, halved_first: bool = True):
        super().__init__()
        mid = features // 2 if halved_first else features
        self.conv1 = nn.Conv3d(in_features, mid, 3, padding=1)
        self.bn1 = _bn(mid)
        self.conv2 = nn.Conv3d(mid, features, 3, padding=1)
        self.bn2 = _bn(features)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(x)))


class UpBlock3D(nn.Module):
    """2x2x2 stride-2 transposed conv at `in_features`, skip concat, double
    conv to `in_features // 2`; with `num_classes` a 1x1x1 head conv."""

    def __init__(self, in_features: int, skip_features: int,
                 num_classes: int | None = None):
        super().__init__()
        mid = in_features // 2
        self.upconv = nn.ConvTranspose3d(in_features, in_features, 2, stride=2)
        self.conv1 = nn.Conv3d(in_features + skip_features, mid, 3, padding=1)
        self.bn1 = _bn(mid)
        self.conv2 = nn.Conv3d(mid, mid, 3, padding=1)
        self.bn2 = _bn(mid)
        self.head = nn.Conv3d(mid, num_classes, 1) if num_classes else None

    def forward(self, x, residual):
        """-> (features before the head, head output or None)."""
        x = torch.cat([self.upconv(x), residual], dim=1)
        x = F.relu(self.bn1(self.conv1(x)))
        feats = F.relu(self.bn2(self.conv2(x)))
        return feats, (self.head(feats) if self.head is not None else None)


def _pad_to_multiple(x: torch.Tensor, mult: int = 8):
    """Pad the spatial dims of an NCDHW tensor on the right/bottom to a
    multiple of `mult`; returns (padded, original spatial sizes)."""
    crops = list(x.shape[2:5])
    pads = []
    for d in reversed(crops):  # F.pad lists the last dim first
        pads += [0, (-d) % mult]
    return F.pad(x, pads), crops


def _crop_back(y: torch.Tensor, crops) -> torch.Tensor:
    return y[:, :, :crops[0], :crops[1], :crops[2]]


class UNet3D(nn.Module):
    """3-level U-Net; returns the segmentation map and, on request, the
    pre-head feature map for ROI pooling (see the module docstring)."""

    def __init__(self, in_channels: int = 1, num_classes: int = 1,
                 level_channels=(64, 128, 256), bottleneck_channel: int = 512,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        c1, c2, c3 = level_channels
        self.in_channels = in_channels
        self.compute_dtype = _check_dtype(compute_dtype)
        self.enc1 = ConvBlock3D(in_channels, c1)
        self.enc2 = ConvBlock3D(c1, c2)
        self.enc3 = ConvBlock3D(c2, c3)
        self.bottleneck = ConvBlock3D(c3, bottleneck_channel)
        self.dec3 = UpBlock3D(bottleneck_channel, c3)
        self.dec2 = UpBlock3D(c3, c2)
        self.head_block = UpBlock3D(c2, c1, num_classes=num_classes)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """flax-default initialization, drawn from `generator`."""
        _flax_init_(self, generator)

    def forward(self, x: torch.Tensor, return_features: bool = False):
        """(B, X, Y, Z, C) -> (B, X, Y, Z, num_classes) float32, and with
        `return_features` also the (B, X, Y, Z, c1) pre-head map (float32)."""
        if x.shape[-1] != self.in_channels:
            raise ValueError(f"input has {x.shape[-1]} channels, model declares "
                             f"in_channels={self.in_channels}")
        x, crops = _pad_to_multiple(x.permute(0, 4, 1, 2, 3).to(torch.float32))
        with _autocast(x, self.compute_dtype):
            r1 = self.enc1(x)
            r2 = self.enc2(F.max_pool3d(r1, 2))
            r3 = self.enc3(F.max_pool3d(r2, 2))
            b = self.bottleneck(F.max_pool3d(r3, 2))
            y, _ = self.dec3(b, r3)
            y, _ = self.dec2(y, r2)
            feats, out = self.head_block(y, r1)
        out = _crop_back(out, crops).permute(0, 2, 3, 4, 1).float()
        if not return_features:
            return out
        return out, _crop_back(feats, crops).permute(0, 2, 3, 4, 1).float()


class UNetClassifierConvBlock(nn.Module):
    """Double 3x3x3 conv at constant width, each followed by BN and ReLU."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.conv1 = nn.Conv3d(in_features, features, 3, padding=1)
        self.bn1 = _bn(features)
        self.conv2 = nn.Conv3d(features, features, 3, padding=1)
        self.bn2 = _bn(features)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(x)))


def _center_pad_to(x: torch.Tensor, target) -> torch.Tensor:
    """Pad the spatial dims of an NCDHW tensor to `target`, diff // 2 before
    and the rest after (torch F.pad's centring, as the reference's)."""
    pads = []
    for d, t in reversed(list(zip(x.shape[2:5], target))):  # last dim first
        diff = t - d
        pads += [diff // 2, diff - diff // 2]
    return F.pad(x, pads)


class UNetClassifierUp(nn.Module):
    """2x2x2 stride-2 transposed conv to `features`, centre pad to the
    skip's size, ``cat([skip, x])``, double conv at `features`."""

    def __init__(self, in_features: int, skip_features: int, features: int):
        super().__init__()
        self.upconv = nn.ConvTranspose3d(in_features, features, 2, stride=2)
        self.block = UNetClassifierConvBlock(skip_features + features, features)

    def forward(self, x, skip):
        x = _center_pad_to(self.upconv(x), skip.shape[2:5])
        return self.block(torch.cat([skip, x.to(skip.dtype)], dim=1))


class UNet3DClassifier(nn.Module):
    """4-level U-Net classifier: decode to full resolution, global average
    pooling, linear (see the module docstring). (B, X, Y, Z, C) -> logits
    (B, num_classes) float32."""

    def __init__(self, in_channels: int = 1, num_classes: int = 2,
                 base_ch: int = 32, compute_dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None):
        super().__init__()
        bc = base_ch
        self.in_channels = in_channels
        self.num_classes = num_classes
        self.compute_dtype = _check_dtype(compute_dtype)
        self.enc1 = UNetClassifierConvBlock(in_channels, bc)
        self.enc2 = UNetClassifierConvBlock(bc, 2 * bc)
        self.enc3 = UNetClassifierConvBlock(2 * bc, 4 * bc)
        self.enc4 = UNetClassifierConvBlock(4 * bc, 8 * bc)
        self.bottleneck = UNetClassifierConvBlock(8 * bc, 16 * bc)
        self.up4 = UNetClassifierUp(16 * bc, 8 * bc, 8 * bc)
        self.up3 = UNetClassifierUp(8 * bc, 4 * bc, 4 * bc)
        self.up2 = UNetClassifierUp(4 * bc, 2 * bc, 2 * bc)
        self.up1 = UNetClassifierUp(2 * bc, bc, bc)
        self.fc = nn.Linear(bc, num_classes)
        _flax_init_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.in_channels:
            raise ValueError(f"input has {x.shape[-1]} channels, model declares "
                             f"in_channels={self.in_channels}")
        x = x.permute(0, 4, 1, 2, 3).to(torch.float32)
        with _autocast(x, self.compute_dtype):
            e1 = self.enc1(x)
            e2 = self.enc2(F.max_pool3d(e1, 2))
            e3 = self.enc3(F.max_pool3d(e2, 2))
            e4 = self.enc4(F.max_pool3d(e3, 2))
            b = self.bottleneck(F.max_pool3d(e4, 2))
            d = self.up1(self.up2(self.up3(self.up4(b, e4), e3), e2), e1)
            return self.fc(d.float().mean(dim=(2, 3, 4))).float()
