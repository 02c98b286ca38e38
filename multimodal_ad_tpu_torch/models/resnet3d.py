"""3D ResNet family (MedicalNet-style), port of the TPU package's
models/resnet3d.py.

- conv 7x7x7 stride 2 stem -> BN -> ReLU -> 3x3x3 stride-2 max pool,
- 4 stages at 64/128/256/512 planes; stage 3 stride 1 dilation 2, stage 4
  stride 1 dilation 4,
- BasicBlock (expansion 1) / Bottleneck (expansion 4),
- shortcut 'A' (strided 1x1x1 avg pool + zero channel pad) or 'B' (1x1 conv
  + BN),
- heads: 'classifier' (the reference's swapped-in conv_seg: AdaptiveAvgPool3d,
  Flatten, Dropout, Linear), 'pool' (GAP embedding) and 'none' (layer4
  feature map). The transposed-conv 'seg' head is not ported yet.

Parameters carry MedicalNet names (conv1, bn1, layerK.J.convI / bnI,
layerK.J.downsample.0/1, conv_seg.3), so utils/torch_weights.py's name map
fixes the state_dict key set. The TPU package's space-to-depth stem computes
the same convolution from the same (7,7,7,C,64) parameter; here the stem is
a plain Conv3d and cuDNN picks its algorithm.

Public forward takes the channels-last (B, X, Y, Z, C) layout and works in
NCDHW inside. With ``compute_dtype=torch.bfloat16`` the forward runs under
bf16 autocast over fp32 parameters, as the TPU package's default does.

Training semantics held to the TPU package's flax modules:

- `FlaxBatchNorm3d` keeps the *biased* batch variance in `running_var`, as
  flax does (torch's stock BatchNorm keeps the unbiased one);
- `GeneratorDropout` draws its mask from an explicit `torch.Generator`
  (set by `set_dropout_generator`), so a training run's masks follow its
  seed and not the global RNG. The draws differ from the TPU package's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

DEPTH_BLOCKS = {
    10: ("basic", (1, 1, 1, 1)),
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
    200: ("bottleneck", (3, 24, 36, 3)),
}
# Classifier-head input width = 512 * expansion. The reference's map lists
# depth 10 as 256, which is wrong for its own BasicBlock[1,1,1,1]
# architecture; corrected to 512, as in the TPU package.
FC_IN = {10: 512, 18: 512, 34: 512, 50: 2048, 101: 2048, 152: 2048, 200: 2048}
STAGES = ((64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4))  # planes, stride, dilation
HEADS = ("classifier", "pool", "none")


def _conv(cin: int, cout: int, kernel: int, stride: int = 1,
          dilation: int = 1) -> nn.Conv3d:
    return nn.Conv3d(cin, cout, kernel, stride,
                     padding=dilation * (kernel - 1) // 2, dilation=dilation,
                     bias=False)


class FlaxBatchNorm3d(nn.BatchNorm3d):
    """BatchNorm3d whose running variance takes the biased batch variance,
    as flax's BatchNorm does (the TPU package's models/resnet3d.py:111-117).

    The stock train-mode call blends the unbiased variance u into
    `running_var` with factor f (the momentum, or 1/num_batches_tracked
    with ``momentum=None``): new = (1 - f) * old + f * u. The update f * u
    is then rescaled by (n - 1) / n, n = B * D * H * W, one elementwise op
    on C values; the activations are not read again. Eval mode and the
    state_dict are the stock module's."""

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        # the stock op updates a copy; the result is a new buffer tensor, as
        # autograd keeps the updated one for the backward
        old = self.running_var
        self.running_var = old.clone()
        out = super().forward(x)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            f = (1.0 / float(self.num_batches_tracked) if self.momentum is None
                 else self.momentum)
            keep = old * (1.0 - f)  # new - keep = f * u
            self.running_var = keep.lerp_(self.running_var, (n - 1) / n)
        return out


def _bn(c: int) -> nn.BatchNorm3d:
    # eps 1e-5 as in the TPU package; torch momentum 0.1 == flax momentum 0.9
    return FlaxBatchNorm3d(c, eps=1e-5, momentum=0.1)


class GeneratorDropout(nn.Dropout):
    """Dropout whose mask comes from `self.generator` (a torch.Generator on
    the input's device) when one is set, else from the global RNG. Keeps
    each element with probability 1 - p and scales it by 1 / (1 - p), as
    flax's Dropout does."""

    generator: torch.Generator | None = None

    def forward(self, x):
        if not self.training or self.p == 0.0 or self.generator is None:
            return super().forward(x)
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


def set_dropout_generator(model: nn.Module, generator: torch.Generator | None):
    """Give every GeneratorDropout of `model` the generator `generator`."""
    for m in model.modules():
        if isinstance(m, GeneratorDropout):
            m.generator = generator


class ShortcutA(nn.Module):
    """Parameter-free shortcut: strided 1x1x1 avg pool + zero channel pad."""

    def __init__(self, out_features: int, stride: int):
        super().__init__()
        self.out_features = out_features
        self.stride = stride

    def forward(self, x):
        if self.stride != 1:
            s = self.stride
            x = x[:, :, ::s, ::s, ::s]
        pad = self.out_features - x.shape[1]
        if pad > 0:
            x = F.pad(x, (0, 0, 0, 0, 0, 0, 0, pad))
        return x


def _shortcut(shortcut_type: str, cin: int, cout: int, stride: int):
    if shortcut_type == "A":
        return ShortcutA(cout, stride)
    return nn.Sequential(_conv(cin, cout, 1, stride), _bn(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, shortcut_type: str = "B"):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, dilation)
        self.bn1 = _bn(planes)
        self.conv2 = _conv(planes, planes, 3, 1, dilation)
        self.bn2 = _bn(planes)
        self.downsample = (_shortcut(shortcut_type, inplanes, planes, stride)
                           if stride != 1 or inplanes != planes else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, shortcut_type: str = "B"):
        super().__init__()
        out_features = planes * 4
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = _bn(planes)
        self.conv2 = _conv(planes, planes, 3, stride, dilation)
        self.bn2 = _bn(planes)
        self.conv3 = _conv(planes, out_features, 1)
        self.bn3 = _bn(out_features)
        self.downsample = (
            _shortcut(shortcut_type, inplanes, out_features, stride)
            if stride != 1 or inplanes != out_features else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class ResNet3D(nn.Module):
    """3D ResNet backbone with a selectable head (see module docstring)."""

    def __init__(self, depth: int = 18, num_classes: int = 2,
                 in_channels: int = 1, shortcut_type: str = "B",
                 head: str = "classifier", dropout_rate: float = 0.5,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None):
        super().__init__()
        if depth not in DEPTH_BLOCKS:
            raise ValueError(f"unsupported depth {depth}")
        if head not in HEADS:
            raise ValueError(f"head={head!r} is not ported; choose from {HEADS}")
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"unsupported compute_dtype {compute_dtype}")
        self.depth = depth
        self.num_classes = num_classes
        self.in_channels = in_channels
        self.shortcut_type = shortcut_type
        self.head = head
        self.compute_dtype = compute_dtype

        kind, layers = DEPTH_BLOCKS[depth]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.conv1 = nn.Conv3d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        self.maxpool = nn.MaxPool3d(3, 2, 1)
        inplanes = 64
        for si, ((planes, stride, dilation), n_blocks) in enumerate(
                zip(STAGES, layers)):
            blocks = []
            for bi in range(n_blocks):
                blocks.append(block(inplanes, planes,
                                    stride if bi == 0 else 1, dilation,
                                    shortcut_type))
                inplanes = planes * block.expansion
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))
        if head == "classifier":
            self.conv_seg = nn.Sequential(
                nn.AdaptiveAvgPool3d(1), nn.Flatten(),
                GeneratorDropout(dropout_rate),
                nn.Linear(FC_IN[depth], num_classes))

        # `generator` (a CPU torch.Generator) makes the draws a seed's own
        for m in self.modules():
            if isinstance(m, nn.Conv3d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                        nonlinearity="relu", generator=generator)
            elif isinstance(m, nn.Linear) and generator is not None:
                # nn.Linear's own init, drawn from the generator
                bound = 1.0 / m.in_features ** 0.5
                nn.init.kaiming_uniform_(m.weight, a=5 ** 0.5, generator=generator)
                nn.init.uniform_(m.bias, -bound, bound, generator=generator)

    def features(self, x):
        """NCDHW input -> layer4 feature map (NCDHW)."""
        x = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))

    def forward(self, x):
        """(B, X, Y, Z, C) -> logits (B, classes) f32 for 'classifier',
        (B, 512 * expansion) f32 for 'pool', the (B, X', Y', Z', F) layer4
        map for 'none'."""
        if x.shape[-1] != self.in_channels:
            raise ValueError(
                f"input has {x.shape[-1]} channels, model declares "
                f"in_channels={self.in_channels}")
        x = x.permute(0, 4, 1, 2, 3)
        bf16 = self.compute_dtype == torch.bfloat16
        if not bf16:
            x = x.to(torch.float32)
        with torch.autocast(device_type=x.device.type, dtype=torch.bfloat16,
                            enabled=bf16):
            feats = self.features(x)
            if self.head == "none":
                return feats.permute(0, 2, 3, 4, 1)
            if self.head == "pool":
                return feats.float().mean(dim=(2, 3, 4))
            return self.conv_seg(feats).float()


def image_encoder(depth=18, in_channels=1, shortcut_type="B",
                  global_pool=False, **kw):
    """Headless encoder: 'pool' head with global_pool, else 'none'."""
    return ResNet3D(depth=depth, in_channels=in_channels,
                    shortcut_type=shortcut_type,
                    head="pool" if global_pool else "none", **kw)


def generate_model(model_type="resnet", model_depth=18, resnet_shortcut="B",
                   nb_class=2, dropout_rate=0.5, in_channels=1,
                   compute_dtype=torch.bfloat16, param_dtype=torch.float32,
                   generator: torch.Generator | None = None, **_ignored):
    """Config-driven factory. Parameters are created in `param_dtype`
    (float32); `compute_dtype` selects the autocast type of the forward;
    `generator` draws the initial weights."""
    if model_type != "resnet":
        raise ValueError(f"unsupported model_type {model_type!r}")
    if model_depth not in DEPTH_BLOCKS:
        raise ValueError(f"unsupported depth {model_depth}")
    model = ResNet3D(depth=model_depth, num_classes=nb_class,
                     in_channels=in_channels, shortcut_type=resnet_shortcut,
                     head="classifier", dropout_rate=dropout_rate,
                     compute_dtype=compute_dtype, generator=generator)
    return model.to(dtype=param_dtype)
