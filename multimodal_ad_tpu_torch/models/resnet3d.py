"""3D ResNet family (MedicalNet-style), port of the TPU package's
models/resnet3d.py.

- conv 7x7x7 stride 2 stem -> BN -> ReLU -> 3x3x3 stride-2 max pool,
- 4 stages at 64/128/256/512 planes; stage 3 stride 1 dilation 2, stage 4
  stride 1 dilation 4,
- BasicBlock (expansion 1) / Bottleneck (expansion 4),
- shortcut 'A' (strided 1x1x1 avg pool + zero channel pad) or 'B' (1x1 conv
  + BN),
- heads: 'classifier' (the reference's swapped-in conv_seg: AdaptiveAvgPool3d,
  Flatten, Dropout, Linear), 'seg' (MedicalNet's segmentation head: a 2^3
  stride-2 transposed conv with bias to 32 channels, BN, ReLU, a 3^3 conv
  without bias, BN, ReLU, a 1^3 conv without bias to `num_seg_classes`;
  the TPU package's SegHead), 'pool' (GAP embedding) and 'none' (layer4
  feature map);
- `forward(x, return_taps=True)` also returns the four stage outputs,
  channels-last, in place of the TPU package's `sow`n 'stage_out' taps.

Parameters carry MedicalNet names (conv1, bn1, layerK.J.convI / bnI,
layerK.J.downsample.0/1; the classifier's Linear conv_seg.3; the seg
head's layers conv_seg.0 (transposed conv), .1 (BN), .3 (conv), .4 (BN)
and .6 (conv), .2 and .5 its ReLUs, as in MedicalNet's `conv_seg`), so
utils/torch_weights.py's name map fixes the state_dict key set and
`load_medicalnet_weights` transfers a pretrained seg head by key
intersection.

The stem (`StemConv`) is a Conv3d(C, 64, 7, stride 2, padding 3) whose
forward, as the TPU package's default, computes that convolution by
space-to-depth: the 2^3 input phases packed onto the channel axis and a
dense 4^3 stride-1 convolution over the half-resolution grid, its kernel
gathered from the 7^3 parameter on every call (`stem_s2d_weight`,
`stem_s2d_pack`). ``s2d_stem=False`` runs the plain convolution on the same
parameter; both give the same state_dict.

``remat=True`` rematerializes each residual block in training
(`torch.utils.checkpoint`, as the TPU package's `nn.remat` per block): the
block's activations are recomputed in the backward, and its BatchNorms then
normalize by the batch's statistics without updating their running ones
again (`recomputing`), so the statistics move once a step.

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

import contextlib
import functools
import threading

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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
HEADS = ("classifier", "seg", "pool", "none")


def _channels_first(x):
    return x.permute(0, 4, 1, 2, 3)


def _channels_last(x):
    return x.permute(0, 2, 3, 4, 1)


def max_pool_3d(x, window=3, stride=2, padding=1):
    """Max pool of a channels-last (B, X, Y, Z, C) tensor (-inf padding).
    Its backward is ATen's: each window's cotangent goes to one maximum,
    where ops/pool.py::max_pool_3d_fast splits it among tied maxima."""
    return _channels_last(F.max_pool3d(_channels_first(x), window, stride, padding))


def avg_pool_3d(x, window, stride, padding=0):
    """Average pool of a channels-last (B, X, Y, Z, C) tensor; the zero
    padding counts in each mean, as flax's `avg_pool` counts it."""
    return _channels_last(F.avg_pool3d(_channels_first(x), window, stride, padding))


def global_avg_pool(x):
    """(B, X, Y, Z, C) -> (B, C), the mean over the spatial axes."""
    return x.mean(dim=(1, 2, 3))


def _stem_s2d_index_map() -> np.ndarray:
    """Tap map of the space-to-depth stem: entry [td, th, tw, phase] is the
    flat index into the 7^3 kernel, or -1 where the phase has no tap.
    Output o of the 7^3 / stride 2 / pad 3 stem reads x[2o + k - 3]; with
    the input index written 2m + p (block m, phase p), k = 2t + p - 1 for
    tap t = m - o + 2 in [0, 4)."""
    idx = np.full((4, 4, 4, 8), -1, np.int64)
    for td in range(4):
        for th in range(4):
            for tw in range(4):
                for pd in range(2):
                    for ph in range(2):
                        for pw in range(2):
                            kd, kh, kw = 2 * td + pd - 1, 2 * th + ph - 1, 2 * tw + pw - 1
                            if all(0 <= k <= 6 for k in (kd, kh, kw)):
                                idx[td, th, tw, (pd * 2 + ph) * 2 + pw] = (kd * 7 + kh) * 7 + kw
    return idx


STEM_S2D_IDX = _stem_s2d_index_map()


@functools.lru_cache(maxsize=None)
def _stem_gather(device: torch.device) -> torch.Tensor:
    """STEM_S2D_IDX flattened, a missing tap pointing at slot 343 (a zero
    appended to the flat 7^3 kernel), on `device`; a normal tensor even
    when first asked for under inference mode, so autograd may save it."""
    with torch.inference_mode(False):
        return torch.as_tensor(np.where(STEM_S2D_IDX < 0, 343, STEM_S2D_IDX).reshape(-1),
                               device=device)


def stem_s2d_weight(w: torch.Tensor) -> torch.Tensor:
    """(F, C, 7, 7, 7) stem kernel -> the space-to-depth stem's (F, 8C, 4,
    4, 4) kernel, phase p of input channel c on channel p * C + c, zero
    where a phase has no tap. A gather: the gradient flows into `w`."""
    f, c = w.shape[:2]
    flat = F.pad(w.reshape(f, c, 343), (0, 1))[:, :, _stem_gather(w.device)]
    return flat.reshape(f, c, 4, 4, 4, 8).permute(0, 5, 1, 2, 3, 4).reshape(f, 8 * c, 4, 4, 4)


def stem_s2d_pack(x: torch.Tensor, pad_depth: bool = True) -> torch.Tensor:
    """(B, D, H, W, C) -> the space-to-depth stem's input: each odd extent
    padded by one plane, the 2^3 phases of each block on the channel axis
    (channel ((pd * 2 + ph) * 2 + pw) * C + c), and (2, 1) blocks of zeros
    before and after each spatial axis (the 4^3 conv's padding), as an
    NCDHW view (B, 8C, D // 2 + 3, ...) of a channels-last tensor. Without
    `pad_depth` D gets no blocks of zeros (a slab's window that already
    holds its halo: (B, 8C, ceil(D / 2), ...))."""
    b, d, h, w, c = x.shape
    dpad = (4, 2 + d % 2) if pad_depth else (0, d % 2)
    xp = F.pad(x, (0, 0, 4, 2 + w % 2, 4, 2 + h % 2, *dpad))
    dp, hp, wp = (n // 2 for n in xp.shape[1:4])
    xs = xp.reshape(b, dp, 2, hp, 2, wp, 2, c).permute(0, 1, 3, 5, 2, 4, 6, 7)
    return xs.reshape(b, dp, hp, wp, 8 * c).permute(0, 4, 1, 2, 3)


class StemConv(nn.Conv3d):
    """The stem's Conv3d(C, features, 7, stride 2, padding 3, no bias).
    With `s2d` its forward computes that convolution by space-to-depth, as
    the TPU package's StemConv does: the kernel gathered into (F, 8C, 4, 4,
    4) (`stem_s2d_weight`, under autocast from the cast kernel), the input
    packed (`stem_s2d_pack`, cast first under autocast) and a 4^3 stride-1
    F.conv3d. Without it, the plain convolution. The parameter is
    `weight` (F, C, 7, 7, 7) either way."""

    def __init__(self, in_channels: int, features: int = 64, s2d: bool = True):
        super().__init__(in_channels, features, 7, 2, 3, bias=False)
        self.s2d = s2d

    def forward(self, x):
        if not self.s2d:
            return super().forward(x)
        return self.s2d_conv(x)

    def s2d_conv(self, x, pad_depth: bool = True):
        """The space-to-depth convolution of NCDHW `x`; without `pad_depth`
        no zero blocks along D (`stem_s2d_pack`): valid there."""
        w = self.weight
        dev = x.device.type
        if torch.is_autocast_enabled(dev):
            dt = torch.get_autocast_dtype(dev)
            x, w = x.to(dt), w.to(dt)
        return F.conv3d(stem_s2d_pack(x.permute(0, 2, 3, 4, 1), pad_depth), stem_s2d_weight(w))


_RECOMPUTE = threading.local()


def recomputing() -> bool:
    """True while a rematerialized block recomputes its forward in the
    backward (on that thread): a BatchNorm then normalizes by the batch's
    statistics and leaves its running statistics as they are."""
    return getattr(_RECOMPUTE, "on", False)


@contextlib.contextmanager
def _recompute():
    _RECOMPUTE.on = True
    try:
        yield
    finally:
        _RECOMPUTE.on = False


def _remat_contexts():
    return contextlib.nullcontext(), _recompute()


def _remat_block(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """`block(x)` with its activations recomputed in the backward (no RNG
    replay: the blocks draw nothing)."""
    return checkpoint(block, x, use_reentrant=False, preserve_rng_state=False,
                      context_fn=_remat_contexts)


def _conv(cin: int, cout: int, kernel: int, stride: int = 1,
          dilation: int = 1) -> nn.Conv3d:
    return nn.Conv3d(cin, cout, kernel, stride,
                     padding=dilation * (kernel - 1) // 2, dilation=dilation,
                     bias=False)


class _FlaxRunningVar:
    """Mixin for a stock BatchNorm: its running variance takes the biased
    batch variance, as flax's BatchNorm does (the TPU package's
    models/resnet3d.py:111-117).

    The stock train-mode call blends the unbiased variance u into
    `running_var` with factor f (the momentum, or 1/num_batches_tracked
    with ``momentum=None``): new = (1 - f) * old + f * u. The update f * u
    is then rescaled by (n - 1) / n, n = the elements per channel (B * D *
    H * W, or B * H * W in 2-D), one elementwise op on C values; the
    activations are not read again. Eval mode and the state_dict are the
    stock module's."""

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        if recomputing():  # the stock call on throwaway copies of the statistics
            return F.batch_norm(x, self.running_mean.clone(), self.running_var.clone(),
                                self.weight, self.bias, True, 0.0, self.eps)
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


class FlaxBatchNorm3d(_FlaxRunningVar, nn.BatchNorm3d):
    """BatchNorm3d with flax's biased running variance (`_FlaxRunningVar`)."""


class FlaxBatchNorm2d(_FlaxRunningVar, nn.BatchNorm2d):
    """BatchNorm2d with flax's biased running variance (`_FlaxRunningVar`)."""


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
                 num_seg_classes: int = 1, compute_dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None, s2d_stem: bool = True,
                 remat: bool = False):
        super().__init__()
        if depth not in DEPTH_BLOCKS:
            raise ValueError(f"unsupported depth {depth}")
        if head not in HEADS:
            raise ValueError(f"unknown head {head!r}; choose from {HEADS}")
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"unsupported compute_dtype {compute_dtype}")
        self.depth = depth
        self.num_classes = num_classes
        self.in_channels = in_channels
        self.shortcut_type = shortcut_type
        self.head = head
        self.compute_dtype = compute_dtype
        self.remat = remat

        kind, layers = DEPTH_BLOCKS[depth]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.conv1 = StemConv(in_channels, 64, s2d=s2d_stem)
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
        elif head == "seg":
            self.conv_seg = nn.Sequential(
                nn.ConvTranspose3d(FC_IN[depth], 32, 2, stride=2),
                _bn(32), nn.ReLU(),
                _conv(32, 32, 3), _bn(32), nn.ReLU(),
                nn.Conv3d(32, num_seg_classes, 1, bias=False))

        # `generator` (a CPU torch.Generator) makes the draws a seed's own
        for m in self.modules():
            if isinstance(m, nn.Conv3d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                        nonlinearity="relu", generator=generator)
            elif isinstance(m, (nn.Linear, nn.ConvTranspose3d)) and generator is not None:
                # the layer's own init, drawn from the generator
                fan_in, _ = nn.init._calculate_fan_in_and_fan_out(m.weight)
                nn.init.kaiming_uniform_(m.weight, a=5 ** 0.5, generator=generator)
                nn.init.uniform_(m.bias, -fan_in ** -0.5, fan_in ** -0.5,
                                 generator=generator)

    def features(self, x, taps: list | None = None):
        """NCDHW input -> layer4 feature map (NCDHW); with a list `taps`,
        each stage's output is appended to it."""
        x = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        remat = self.remat and self.training and torch.is_grad_enabled()
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            if remat:
                for block in stage:
                    x = _remat_block(block, x)
            else:
                x = stage(x)
            if taps is not None:
                taps.append(x)
        return x

    def forward(self, x, return_taps: bool = False):
        """(B, X, Y, Z, C) -> logits (B, classes) f32 for 'classifier',
        the (B, 2X', 2Y', 2Z', num_seg_classes) map for 'seg' (in the
        compute dtype), (B, 512 * expansion) f32 for 'pool', the (B, X',
        Y', Z', F) layer4 map for 'none'. With `return_taps`, returns
        (output, taps): the four stage outputs, channels-last, in the
        compute dtype."""
        if x.shape[-1] != self.in_channels:
            raise ValueError(
                f"input has {x.shape[-1]} channels, model declares "
                f"in_channels={self.in_channels}")
        x = x.permute(0, 4, 1, 2, 3)
        bf16 = self.compute_dtype == torch.bfloat16
        if not bf16:
            x = x.to(torch.float32)
        taps = [] if return_taps else None
        with torch.autocast(device_type=x.device.type, dtype=torch.bfloat16,
                            enabled=bf16):
            feats = self.features(x, taps)
            if self.head == "none":
                out = feats.permute(0, 2, 3, 4, 1)
            elif self.head == "pool":
                out = feats.float().mean(dim=(2, 3, 4))
            elif self.head == "seg":
                out = self.conv_seg(feats).permute(0, 2, 3, 4, 1)
            else:
                out = self.conv_seg(feats).float()
        if return_taps:
            return out, [t.permute(0, 2, 3, 4, 1) for t in taps]
        return out


def _factory(depth: int):
    def make(**kw):
        return ResNet3D(depth=depth, **kw)
    make.__name__ = make.__qualname__ = f"resnet{depth}"
    make.__doc__ = f"3D ResNet-{depth}: ``ResNet3D(depth={depth}, **kw)``."
    return make


resnet10 = _factory(10)
resnet18 = _factory(18)
resnet34 = _factory(34)
resnet50 = _factory(50)
resnet101 = _factory(101)
resnet152 = _factory(152)
resnet200 = _factory(200)


def image_encoder(depth=18, in_channels=1, shortcut_type="B",
                  global_pool=False, **kw):
    """Headless encoder: 'pool' head with global_pool, else 'none'."""
    return ResNet3D(depth=depth, in_channels=in_channels,
                    shortcut_type=shortcut_type,
                    head="pool" if global_pool else "none", **kw)


def generate_model(model_type="resnet", model_depth=18, resnet_shortcut="B",
                   nb_class=2, dropout_rate=0.5, in_channels=1,
                   compute_dtype=torch.bfloat16, param_dtype=torch.float32,
                   generator: torch.Generator | None = None, s2d_stem: bool = True,
                   **_ignored):
    """Config-driven factory. Parameters are created in `param_dtype`
    (float32); `compute_dtype` selects the autocast type of the forward;
    `generator` draws the initial weights; `s2d_stem` picks the stem's
    form (`StemConv`), the parameters the same either way. Like the TPU
    package's factory it takes no `remat`: that falls into `_ignored`."""
    if model_type != "resnet":
        raise ValueError(f"unsupported model_type {model_type!r}")
    if model_depth not in DEPTH_BLOCKS:
        raise ValueError(f"unsupported depth {model_depth}")
    model = ResNet3D(depth=model_depth, num_classes=nb_class,
                     in_channels=in_channels, shortcut_type=resnet_shortcut,
                     head="classifier", dropout_rate=dropout_rate,
                     compute_dtype=compute_dtype, generator=generator,
                     s2d_stem=s2d_stem)
    return model.to(dtype=param_dtype)
