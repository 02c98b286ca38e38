"""Plain float32 reference of the MedicalNet 3-D ResNet (Chen et al.,
arXiv:1904.00625; Tencent/MedicalNet models/resnet.py) as the benchmark's
configurations state it, written from the published description.

- stem: Conv3d(C, 64, 7, stride 2, padding 3, no bias), BatchNorm, ReLU,
  MaxPool3d(3, 2, 1): the plain 7^3 convolution whatever stem the program
  runs;
- four stages of 64/128/256/512 planes, strides 1/2/1/1, dilations
  1/1/2/4; BasicBlock (expansion 1) or Bottleneck (expansion 4);
  shortcut 'B' (1^3 conv + BatchNorm) where the shape changes;
- head: global average pool, dropout, Linear (MedicalNet's swapped-in
  classifier, named conv_seg.3).

The forward is functional over a state dict with MedicalNet's names, so the
same weights load into the program and here. `quant`, when given, is applied
to every convolution's and the Linear's input and weight and to the
activations kept between blocks (the residual stream): the low-precision
controls (`portbench/reference/lowp.py`) use it. This module imports neither
JAX nor anything of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

DEPTHS = {10: ("basic", (1, 1, 1, 1)), 18: ("basic", (2, 2, 2, 2)),
          34: ("basic", (3, 4, 6, 3)), 50: ("bottleneck", (3, 4, 6, 3)),
          101: ("bottleneck", (3, 4, 23, 3))}
STAGES = ((64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4))  # planes, stride, dilation
BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # the share of a batch's statistics in the running ones


def block_plan(depth: int) -> list[dict]:
    """Per residual block: its name prefix, kind, and convs as (name, c_in,
    c_out, kernel, stride, dilation), the shortcut conv last as 'down'."""
    kind, layers = DEPTHS[depth]
    expansion = 1 if kind == "basic" else 4
    blocks, cin = [], 64
    for si, ((planes, stride0, dil), n) in enumerate(zip(STAGES, layers)):
        for bi in range(n):
            stride = stride0 if bi == 0 else 1
            cout = planes * expansion
            if kind == "basic":
                convs = [("conv1", cin, planes, 3, stride, dil),
                         ("conv2", planes, planes, 3, 1, dil)]
            else:
                convs = [("conv1", cin, planes, 1, 1, 1),
                         ("conv2", planes, planes, 3, stride, dil),
                         ("conv3", planes, cout, 1, 1, 1)]
            if stride != 1 or cin != cout:
                convs.append(("down", cin, cout, 1, stride, 1))
            blocks.append({"prefix": f"layer{si + 1}.{bi}", "kind": kind, "convs": convs})
            cin = cout
    return blocks


def fc_in(depth: int) -> int:
    return 512 * (1 if DEPTHS[depth][0] == "basic" else 4)


def param_shapes(depth: int, in_channels: int, num_classes: int) -> dict:
    """Every parameter and buffer of the model: name -> shape ('running_*'
    and 'num_batches_tracked' are the BatchNorm buffers)."""
    shapes = {"conv1.weight": (64, in_channels, 7, 7, 7)}

    def bn(prefix, c):
        for k in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{prefix}.{k}"] = (c,)
        shapes[f"{prefix}.num_batches_tracked"] = ()

    bn("bn1", 64)
    for blk in block_plan(depth):
        for name, cin, cout, k, _, _ in blk["convs"]:
            if name == "down":
                shapes[f"{blk['prefix']}.downsample.0.weight"] = (cout, cin, k, k, k)
                bn(f"{blk['prefix']}.downsample.1", cout)
            else:
                shapes[f"{blk['prefix']}.{name}.weight"] = (cout, cin, k, k, k)
                bn(f"{blk['prefix']}.bn{name[-1]}", cout)
    shapes["conv_seg.3.weight"] = (num_classes, fc_in(depth))
    shapes["conv_seg.3.bias"] = (num_classes,)
    return shapes


def conv_bn_names(prefix: str, name: str) -> tuple[str, str]:
    """(conv weight key, BatchNorm prefix) of a block conv."""
    if name == "down":
        return f"{prefix}.downsample.0.weight", f"{prefix}.downsample.1"
    return f"{prefix}.{name}.weight", f"{prefix}.bn{name[-1]}"


def _conv(x, w, stride, dilation, quant):
    k = w.shape[-1]
    if quant is not None:
        x, w = quant(x), quant(w)
    return F.conv3d(x, w, None, stride, dilation * (k - 1) // 2, dilation)


def _bn(x, sd, prefix, train, stats):
    w, b = sd[f"{prefix}.weight"], sd[f"{prefix}.bias"]
    if not train:
        return F.batch_norm(x, sd[f"{prefix}.running_mean"], sd[f"{prefix}.running_var"],
                            w, b, False, 0.0, BN_EPS)
    mean = x.mean(dim=(0, 2, 3, 4))
    var = x.var(dim=(0, 2, 3, 4), unbiased=False)
    if stats is not None:
        stats[prefix] = (mean.detach(), var.detach())
    shape = (1, -1, 1, 1, 1)
    return (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + BN_EPS) * w.view(shape) \
        + b.view(shape)


def forward(sd: dict, x: torch.Tensor, depth: int, train: bool = False,
            dropout_keep: torch.Tensor | None = None, dropout_p: float = 0.5,
            quant=None, stats: dict | None = None) -> torch.Tensor:
    """NCDHW float32 `x` -> float32 logits. In `train` mode each BatchNorm
    normalizes by the batch's statistics (biased variance), recorded into
    `stats` when given, and `dropout_keep` (a bool mask of the pooled
    features) applies dropout; in eval mode the running statistics are
    used and dropout is off."""
    store = quant or (lambda t: t)  # what the forward keeps between layers
    h = _conv(x, sd["conv1.weight"], 2, 1, quant)
    h = store(F.max_pool3d(F.relu(_bn(h, sd, "bn1", train, stats)), 3, 2, 1))
    for blk in block_plan(depth):
        convs = {c[0]: c for c in blk["convs"]}
        out = h
        for name in ("conv1", "conv2", "conv3"):
            if name not in convs:
                continue
            _, _, _, _, stride, dil = convs[name]
            wkey, bnp = conv_bn_names(blk["prefix"], name)
            out = _bn(_conv(out, sd[wkey], stride, dil, quant), sd, bnp, train, stats)
            last = name == ("conv2" if blk["kind"] == "basic" else "conv3")
            if not last:
                out = F.relu(out)
        res = h
        if "down" in convs:
            wkey, bnp = conv_bn_names(blk["prefix"], "down")
            res = _bn(_conv(h, sd[wkey], convs["down"][4], 1, quant), sd, bnp, train, stats)
        h = store(F.relu(out + res))
    feats = h.mean(dim=(2, 3, 4))
    if train and dropout_keep is not None:
        feats = torch.where(dropout_keep, feats / (1.0 - dropout_p), torch.zeros_like(feats))
    w, b = sd["conv_seg.3.weight"], sd["conv_seg.3.bias"]
    if quant is not None:
        feats, w = quant(feats), quant(w)
    return feats @ w.t() + b


def update_running_stats(sd: dict, stats: dict) -> None:
    """Blend a train step's batch statistics into the running ones, the
    variance biased (flax's BatchNorm, which the configurations state)."""
    for prefix, (mean, var) in stats.items():
        m = BN_MOMENTUM
        sd[f"{prefix}.running_mean"] = (1 - m) * sd[f"{prefix}.running_mean"] + m * mean
        sd[f"{prefix}.running_var"] = (1 - m) * sd[f"{prefix}.running_var"] + m * var
