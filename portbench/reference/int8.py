"""Plain reference of int8 serving (post-training quantisation of the
3-D ResNet), worked out again from the float32 fold weights the benchmark
made and the calibration volumes it chose:

- every block convolution's BatchNorm folded into it: w * g, b = beta -
  mean * g, g = gamma / sqrt(var + eps);
- weights symmetric per output channel: s_c = max|w_c| / L + 1e-12, w_q =
  clip(round(w / s_c), -L, L), L = 127 (int8) or 7 (the 4-bit control);
- activations symmetric per tensor at each block's input and after each
  inner convolution's ReLU, with static scales max|h| / L + 1e-12 over the
  calibration volumes through the folded float32 graph;
- each block convolution of the quantised integers accumulated exactly
  enough in float32 (TF32 off), dequantised by s_act * s_w, the folded bias
  added; the inner convolutions' ReLU and requantisation, the last
  convolution's residual add and ReLU and the next block's quantisation;
- the stem (plain 7^3 convolution with its BatchNorm affine, ReLU, max
  pool) and the head (mean, Linear) in float32.

Imports neither JAX nor the program.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import resnet3d as ref


def _fold(sd, wkey, bnp):
    g = sd[f"{bnp}.weight"] / torch.sqrt(sd[f"{bnp}.running_var"] + ref.BN_EPS)
    b = sd[f"{bnp}.bias"] - sd[f"{bnp}.running_mean"] * g
    return sd[wkey] * g.view(-1, 1, 1, 1, 1), b


def export(sd: dict, depth: int, levels: int = 127) -> dict:
    """Folded and quantised weights: per block conv (folded float32 weight,
    integer weight as float32, per-channel scale, folded bias)."""
    g = sd["bn1.weight"] / torch.sqrt(sd["bn1.running_var"] + ref.BN_EPS)
    qp = {"stem": (sd["conv1.weight"], g, sd["bn1.bias"] - sd["bn1.running_mean"] * g),
          "fc": (sd["conv_seg.3.weight"], sd["conv_seg.3.bias"]), "convs": {}}
    for blk in ref.block_plan(depth):
        for name, *_ in blk["convs"]:
            w, b = _fold(sd, *ref.conv_bn_names(blk["prefix"], name))
            s = w.abs().amax(dim=(1, 2, 3, 4)) / levels + 1e-12
            wq = torch.clamp(torch.round(w / s.view(-1, 1, 1, 1, 1)), -levels, levels)
            qp["convs"][(blk["prefix"], name)] = (w, wq, s, b)
    return qp


def _stem(qp, x):
    w, g, b = qp["stem"]
    h = F.conv3d(x, w, None, 2, 3)
    h = torch.relu(h * g.view(1, -1, 1, 1, 1) + b.view(1, -1, 1, 1, 1))
    return F.max_pool3d(h, 3, 2, 1)


def _head(qp, h):
    w, b = qp["fc"]
    return h.mean(dim=(2, 3, 4)) @ w.t() + b


def _conv(x, w, stride, dil):
    k = w.shape[-1]
    return F.conv3d(x, w, None, stride, dil * (k - 1) // 2, dil)


def _bias(b):
    return b.view(1, -1, 1, 1, 1)


@torch.no_grad()
def observe(qp: dict, x: torch.Tensor, depth: int) -> list:
    """Folded float32 forward of normalized NCDHW `x` -> max|h| at each
    quant point, in block order (input, after conv1's ReLU, and for a
    Bottleneck after conv2's ReLU)."""
    h, maxes = _stem(qp, x), []
    for blk in ref.block_plan(depth):
        convs = {c[0]: c for c in blk["convs"]}
        maxes.append(h.abs().amax())
        a = h
        inner = ("conv1",) if blk["kind"] == "basic" else ("conv1", "conv2")
        for name in inner:
            _, _, _, _, stride, dil = convs[name]
            w, _, _, b = qp["convs"][(blk["prefix"], name)]
            a = torch.relu(_conv(a, w, stride, dil) + _bias(b))
            maxes.append(a.abs().amax())
        last = "conv2" if blk["kind"] == "basic" else "conv3"
        _, _, _, _, stride, dil = convs[last]
        w, _, _, b = qp["convs"][(blk["prefix"], last)]
        o = _conv(a, w, stride, dil) + _bias(b)
        r = h
        if "down" in convs:
            w, _, _, b = qp["convs"][(blk["prefix"], "down")]
            r = _conv(h, w, convs["down"][4], 1) + _bias(b)
        h = torch.relu(o + r)
    return maxes


def scales(maxes, levels: int = 127) -> list:
    """Activation scales max|h| / L + 1e-12 in float32."""
    m = np.asarray([float(v) for v in maxes], np.float32)
    return list(m / np.float32(levels) + np.float32(1e-12))


def _quant(h, s, levels):
    return torch.clamp(torch.round(h / s), -levels, levels)


@torch.no_grad()
def forward(qp: dict, act_scales: list, x: torch.Tensor, depth: int,
            levels: int = 127) -> torch.Tensor:
    """Quantised forward of normalized NCDHW `x` -> float32 logits."""
    h = _stem(qp, x)
    pos = 0
    hq = None
    for blk in ref.block_plan(depth):
        convs = {c[0]: c for c in blk["convs"]}
        s_in = act_scales[pos]
        if hq is None:
            hq = _quant(h, s_in, levels)
        r = h
        if "down" in convs:
            _, wq, sw, b = qp["convs"][(blk["prefix"], "down")]
            r = _conv(hq, wq, convs["down"][4], 1) * _bias(s_in * sw) + _bias(b)
        a, s_a = hq, s_in
        inner = ("conv1",) if blk["kind"] == "basic" else ("conv1", "conv2")
        for j, name in enumerate(inner):
            _, _, _, _, stride, dil = convs[name]
            _, wq, sw, b = qp["convs"][(blk["prefix"], name)]
            s_next = act_scales[pos + 1 + j]
            a = _quant(torch.relu(_conv(a, wq, stride, dil) * _bias(s_a * sw) + _bias(b)),
                       s_next, levels)
            s_a = s_next
        last = "conv2" if blk["kind"] == "basic" else "conv3"
        _, _, _, _, stride, dil = convs[last]
        _, wq, sw, b = qp["convs"][(blk["prefix"], last)]
        h = torch.relu(_conv(a, wq, stride, dil) * _bias(s_a * sw) + _bias(b) + r)
        pos += 1 + len(inner)
        hq = _quant(h, act_scales[pos], levels) if pos < len(act_scales) else None
    return _head(qp, h)
