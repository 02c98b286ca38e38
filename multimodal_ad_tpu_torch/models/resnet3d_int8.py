"""Post-training int8 inference for the 3-D ResNet family (all depths),
port of the TPU package's models/resnet3d_int8.py.

A trained fp ResNet3D (this package's state_dict, MedicalNet names) becomes
an int8 inference graph:

- BatchNorm is folded into each block conv: y = conv(x) * g + b with
  g = scale / sqrt(var + eps), b = bias - mean * g;
- weights quantize symmetrically per output channel (w_q = round(w / s_c),
  s_c = max|w[..., c]| / 127);
- activations quantize symmetrically per tensor with static scales
  calibrated offline (max|h| over calibration batches / 127), at the
  points `block_scale_keys` names;
- each block conv runs int8 x int8 -> int32 in K3 (ops/int8_conv.py, a
  CUDA kernel on the card), with the dequant, folded bias, ReLU and next
  quant point in its epilogue, and a block's last conv also adds the
  residual, applies the ReLU and the bf16 cast and writes the next block's
  input quant point (K3's block_out epilogue);
- the stem and the classifier head stay bf16 / float32: the stem is the
  TPU package's space-to-depth form (the 7^3 stride-2 conv as a dense 4^3
  stride-1 conv over the 2^3 phases packed on the channel axis), run as a
  bf16 F.conv3d, then the folded BN affine, ReLU and the 3^3 stride-2 max
  pool;
- residual adds happen in float32 (in that epilogue), and each block's
  output is cast to bf16.

Export (`export_int8`) runs in numpy float32 with the TPU package's
operations in its order (multiply, sqrt, max, division, round half to
even), so it is bit-equal to the TPU package's export of the same weights.
The forward works in NDHWC throughout (K3 wants channels innermost); the
stem conv and the max pool see channels-last NCDHW views.

The TPU package stacks folds and vmaps one compiled graph over them
(split_arrays / rehydrate); here each fold is its own `ResNet3DInt8` and
serving loops folds, as serve.py's EnsemblePredictor does.

Usage:
    qp = export_int8(model.state_dict(), depth=18, shortcut_type="B")
    scales = calibrate_int8(qp, calibration_batches)  # few real batches
    logits = resnet3d_int8_apply(qp, scales, x)       # or ResNet3DInt8(qp, scales)
"""

from __future__ import annotations

import json

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.int8_conv import conv_i8, quantize, relayout_weight
from .resnet3d import DEPTH_BLOCKS, STAGES, stem_s2d_pack, stem_s2d_weight


def fold_bn(kernel, scale, bias, mean, var, eps=1e-5):
    """Fold inference-mode BatchNorm into the preceding bias-free DHWIO
    kernel: (kernel * g, b) in float32."""
    g = scale / np.sqrt(var + eps)
    b = bias - mean * g
    return kernel * g, np.asarray(b, np.float32)


def quant_weight(w):
    """Symmetric per-output-channel int8 of a DHWIO kernel: (w_q int8, s (C,)
    float32)."""
    s = np.max(np.abs(w), axis=(0, 1, 2, 3)) / 127.0 + 1e-12
    wq = np.clip(np.rint(w / s), -127, 127).astype(np.int8)
    return wq, s.astype(np.float32)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _bn(sd, prefix):
    return [_np(sd[f"{prefix}.{k}"]).astype(np.float32)
            for k in ("weight", "bias", "running_mean", "running_var")]


def _dhwio(w) -> np.ndarray:
    return np.transpose(_np(w).astype(np.float32), (2, 3, 4, 1, 0))  # OIDHW -> DHWIO


def export_int8(state_dict, depth: int = 18, shortcut_type: str = "B") -> dict:
    """Fold BN + quantize every block conv of a trained ResNet3D (this
    package's state_dict; BasicBlock depths 10/18/34, Bottleneck depths
    50/101/152/200).

    Returns the TPU package's "qparams" layout as host numpy arrays: per
    block conv its int8 DHWIO kernel `wq`, per-channel scales `s`, folded
    bias `b` and fp shadow kernel `w_fp` (calibration only); the stem's
    DHWIO kernel with its BN affine `g`, `b`; the head; the block geometry."""
    kind, layers = DEPTH_BLOCKS[depth]
    sd = state_dict
    scale, bias, mean, var = _bn(sd, "bn1")
    g = scale / np.sqrt(var + 1e-5)
    qp = {"stem": {"kernel": _dhwio(sd["conv1.weight"]), "g": g.astype(np.float32),
                   "b": (bias - mean * g).astype(np.float32)},
          "blocks": [], "dense": None, "shortcut_type": shortcut_type}
    if "conv_seg.3.weight" in sd:
        qp["dense"] = {"kernel": np.ascontiguousarray(_np(sd["conv_seg.3.weight"]).T),
                       "bias": _np(sd["conv_seg.3.bias"]).astype(np.float32)}

    def folded_q(conv, bn):
        w, b = fold_bn(_dhwio(sd[f"{conv}.weight"]), *_bn(sd, bn))
        wq, s = quant_weight(w)
        return {"wq": wq, "s": s, "b": b, "w_fp": w.astype(np.float32)}

    expansion = 1 if kind == "basic" else 4
    n_main = 2 if kind == "basic" else 3
    in_planes = 64
    for si, ((planes, stride0, dilation), n_blocks) in enumerate(zip(STAGES, layers)):
        for bi in range(n_blocks):
            stride = stride0 if bi == 0 else 1
            tp = f"layer{si + 1}.{bi}"
            out_planes = planes * expansion
            block = {"kind": kind, "stride": stride, "dilation": dilation,
                     "planes": out_planes, "down": None}
            for j in range(1, n_main + 1):
                block[f"conv{j}"] = folded_q(f"{tp}.conv{j}", f"{tp}.bn{j}")
            if stride != 1 or in_planes != out_planes:
                block["down"] = (folded_q(f"{tp}.downsample.0", f"{tp}.downsample.1")
                                 if shortcut_type == "B" else "A")
            qp["blocks"].append(block)
            in_planes = out_planes
    return qp


def block_scale_keys(qp) -> list:
    """Quant-point names per block, in the order the forward observes them:
    input, first mid; Bottleneck blocks add a second mid."""
    keys = []
    for i, blk in enumerate(qp["blocks"]):
        keys += [f"b{i}_in", f"b{i}_mid"]
        if blk.get("kind", "basic") == "bottleneck":
            keys.append(f"b{i}_mid2")
    return keys


# the quant point each block conv reads: conv3 only in Bottleneck blocks
_CONV_INPUT = {"conv1": "in", "conv2": "mid", "conv3": "mid2", "down": "in"}


def _conv_names(blk) -> list:
    names = ["conv1", "conv2"] + (["conv3"] if blk.get("kind", "basic") == "bottleneck" else [])
    return names + (["down"] if isinstance(blk["down"], dict) else [])


def _shortcut_a(x, planes: int, stride: int):
    """Window-1 strided average pool (strided slicing) + zero channel pad."""
    if stride != 1:
        x = x[:, ::stride, ::stride, ::stride, :]
    pad = planes - x.shape[-1]
    return F.pad(x, (0, pad)) if pad > 0 else x


class ResNet3DInt8(nn.Module):
    """One fold's int8 (or folded fp) forward from an `export_int8` qp.

    The int8 kernels (re-laid (C_out, k, k, k, C_in) for K3), per-channel
    scales, folded biases, fp shadow kernels (bf16 OIDHW, until
    `strip_fp`), the s2d stem weight (bf16) and its affine, and the head
    are buffers, so `.to(device)` moves them. `set_scales` fixes the
    activation scales and precomputes each conv's dequant factor
    k = s_act * s_w in float32. Inputs are (B, X, Y, Z, C) volumes."""

    def __init__(self, qp: dict, scales=None):
        super().__init__()
        kernel = torch.from_numpy(np.asarray(qp["stem"]["kernel"], np.float32))
        self.in_channels = kernel.shape[3]
        k = kernel.to(torch.bfloat16).permute(4, 3, 0, 1, 2)  # DHWIO -> OIDHW
        self.register_buffer("stem_w", stem_s2d_weight(k).contiguous())
        self.register_buffer("stem_g", torch.from_numpy(np.asarray(qp["stem"]["g"], np.float32)))
        self.register_buffer("stem_b", torch.from_numpy(np.asarray(qp["stem"]["b"], np.float32)))
        dense = qp["dense"]
        self.register_buffer("dense_w", None if dense is None else torch.from_numpy(
            np.asarray(dense["kernel"], np.float32)))
        self.register_buffer("dense_b", None if dense is None else torch.from_numpy(
            np.asarray(dense["bias"], np.float32)))

        self.blocks = []
        for i, blk in enumerate(qp["blocks"]):
            names = _conv_names(blk)
            down = "conv" if isinstance(blk["down"], dict) else blk["down"]
            self.blocks.append({"kind": blk.get("kind", "basic"), "stride": blk["stride"],
                                "dilation": blk["dilation"], "planes": blk["planes"],
                                "down": down, "convs": names})
            for name in names:
                kd = blk[name]
                wq = torch.from_numpy(np.asarray(kd["wq"], np.int8))
                self.register_buffer(f"b{i}_{name}_wq", relayout_weight(wq))
                self.register_buffer(f"b{i}_{name}_s",
                                     torch.from_numpy(np.asarray(kd["s"], np.float32)))
                self.register_buffer(f"b{i}_{name}_b",
                                     torch.from_numpy(np.asarray(kd["b"], np.float32)))
                if "w_fp" in kd:
                    w = torch.from_numpy(np.asarray(kd["w_fp"], np.float32))
                    self.register_buffer(f"b{i}_{name}_wfp", w.to(torch.bfloat16)
                                         .permute(4, 3, 0, 1, 2).contiguous())
        self.scale_keys = block_scale_keys(qp)
        self.register_buffer("act_scales", None)
        self._scales_host = None
        if scales is not None:
            self.set_scales(scales)

    # ---- scales -----------------------------------------------------------

    def set_scales(self, scales):
        """Activation scales: a {key: float} dict (as `calibrate_int8`
        returns) or a (P,) vector in `scale_keys` order. Stored as float32."""
        if isinstance(scales, dict):
            vec = torch.tensor([scales[k] for k in self.scale_keys], dtype=torch.float32)
        else:
            vec = torch.as_tensor(scales, dtype=torch.float32).detach().cpu().reshape(-1)
        if vec.numel() != len(self.scale_keys):
            raise ValueError(f"{vec.numel()} scales for {len(self.scale_keys)} quant points")
        pos = {k: j for j, k in enumerate(self.scale_keys)}
        dev = self.stem_g.device
        for i, blk in enumerate(self.blocks):
            for name in blk["convs"]:
                s_act = vec[pos[f"b{i}_{_CONV_INPUT[name]}"]]
                s_w = getattr(self, f"b{i}_{name}_s").cpu()
                self.register_buffer(f"b{i}_{name}_k", (s_act * s_w).to(dev))
        self.act_scales = vec.to(dev)
        self._scales_host = dict(zip(self.scale_keys, vec.tolist()))
        return self

    def strip_fp(self):
        """Drop the fp shadow kernels (calibration only)."""
        for i, blk in enumerate(self.blocks):
            for name in blk["convs"]:
                if hasattr(self, f"b{i}_{name}_wfp"):
                    delattr(self, f"b{i}_{name}_wfp")
        return self

    # ---- forward ----------------------------------------------------------

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """(B, X, Y, Z, C) -> bf16 NDHWC: s2d 4^3 conv, affine, ReLU, max pool."""
        if x.shape[-1] != self.in_channels:
            raise ValueError(f"input has {x.shape[-1]} channels, model takes {self.in_channels}")
        o = F.conv3d(stem_s2d_pack(x.to(torch.bfloat16)), self.stem_w).permute(0, 2, 3, 4, 1)
        o = torch.relu(o.float() * self.stem_g + self.stem_b).to(torch.bfloat16)
        o = F.max_pool3d(o.permute(0, 4, 1, 2, 3), 3, 2, 1)
        return o.permute(0, 2, 3, 4, 1).contiguous()

    def _qconv(self, inp, i, name, stride, dil, epilogue, s_next=None, residual=None):
        return conv_i8(inp, getattr(self, f"b{i}_{name}_wq"), stride, dil, epilogue,
                       getattr(self, f"b{i}_{name}_k"), getattr(self, f"b{i}_{name}_b"),
                       s_next, residual)

    def _fconv(self, inp, i, name, stride, dil):
        """Folded fp conv: bf16 F.conv3d, then + b in float32."""
        key = f"b{i}_{name}_wfp"
        if not hasattr(self, key):
            raise RuntimeError("the fp shadow kernels were stripped (or never "
                               "exported): the folded forward needs them")
        w = getattr(self, key)
        pad = dil * (w.shape[2] - 1) // 2
        o = F.conv3d(inp.to(torch.bfloat16).permute(0, 4, 1, 2, 3), w, stride=stride,
                     padding=pad, dilation=dil)
        return o.permute(0, 2, 3, 4, 1).float() + getattr(self, f"b{i}_{name}_b")

    def blocks_forward(self, h, quantized: bool = True, observe: bool = False,
                       taps: list | None = None):
        """The blocks from the stem's bf16 output -> (bf16 layer4 map, list
        of observed max|h| per quant point). quantized=False runs the folded
        fp graph. `taps`, when given, collects each int8 quant point.

        int8: a block's last conv runs K3's block_out epilogue, which adds
        the residual (the bf16 identity, or the float32 shortcut, computed
        first), applies the ReLU and the bf16 cast, and writes the next
        block's input quant point beside the block's output."""
        if quantized and self.act_scales is None:
            raise RuntimeError("set_scales (or calibrate) before the int8 forward")
        sc, st = self._scales_host, self.act_scales
        pos = {k: j for j, k in enumerate(self.scale_keys)}
        maxes, hq = [], None
        for i, blk in enumerate(self.blocks):
            stride, dil = blk["stride"], blk["dilation"]
            bneck = blk["kind"] == "bottleneck"
            if observe:
                maxes.append(h.float().abs().amax())
            if quantized:
                s_in, s_mid = f"b{i}_in", f"b{i}_mid"
                if hq is None:  # the first block; later ones get it from block_out
                    hq = quantize(h, st[pos[s_in]])
                if blk["down"] is None:
                    r = h
                elif blk["down"] == "A":
                    r = _shortcut_a(h.float(), blk["planes"], stride).contiguous()
                else:
                    r = self._qconv(hq, i, "down", stride, 1, "float32")
                s_out = sc[f"b{i + 1}_in"] if i + 1 < len(self.blocks) else None
                if bneck:
                    aq = self._qconv(hq, i, "conv1", 1, 1, "int8", sc[s_mid])
                    a2q = self._qconv(aq, i, "conv2", stride, dil, "int8", sc[f"b{i}_mid2"])
                    points = (hq, aq, a2q)
                    h, hq = self._qconv(a2q, i, "conv3", 1, 1, "block_out", s_out, r)
                else:
                    aq = self._qconv(hq, i, "conv1", stride, dil, "int8", sc[s_mid])
                    points = (hq, aq)
                    h, hq = self._qconv(aq, i, "conv2", 1, dil, "block_out", s_out, r)
                if taps is not None:
                    taps.extend(points)
                continue
            c1 = (1, 1) if bneck else (stride, dil)
            a = torch.relu(self._fconv(h, i, "conv1", *c1))
            if observe:
                maxes.append(a.abs().amax())
            if bneck:
                a2 = torch.relu(self._fconv(a, i, "conv2", stride, dil))
                if observe:
                    maxes.append(a2.abs().amax())
                o = self._fconv(a2, i, "conv3", 1, 1)
            else:
                o = self._fconv(a, i, "conv2", 1, dil)
            if blk["down"] is None:
                r = h.float()
            elif blk["down"] == "A":
                r = _shortcut_a(h.float(), blk["planes"], stride)
            else:
                r = self._fconv(h, i, "down", stride, 1)
            h = torch.relu(o + r).to(torch.bfloat16)
        return h, maxes

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """Global mean in float32, then the classifier (if exported)."""
        pooled = h.float().mean(dim=(1, 2, 3))
        if self.dense_w is None:
            return pooled
        return pooled @ self.dense_w + self.dense_b

    def forward(self, x: torch.Tensor, quantized: bool = True) -> torch.Tensor:
        """(B, X, Y, Z, C) -> (B, classes) float32 logits (pooled
        embeddings without a head)."""
        return self.head(self.blocks_forward(self.stem(x), quantized)[0])

    def observe(self, x: torch.Tensor) -> torch.Tensor:
        """Folded fp forward -> (P,) float32 max|h| per quant point."""
        return torch.stack(self.blocks_forward(self.stem(x), False, observe=True)[1])


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x, np.float32))


@torch.inference_mode()
def calibrate_int8(qp, batches) -> dict:
    """Static activation scales from the folded fp graph: per quant point,
    max|h| over all calibration batches / 127 + 1e-12 (float64, as Python
    floats)."""
    net, agg = None, None
    for x in batches:
        x = _as_tensor(x)
        if net is None:
            net = ResNet3DInt8(qp).to(x.device)
        m = net.observe(x).cpu().numpy().astype(np.float64)
        agg = m if agg is None else np.maximum(agg, m)
    if agg is None:
        raise ValueError("calibrate_int8 got no calibration batches: pass at least "
                         "one (n, X, Y, Z, C) array")
    return {k: float(v / 127.0 + 1e-12) for k, v in zip(block_scale_keys(qp), agg)}


@torch.inference_mode()
def observe_maxes(qp, x) -> torch.Tensor:
    """Folded fp forward -> the (P,) max|h| vector of the quant points."""
    x = _as_tensor(x)
    return ResNet3DInt8(qp).to(x.device).observe(x)


def strip_fp(qp):
    """Drop the fp shadow kernels (calibration only) from a qp."""
    def walk(o):
        if isinstance(o, dict):
            return {k: walk(v) for k, v in o.items() if k != "w_fp"}
        if isinstance(o, list):
            return [walk(v) for v in o]
        return o

    return walk(qp)


@torch.inference_mode()
def resnet3d_int8_apply(qp, scales, x) -> torch.Tensor:
    """int8 inference forward -> (B, classes) float32 logits (or pooled
    embeddings when the model had no head), on `x`'s device."""
    x = _as_tensor(x)
    return ResNet3DInt8(strip_fp(qp), scales).to(x.device)(x)


@torch.inference_mode()
def resnet3d_folded_apply(qp, x) -> torch.Tensor:
    """Folded fp forward (BN constants baked in, bf16 convs), the
    quantization-free twin that calibration observes."""
    x = _as_tensor(x)
    return ResNet3DInt8(qp).to(x.device)(x, quantized=False)


def save_int8(path: str, qp, scales: dict) -> str:
    """Persist a quantized model as one .npz in the TPU package's format:
    int8 DHWIO kernels, per-channel weight scales, folded biases, stem and
    head weights, and a `__geometry__` JSON with the block geometry and the
    activation scales. The fp shadow kernels are not saved. A file either
    package writes loads in the other."""
    arrays = {"stem_kernel": qp["stem"]["kernel"],
              "stem_g": qp["stem"]["g"], "stem_b": qp["stem"]["b"]}
    geom = {"shortcut_type": qp["shortcut_type"], "has_dense": qp["dense"] is not None,
            "scales": {k: float(v) for k, v in scales.items()}, "blocks": []}
    if qp["dense"] is not None:
        arrays["dense_kernel"] = np.asarray(qp["dense"]["kernel"])
        arrays["dense_bias"] = np.asarray(qp["dense"]["bias"])
    for i, blk in enumerate(qp["blocks"]):
        for name in _conv_names(blk):
            kd = blk[name]
            arrays[f"b{i}_{name}_wq"] = kd["wq"]
            arrays[f"b{i}_{name}_s"] = kd["s"]
            arrays[f"b{i}_{name}_b"] = kd["b"]
        down = blk["down"]
        geom["blocks"].append({
            "kind": blk.get("kind", "basic"), "stride": blk["stride"],
            "dilation": blk["dilation"], "planes": blk["planes"],
            "down": "conv" if isinstance(down, dict) else down})
    np.savez_compressed(path, __geometry__=json.dumps(geom), **arrays)
    return path


def load_int8(path: str):
    """Load a `save_int8` artifact -> (qp without fp shadow kernels,
    activation scales)."""
    z = np.load(path, allow_pickle=False)
    geom = json.loads(str(z["__geometry__"]))
    qp = {"shortcut_type": geom["shortcut_type"],
          "stem": {"kernel": z["stem_kernel"], "g": z["stem_g"], "b": z["stem_b"]},
          "dense": ({"kernel": z["dense_kernel"], "bias": z["dense_bias"]}
                    if geom["has_dense"] else None),
          "blocks": []}
    for i, g in enumerate(geom["blocks"]):
        blk = {"kind": g["kind"], "stride": g["stride"], "dilation": g["dilation"],
               "planes": g["planes"], "down": "A" if g["down"] == "A" else None}
        names = ["conv1", "conv2"] + (["conv3"] if g["kind"] == "bottleneck" else [])
        if g["down"] == "conv":
            names.append("down")
        for name in names:
            blk[name] = {"wq": z[f"b{i}_{name}_wq"], "s": z[f"b{i}_{name}_s"],
                         "b": z[f"b{i}_{name}_b"]}
        qp["blocks"].append(blk)
    return qp, dict(geom["scales"])
