"""A toy model family for the tests: a plain 3-D CNN with no BatchNorm, to
show that a family other than the ResNet runs through the harness as new
files alone (`portbench/lib/family.py`). Two 3^3 convolutions (padding 1,
with bias), each followed by a ReLU, a global mean, dropout and a Linear
head; `width` channels throughout. It serves in bf16 only.

The program side is an `nn.Module` that the port's predictor and train
loop take as they take the ResNet: channels-last input, `compute_dtype`
(bf16 autocast over float32 parameters), and the port's `GeneratorDropout`,
which `create_train_state` seeds. The reference is the same mathematics in
functional float32 torch."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from portbench.lib import inputs
from portbench.lib.work import k3_work

precisions = ("bf16",)


def update_running_stats(buffers: dict, stats: dict) -> None:
    """No running statistics to update."""


def describe(cfg: dict) -> dict:
    return {"type": "toy_cnn", "shape": tuple(cfg["input_shape"]),
            "in_channels": cfg["in_channels"], "width": cfg["width"],
            "num_classes": cfg["nb_class"]}


class ToyCNN(nn.Module):
    def __init__(self, in_channels: int, width: int, num_classes: int, dropout_rate: float,
                 compute_dtype: torch.dtype):
        from multimodal_ad_tpu_torch.models.resnet3d import GeneratorDropout
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = nn.Conv3d(in_channels, width, 3, padding=1)
        self.conv2 = nn.Conv3d(width, width, 3, padding=1)
        self.dropout = GeneratorDropout(dropout_rate)
        self.fc = nn.Linear(width, num_classes)

    def forward(self, x):
        """(B, X, Y, Z, C) -> float32 logits (B, classes)."""
        x = x.permute(0, 4, 1, 2, 3)
        bf16 = self.compute_dtype == torch.bfloat16
        if not bf16:
            x = x.to(torch.float32)
        with torch.autocast(device_type=x.device.type, dtype=torch.bfloat16, enabled=bf16):
            h = F.relu(self.conv2(F.relu(self.conv1(x))))
            feats = self.dropout(h.float().mean(dim=(2, 3, 4)))
            return self.fc(feats).float()


def program_model(cfg: dict, device):
    dtype = getattr(torch, cfg["compute_dtype"])
    return ToyCNN(cfg["in_channels"], cfg["width"], cfg["nb_class"], cfg["dropout_rate"],
                  dtype).to(device)


def init_weights(cfg: dict, seed: int, device) -> dict:
    """Convolutions Kaiming-normal by fan-out, biases zero, the Linear
    uniform in +-1/sqrt(width); one draw each."""
    dev = torch.device(device)
    g = inputs.generator(seed, dev)
    c, w, k = cfg["in_channels"], cfg["width"], cfg["nb_class"]
    shapes = [(w, c, 3, 3, 3), (w, w, 3, 3, 3)]
    sizes = [s[0] * s[1] * 27 for s in shapes]
    flat = torch.randn(sum(sizes), generator=g, device=dev)
    w1, w2 = torch.split(flat, sizes)
    fan_out = w * 27
    u = (torch.rand(k * w + k, generator=g, device=dev) * 2 - 1) * w ** -0.5
    return {"conv1.weight": w1.view(shapes[0]) * (2.0 / fan_out) ** 0.5,
            "conv1.bias": torch.zeros(w, device=dev),
            "conv2.weight": w2.view(shapes[1]) * (2.0 / fan_out) ** 0.5,
            "conv2.bias": torch.zeros(w, device=dev),
            "fc.weight": u[:k * w].view(k, w), "fc.bias": u[k * w:]}


def serving_weights(cfg: dict, seed: int, fold: int, calibration, device) -> dict:
    """No statistics to calibrate: the fold's initial weights."""
    return init_weights(cfg, inputs.sub_seed(seed, "fold", fold), device)


def reference_forward(sd: dict, x: torch.Tensor, cfg: dict, train: bool = False,
                      dropout_keep: torch.Tensor | None = None, stats: dict | None = None,
                      quant=None) -> torch.Tensor:
    q = quant or (lambda t: t)
    h = F.relu(F.conv3d(q(x), q(sd["conv1.weight"]), sd["conv1.bias"], padding=1))
    h = F.relu(F.conv3d(q(h), q(sd["conv2.weight"]), sd["conv2.bias"], padding=1))
    feats = h.mean(dim=(2, 3, 4))
    if train and dropout_keep is not None:
        p = cfg["dropout_rate"]
        feats = torch.where(dropout_keep, feats / (1.0 - p), torch.zeros_like(feats))
    return q(feats) @ q(sd["fc.weight"]).t() + sd["fc.bias"]


def dropout_width(cfg: dict) -> int:
    return cfg["width"]


def forward_ops(model: dict) -> dict:
    """The first convolution as the stem, the second as the blocks, the
    Linear as the head; taps in the padding left out."""
    c, w, shape = model["in_channels"], model["width"], model["shape"]
    return {"stem": k3_work(1, shape, c, w, 3, 1, 1)[0],
            "blocks": k3_work(1, shape, w, w, 3, 1, 1)[0],
            "fc": 2.0 * w * model["num_classes"]}
