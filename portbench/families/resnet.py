"""The MedicalNet 3-D ResNet (Chen et al., arXiv:1904.00625) as a model
family of the harness (see `portbench/lib/family.py`): the port's
`generate_model`, weights drawn from the seed, the plain float32 reference
(`reference/resnet3d.py`) and its int8 one (`reference/int8.py`), and the
network's work counted from its convolution plan.

Any depth in `reference/resnet3d.py::DEPTHS` runs through these functions."""

from __future__ import annotations

import numpy as np
import torch

from portbench.lib import inputs
from portbench.lib.work import k3_work, out_size
from portbench.reference import int8 as ref_int8
from portbench.reference import resnet3d as ref

precisions = ("bf16", "int8")
update_running_stats = ref.update_running_stats
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def describe(cfg: dict) -> dict:
    """The published network's shape, as `forward_ops` counts its work."""
    return {"type": "resnet", "depth": cfg["model_depth"], "shape": tuple(cfg["input_shape"]),
            "in_channels": cfg["in_channels"], "num_classes": cfg["nb_class"]}


def program_model(cfg: dict, device):
    from multimodal_ad_tpu_torch.models.resnet3d import generate_model
    with torch.device(device):
        return generate_model(
            model_type="resnet", model_depth=cfg["model_depth"],
            resnet_shortcut=cfg["resnet_shortcut"], nb_class=cfg["nb_class"],
            dropout_rate=cfg["dropout_rate"], in_channels=cfg["in_channels"],
            compute_dtype=_DTYPES[cfg["compute_dtype"]],
            param_dtype=_DTYPES[cfg["param_dtype"]], s2d_stem=cfg["s2d_stem"])


# ---- weights ------------------------------------------------------------

def init_weights(cfg: dict, seed: int, device) -> dict:
    """A fold's initial float32 state dict (MedicalNet names): convolutions
    Kaiming-normal by fan-out, as the program and MedicalNet initialise
    them, from one normal draw; BatchNorm scale 1, shift 0, running mean 0,
    variance 1; the Linear uniform in +-1/sqrt(fan_in), from one uniform
    draw."""
    dev = torch.device(device)
    g = inputs.generator(seed, dev)
    shapes = ref.param_shapes(cfg["model_depth"], cfg["in_channels"], cfg["nb_class"])
    convs = [(k, s) for k, s in shapes.items() if len(s) == 5]
    sizes = [int(np.prod(s)) for _, s in convs]
    std = torch.tensor([(2.0 / (s[0] * s[2] * s[3] * s[4])) ** 0.5 for _, s in convs],
                       device=dev)
    flat = torch.randn(sum(sizes), generator=g, device=dev) * torch.repeat_interleave(
        std, torch.tensor(sizes, device=dev))
    sd = {}
    for (k, s), part in zip(convs, torch.split(flat, sizes)):
        sd[k] = part.view(s)
    fc_w, fc_b = shapes["conv_seg.3.weight"], shapes["conv_seg.3.bias"]
    bound = fc_w[1] ** -0.5
    u = (torch.rand(int(np.prod(fc_w)) + fc_b[0], generator=g, device=dev) * 2 - 1) * bound
    sd["conv_seg.3.weight"] = u[:int(np.prod(fc_w))].view(fc_w)
    sd["conv_seg.3.bias"] = u[int(np.prod(fc_w)):]
    for k, s in shapes.items():
        if k in sd:
            continue
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.zeros((), dtype=torch.long, device=dev)
        elif k.endswith(("weight", "running_var")):
            sd[k] = torch.ones(s, device=dev)
        else:
            sd[k] = torch.zeros(s, device=dev)
    return sd


def trained_affine(sd: dict, seed: int, device) -> dict:
    """Serving weights stand for trained folds, whose BatchNorm scales and
    shifts spread over channels (where int8's per-tensor activation scales
    lose the small channels' precision): every BatchNorm's scale drawn
    log-normal (sigma 1) and its shift normal (0.25), in one draw."""
    keys = [k[:-len(".running_var")] for k in sd if k.endswith(".running_var")]
    sizes = [sd[f"{k}.weight"].numel() for k in keys]
    z = torch.randn(2 * sum(sizes), generator=inputs.generator(seed, device),
                    device=torch.device(device))
    scale, shift = torch.split(z, sum(sizes))
    for k, a, b in zip(keys, torch.split(scale, sizes), torch.split(shift, sizes)):
        sd[f"{k}.weight"] = torch.exp(a)
        sd[f"{k}.bias"] = 0.25 * b
    return sd


@torch.no_grad()
def calibrate_batchnorm(sd: dict, x: torch.Tensor, depth: int) -> dict:
    """Serving weights: the running statistics of every BatchNorm set to the
    batch statistics of a reference forward over `x` (normalized NCDHW
    volumes), so the eval-mode network sees normalized activations, as a
    trained one does."""
    stats = {}
    ref.forward(sd, x, depth, train=True, stats=stats)
    for prefix, (mean, var) in stats.items():
        sd[f"{prefix}.running_mean"] = mean.clone()
        sd[f"{prefix}.running_var"] = var.clone()
    return sd


def serving_weights(cfg: dict, seed: int, fold: int, calibration: torch.Tensor,
                    device) -> dict:
    """Fold `fold`'s serving weights: its initial weights, trained-like
    BatchNorm affines, and running statistics calibrated on
    `calibration`."""
    sd = init_weights(cfg, inputs.sub_seed(seed, "fold", fold), device)
    trained_affine(sd, inputs.sub_seed(seed, "affine", fold), device)
    return calibrate_batchnorm(sd, calibration, cfg["model_depth"])


# ---- the reference ------------------------------------------------------

def reference_forward(sd: dict, x: torch.Tensor, cfg: dict, train: bool = False,
                      dropout_keep: torch.Tensor | None = None, stats: dict | None = None,
                      quant=None) -> torch.Tensor:
    return ref.forward(sd, x, cfg["model_depth"], train=train, dropout_keep=dropout_keep,
                       dropout_p=cfg["dropout_rate"], quant=quant, stats=stats)


def int8_forward(sd: dict, calibration: torch.Tensor, cfg: dict, levels: int = 127):
    """The int8 reference's forward (`levels` 127), or its 4-bit control
    (7), from the float32 weights `sd` and the activation scales observed
    on `calibration`."""
    depth = cfg["model_depth"]
    qp = ref_int8.export(sd, depth, levels)
    scales = ref_int8.scales(ref_int8.observe(qp, calibration, depth), levels)
    return lambda x: ref_int8.forward(qp, scales, x, depth, levels)


def dropout_width(cfg: dict) -> int:
    return ref.fc_in(cfg["model_depth"])


# ---- work ---------------------------------------------------------------

def conv_plan(depth: int, shape, in_channels: int = 1) -> list[dict]:
    """Every convolution of the published network on one volume of
    `shape`, in forward order: name, input grid, channels, kernel, stride,
    dilation, the block's kind and whether it is the block's last conv."""
    convs = [{"name": "stem", "grid": tuple(shape), "c_in": in_channels, "c_out": 64,
              "k": 7, "stride": 2, "dil": 1, "pad": 3}]
    g = tuple(out_size(n, 7, 2, 1) for n in shape)
    g = tuple(out_size(n, 3, 2, 1) for n in g)  # the max pool
    for blk in ref.block_plan(depth):
        last = "conv2" if blk["kind"] == "basic" else "conv3"
        gin, gcur = g, g
        for name, cin, cout, k, stride, dil in blk["convs"]:
            src = gin if name in ("conv1", "down") else gcur
            convs.append({"name": f"{blk['prefix']}.{name}", "grid": src, "c_in": cin,
                          "c_out": cout, "k": k, "stride": stride, "dil": dil,
                          "kind": blk["kind"], "last": name == last,
                          "down": name == "down"})
            if name != "down":
                gcur = tuple(out_size(n, k, stride, dil) for n in src)
        g = gcur
    return convs


def forward_ops(model: dict) -> dict:
    """Operations of one volume's forward: {'stem', 'blocks', 'fc'}. The
    stem counted is the plain 7^3 one whatever stem the program runs, so a
    change of implementation does not change the count."""
    depth = model["depth"]
    ops = {"stem": 0.0, "blocks": 0.0, "fc": 2.0 * ref.fc_in(depth) * model["num_classes"]}
    for c in conv_plan(depth, model["shape"], model["in_channels"]):
        if c["name"] == "stem":
            n = 1
            for s in c["grid"]:
                n *= sum(1 for o in range(out_size(s, 7, 2, 1)) for t in range(7)
                         if 0 <= o * 2 - 3 + t < s)
            ops["stem"] += 2.0 * n * c["c_in"] * c["c_out"]
        else:
            ops["blocks"] += k3_work(1, c["grid"], c["c_in"], c["c_out"], c["k"],
                                     c["stride"], c["dil"])[0]
    return ops


def k3_launches(depth: int, shape, batch: int) -> list[tuple]:
    """K3's launches in one int8 forward at `batch`: (operations, input
    bytes, M, N, K, output bytes per (M, N) element), in order. Epilogues:
    a block's inner convs write int8, its shortcut conv float32, its last
    conv reads the residual (float32 after a shortcut conv, else the bf16
    identity) and writes bf16 h and, but in the last block, the next int8
    quant point."""
    plan = [c for c in conv_plan(depth, shape) if c["name"] != "stem"]
    n_blocks = len(ref.block_plan(depth))
    out, block = [], -1
    has_down = {c["name"].rsplit(".", 1)[0] for c in plan if c["down"]}
    for c in plan:
        prefix = c["name"].rsplit(".", 1)[0]
        if c["name"].endswith("conv1"):
            block += 1
        ops, in_bytes = k3_work(batch, c["grid"], c["c_in"], c["c_out"], c["k"],
                                c["stride"], c["dil"])
        m = batch
        for s in c["grid"]:
            m *= out_size(s, c["k"], c["stride"], c["dil"])
        if c["down"]:
            per = 4
        elif c["last"]:
            per = (4 if prefix in has_down else 2) + 2 + (1 if block < n_blocks - 1 else 0)
        else:
            per = 1
        out.append((ops, in_bytes, m, c["c_out"], c["k"] ** 3 * c["c_in"], per))
    return out
