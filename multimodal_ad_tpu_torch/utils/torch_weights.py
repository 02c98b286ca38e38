"""Weight conversion for the 3D ResNets.

- `resnet3d_name_map` (own copy of the TPU package's map) pairs every
  MedicalNet state_dict name with its place in the TPU package's flax
  variables ({'params', 'batch_stats'}).
- `state_dict_from_flax` turns those variables (nested dicts of numpy
  arrays) into this package's ResNet3D state_dict: conv kernels DHWIO ->
  OIDHW, BatchNorm scale/bias/mean/var -> weight/bias/running_mean/
  running_var, and the classifier head's Dense kernel transposed into
  conv_seg.3.
- `load_optax_adam_state` loads the TPU package's Adam moments (optax
  ScaleByAdamState mu / nu / count) into a torch Adam or AdamW over this
  package's ResNet3D, so a fold trained there resumes here;
- `load_medicalnet_weights` merges a MedicalNet checkpoint into a model by
  key intersection (the reference's partial-transfer semantics), with a
  report of loaded / skipped / mismatched names.
- `unet3d_state_dict_from_flax` and `unet3d_classifier_state_dict_from_flax`
  turn the TPU package's UNet3D and UNet3DClassifier variables into this
  package's state_dicts (`unet3d_name_map`, `unet3d_classifier_name_map`
  pair the names). A flax ConvTranspose kernel (kx, ky, kz, in, out)
  becomes (in, out, kx, ky, kz) *flipped in all three spatial axes*:
  flax's ConvTranspose (transpose_kernel=False) equals
  torch.nn.functional.conv_transpose3d only with the kernel flipped. The
  classifier's Dense kernel is transposed; its up steps concatenate
  [skip, x] in both packages, so their convs map as they are.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..models.resnet3d import DEPTH_BLOCKS


def _to_dhwio(w):
    return np.transpose(w, (2, 3, 4, 1, 0))  # OIDHW -> DHWIO


def _to_oidhw(w):
    return np.transpose(w, (4, 3, 0, 1, 2))  # DHWIO -> OIDHW


def _bn_rows(tname: str, fpath: tuple) -> list:
    """The four rows of one BatchNorm (scale/bias, mean/var)."""
    return [(f"{tname}.weight", "params", fpath + ("scale",), None),
            (f"{tname}.bias", "params", fpath + ("bias",), None),
            (f"{tname}.running_mean", "batch_stats", fpath + ("mean",), None),
            (f"{tname}.running_var", "batch_stats", fpath + ("var",), None)]


def _conv_entries(torch_prefix, flax_path_conv, flax_path_bn):
    """(torch_name, flax_collection, flax_path, transform) rows for one
    conv+bn pair; `transform` maps the torch tensor to the flax layout."""
    conv, bn = torch_prefix
    return ([(f"{conv}.weight", "params", flax_path_conv + ("kernel",), _to_dhwio)]
            + _bn_rows(bn, flax_path_bn))


def _to_flax_convtranspose(w):
    """torch ConvTranspose3d (in, out, kx, ky, kz) -> flax ConvTranspose
    (kx, ky, kz, in, out), flipped spatially (the inverse of
    `_flip_convtranspose`)."""
    return np.transpose(w[:, :, ::-1, ::-1, ::-1], (2, 3, 4, 0, 1))


def resnet3d_name_map(depth: int, shortcut_type: str = "B",
                      head: str = "classifier") -> list:
    """Ordered (torch_name, collection, flax_path, transform) mapping for
    the MedicalNet ResNet backbone (conv1/bn1, layer{1..4}.{j}.conv{i}/bn{i},
    downsample.0/1); `transform` maps the torch tensor to the flax layout.
    With ``head="seg"`` the seg head's rows follow: conv_seg.0 (transposed
    conv, with bias), .1 (BN), .3 (conv), .4 (BN), .6 (conv) <-> the flax
    SegHead_0's ConvTranspose_0, BatchNorm_0, Conv_0, BatchNorm_1, Conv_1."""
    kind, layers = DEPTH_BLOCKS[depth]
    block_name = "BasicBlock" if kind == "basic" else "Bottleneck"
    n_convs = 2 if kind == "basic" else 3

    rows = _conv_entries(("conv1", "bn1"), ("Conv_0",), ("BatchNorm_0",))

    stage_spec = [(64, 1), (128, 2), (256, 1), (512, 1)]  # (planes, stride)
    block_idx = 0
    in_features = 64
    expansion = 1 if kind == "basic" else 4
    for si, ((planes, stride), n_blocks) in enumerate(zip(stage_spec, layers)):
        for bj in range(n_blocks):
            tp = f"layer{si + 1}.{bj}"
            fp = f"{block_name}_{block_idx}"
            for ci in range(n_convs):
                rows += _conv_entries(
                    (f"{tp}.conv{ci + 1}", f"{tp}.bn{ci + 1}"),
                    (fp, f"ConvBN_{ci}", "Conv_0"),
                    (fp, f"ConvBN_{ci}", "BatchNorm_0"))
            out_features = planes * expansion
            first_stride = stride if bj == 0 else 1
            if (first_stride != 1 or in_features != out_features) \
                    and shortcut_type != "A":
                rows += _conv_entries(
                    (f"{tp}.downsample.0", f"{tp}.downsample.1"),
                    (fp, f"ConvBN_{n_convs}", "Conv_0"),
                    (fp, f"ConvBN_{n_convs}", "BatchNorm_0"))
            in_features = out_features
            block_idx += 1
    if head == "seg":
        seg = ("SegHead_0",)
        rows += [("conv_seg.0.weight", "params", seg + ("ConvTranspose_0", "kernel"),
                  _to_flax_convtranspose),
                 ("conv_seg.0.bias", "params", seg + ("ConvTranspose_0", "bias"), None)]
        rows += _bn_rows("conv_seg.1", seg + ("BatchNorm_0",))
        rows += _conv_entries(("conv_seg.3", "conv_seg.4"), seg + ("Conv_0",),
                              seg + ("BatchNorm_1",))
        rows.append(("conv_seg.6.weight", "params", seg + ("Conv_1", "kernel"), _to_dhwio))
    return rows


HEAD_NAMES = ("conv_seg.3.weight", "conv_seg.3.bias")


def _get_path(tree, path: tuple):
    node = tree
    for p in path:
        node = node[p]
    return node


def state_dict_from_flax(variables, depth: int, shortcut_type: str = "B",
                         head: str = "classifier") -> "OrderedDict[str, torch.Tensor]":
    """TPU-package ResNet3D variables -> this package's ResNet3D state_dict.

    `variables` is {'params': ..., 'batch_stats': ...} as nested dicts of
    arrays. The classifier head (flax 'Dense_0') becomes conv_seg.3 when
    present; with ``head="seg"`` the SegHead_0 becomes conv_seg.{0,1,3,4,6}.
    Every BatchNorm also gets its num_batches_tracked buffer (0), so the
    result loads with strict=True."""
    return _resnet3d_from_flax(variables, depth, shortcut_type,
                               ("params", "batch_stats"), head)


def _resnet3d_from_flax(variables, depth, shortcut_type, collections, head="classifier"):
    from_flax = {_to_dhwio: _to_oidhw, _to_flax_convtranspose: _flip_convtranspose}
    out = OrderedDict()
    for tname, coll, fpath, tf in resnet3d_name_map(depth, shortcut_type, head):
        if coll not in collections:
            continue
        w = np.asarray(_get_path(variables[coll], fpath), np.float32)
        if tf is not None:
            w = from_flax[tf](w)
        out[tname] = torch.from_numpy(np.array(w, order="C"))  # own copy
        if tname.endswith(".running_var"):
            out[tname[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(0, dtype=torch.long)
    dense = variables["params"].get("Dense_0")
    if dense is not None:
        out[HEAD_NAMES[0]] = torch.from_numpy(
            np.array(np.asarray(dense["kernel"], np.float32).T, order="C"))
        out[HEAD_NAMES[1]] = torch.from_numpy(
            np.array(dense["bias"], np.float32))
    return out


def load_optax_adam_state(optimizer: torch.optim.Optimizer, model, mu, nu,
                          count) -> torch.optim.Optimizer:
    """Load the TPU package's Adam moments into `optimizer` (a torch Adam or
    AdamW over `model.parameters()`, `model` this package's ResNet3D).

    `mu` and `nu` are the optax ScaleByAdamState's first and second
    moments, flax parameter trees (nested dicts of arrays) laid out as the
    model's 'params'; `count` is its update count. Each moment is
    converted as its parameter is (kernels DHWIO -> OIDHW, the Dense kernel
    transposed) into torch's exp_avg / exp_avg_sq, with step = count."""
    names = {id(p): n for n, p in model.named_parameters()}
    moments = [_resnet3d_from_flax({"params": m}, model.depth, model.shortcut_type,
                                   ("params",), model.head) for m in (mu, nu)]
    step = float(np.asarray(count))
    for group in optimizer.param_groups:
        # torch keeps a fused or capturable optimizer's step on the device
        on_device = group.get("fused") or group.get("capturable")
        for p in group["params"]:
            name = names[id(p)]
            optimizer.state[p] = {
                "step": torch.tensor(step, dtype=torch.float32,
                                     device=p.device if on_device else "cpu"),
                "exp_avg": moments[0][name].to(p.device, p.dtype),
                "exp_avg_sq": moments[1][name].to(p.device, p.dtype)}
    return optimizer


def load_torch_state_dict(path: str) -> dict:
    """Read a MedicalNet-style checkpoint ({'state_dict': ...} or a bare
    state_dict); strips DataParallel 'module.' prefixes. Loads tensors
    only (weights_only), since the file comes from outside."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt.get("state_dict", ckpt)
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in state.items()}


def load_medicalnet_weights(model, state_dict: dict, verbose: bool = False):
    """Merge the intersecting backbone tensors of `state_dict` into `model`
    (a ResNet3D): names of the backbone map present in the checkpoint with
    the same shape are loaded, the rest keep their init. Returns
    (model, report) with report = {'loaded', 'skipped', 'mismatched'}."""
    own = model.state_dict()
    merged, loaded, skipped, mismatched = {}, [], [], []
    for tname, *_ in resnet3d_name_map(model.depth, model.shortcut_type, model.head):
        if tname not in state_dict or tname not in own:
            skipped.append(tname)
            continue
        w = torch.as_tensor(state_dict[tname])
        if tuple(w.shape) != tuple(own[tname].shape):
            mismatched.append((tname, tuple(own[tname].shape), tuple(w.shape)))
            continue
        merged[tname] = w.to(own[tname].dtype)
        loaded.append(tname)
    model.load_state_dict(merged, strict=False)
    if verbose:
        print(f"[medicalnet] loaded {len(loaded)} tensors, "
              f"skipped {len(skipped)}, mismatched {len(mismatched)}")
    return model, {"loaded": loaded, "skipped": skipped,
                   "mismatched": mismatched}


# UNet3D: this package's module name -> the TPU package's flax module name
_UNET_BLOCKS = (("enc1", "ConvBlock3D_0"), ("enc2", "ConvBlock3D_1"),
                ("enc3", "ConvBlock3D_2"), ("bottleneck", "ConvBlock3D_3"),
                ("dec3", "UpBlock3D_0"), ("dec2", "UpBlock3D_1"),
                ("head_block", "head_block"))


def _flip_convtranspose(w):
    """flax ConvTranspose (kx, ky, kz, in, out) -> torch (in, out, kx, ky,
    kz), flipped spatially."""
    return np.transpose(w, (3, 4, 0, 1, 2))[:, :, ::-1, ::-1, ::-1]


def _upconv_rows(tname: str, fpath: tuple) -> list:
    return [(f"{tname}.weight", "params", fpath + ("kernel",), _flip_convtranspose),
            (f"{tname}.bias", "params", fpath + ("bias",), None)]


def _double_conv_rows(tname: str, fname: str) -> list:
    """conv1/bn1, conv2/bn2 of a double-conv block <-> Conv_0/BatchNorm_0,
    Conv_1/BatchNorm_1 of the flax module `fname`."""
    rows = []
    for i in (0, 1):
        conv, bn = (fname, f"Conv_{i}"), (fname, f"BatchNorm_{i}")
        rows += [(f"{tname}.conv{i + 1}.weight", "params", conv + ("kernel",), _to_oidhw),
                 (f"{tname}.conv{i + 1}.bias", "params", conv + ("bias",), None),
                 (f"{tname}.bn{i + 1}.weight", "params", bn + ("scale",), None),
                 (f"{tname}.bn{i + 1}.bias", "params", bn + ("bias",), None),
                 (f"{tname}.bn{i + 1}.running_mean", "batch_stats", bn + ("mean",), None),
                 (f"{tname}.bn{i + 1}.running_var", "batch_stats", bn + ("var",), None)]
    return rows


def unet3d_name_map() -> list:
    """Ordered (torch_name, flax_collection, flax_path, transform) rows of
    the UNet3D; `transform` maps the flax array to the torch layout."""
    rows = []
    for tname, fname in _UNET_BLOCKS:
        if not tname.startswith(("enc", "bottleneck")):
            rows += _upconv_rows(f"{tname}.upconv", (fname, "ConvTranspose_0"))
        rows += _double_conv_rows(tname, fname)
    rows += [("head_block.head.weight", "params", ("head_block", "Conv_2", "kernel"), _to_oidhw),
             ("head_block.head.bias", "params", ("head_block", "Conv_2", "bias"), None)]
    return rows


def unet3d_classifier_name_map() -> list:
    """Ordered (torch_name, flax_collection, flax_path, transform) rows of
    the UNet3DClassifier: enc1-4 and bottleneck are the flax blocks
    UNetClassifierConvBlock_0-4; up4..up1 the ConvTranspose_0-3 and blocks
    5-8 their `up` steps create in turn; fc is Dense_0."""
    encoders = ("enc1", "enc2", "enc3", "enc4", "bottleneck")
    rows = []
    for i, tname in enumerate(encoders):
        rows += _double_conv_rows(tname, f"UNetClassifierConvBlock_{i}")
    for i, tname in enumerate(("up4", "up3", "up2", "up1")):
        rows += _upconv_rows(f"{tname}.upconv", (f"ConvTranspose_{i}",))
        rows += _double_conv_rows(f"{tname}.block", f"UNetClassifierConvBlock_{5 + i}")
    rows += [("fc.weight", "params", ("Dense_0", "kernel"), np.transpose),
             ("fc.bias", "params", ("Dense_0", "bias"), None)]
    return rows


def _state_dict_from_rows(variables, rows) -> "OrderedDict[str, torch.Tensor]":
    """Convert `variables` ({'params', 'batch_stats'} as nested dicts of
    arrays) by a name map's rows into a state_dict loadable with
    strict=True (each BatchNorm also gets num_batches_tracked = 0)."""
    out = OrderedDict()
    for tname, coll, fpath, tf in rows:
        w = np.asarray(_get_path(variables[coll], fpath), np.float32)
        if tf is not None:
            w = tf(w)
        out[tname] = torch.from_numpy(np.array(w, order="C"))  # own copy
        if tname.endswith(".running_var"):
            out[tname[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(0, dtype=torch.long)
    return out


def unet3d_state_dict_from_flax(variables) -> "OrderedDict[str, torch.Tensor]":
    """TPU-package UNet3D variables -> this package's UNet3D state_dict."""
    return _state_dict_from_rows(variables, unet3d_name_map())


def unet3d_classifier_state_dict_from_flax(variables) -> "OrderedDict[str, torch.Tensor]":
    """TPU-package UNet3DClassifier variables -> this package's
    UNet3DClassifier state_dict."""
    return _state_dict_from_rows(variables, unet3d_classifier_name_map())


def _conv_kernel_to_torch(w):
    """flax conv kernel (*k, in / groups, out) -> torch (out, in / groups, *k),
    2-D or 3-D."""
    return np.transpose(w, (w.ndim - 1, w.ndim - 2, *range(w.ndim - 2)))


def _kernel_row(tname: str, fpath: tuple) -> tuple:
    return (f"{tname}.weight", "params", fpath + ("kernel",), _conv_kernel_to_torch)


def densenet_name_map(block_config=(6, 12, 24, 16)) -> list:
    """Ordered (torch_name, flax_collection, flax_path, transform) rows of
    the DilatedDenseNet (2-D or 3-D). flax numbers each module class across
    the whole model: DenseLayer_0.. over all blocks, Transition_0..; the
    stem is Conv_0 / BatchNorm_0, the final norm BatchNorm_1, the
    classifier Dense_0; inside a dense layer BatchNorm_0, Conv_0,
    BatchNorm_1, Conv_1 (the depthwise conv) and Conv_2."""
    rows = [_kernel_row("conv0", ("Conv_0",))] + _bn_rows("norm0", ("BatchNorm_0",))
    layer = 0
    for bi, n_layers in enumerate(block_config):
        for li in range(n_layers):
            t, f = f"block{bi}.{li}", (f"DenseLayer_{layer}",)
            rows += _bn_rows(f"{t}.norm1", f + ("BatchNorm_0",))
            rows.append(_kernel_row(f"{t}.conv1", f + ("Conv_0",)))
            rows += _bn_rows(f"{t}.norm2", f + ("BatchNorm_1",))
            rows.append(_kernel_row(f"{t}.conv2", f + ("Conv_1",)))
            rows.append(_kernel_row(f"{t}.conv3", f + ("Conv_2",)))
            layer += 1
        if bi != len(block_config) - 1:
            t, f = f"transition{bi}", (f"Transition_{bi}",)
            rows += _bn_rows(f"{t}.norm", f + ("BatchNorm_0",))
            rows.append(_kernel_row(f"{t}.conv", f + ("Conv_0",)))
    rows += _bn_rows("norm_final", ("BatchNorm_1",))
    rows += [("classifier.weight", "params", ("Dense_0", "kernel"), np.transpose),
             ("classifier.bias", "params", ("Dense_0", "bias"), None)]
    return rows


def densenet_state_dict_from_flax(variables, block_config=(6, 12, 24, 16)
                                  ) -> "OrderedDict[str, torch.Tensor]":
    """TPU-package DilatedDenseNet variables ({'params', 'batch_stats'} as
    nested dicts of arrays) -> this package's DilatedDenseNet state_dict,
    the BatchNorms' running statistics included."""
    return _state_dict_from_rows(variables, densenet_name_map(block_config))


def _dense_rows(tname: str, fpath: tuple) -> list:
    return [(f"{tname}.weight", "params", fpath + ("kernel",), np.transpose),
            (f"{tname}.bias", "params", fpath + ("bias",), None)]


def mshyper_name_map(n_scales: int = 2, use_attention: bool = True) -> list:
    """Ordered (torch_name, flax_collection, flax_path, transform) rows of
    MSHyperModel: flax Dense kernels (in, out) become nn.Linear weights
    (out, in); a strided flax Conv kernel (w, in, out) a Conv1d weight
    (out, in, w)."""
    p = ("PyramidConstruct_0",)
    rows = _dense_rows("pyramid.embed", p + ("Dense_0",))
    for i in range(n_scales):
        rows += [(f"pyramid.convs.{i}.weight", "params", p + (f"Conv_{i}", "kernel"),
                  _conv_kernel_to_torch),
                 (f"pyramid.convs.{i}.bias", "params", p + (f"Conv_{i}", "bias"), None)]
    if use_attention:
        a = ("HyperedgeAttention_0",)
        rows += _dense_rows("attention.query", a + ("Dense_0",))
        rows += _dense_rows("attention.key", a + ("Dense_1",))
    for tname, fname in (("node_out", "Dense_0"), ("out_tran", "out_tran"),
                         ("trunk", "trunk"), ("mix", "mix")):
        rows += _dense_rows(tname, (fname,))
    return rows


def mshyper_state_dict_from_flax(variables, n_scales: int = 2, use_attention: bool = True
                                 ) -> "OrderedDict[str, torch.Tensor]":
    """TPU-package MSHyperModel variables ({'params': ...}) -> this
    package's MSHyperModel state_dict (`n_scales` = len(window_sizes))."""
    return _state_dict_from_rows(variables, mshyper_name_map(n_scales, use_attention))
