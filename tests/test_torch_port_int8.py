"""Port parity on the CPU for the int8 serving slice, against the JAX
package on the same numpy-seeded inputs and converted weights:

- K3's plain version (`conv_i8_plain`) against `_conv_i8`, and its
  epilogues against `_quantize` and the dequant expression: bit-equal;
- `export_int8` on converted weights: bit-equal (BasicBlock with shortcuts
  A and B, Bottleneck);
- the int8 blocks fed the JAX package's own stem output: every quant point
  bit-equal, logits within 1e-5 absolute or relative (the mean and the
  head's matmul sum in another order);
- whole forwards from the input: the int8 logits within 1e-4 of the logit
  spread (2.7e-6 measured). The folded graph's block convolutions and the
  calibration run bf16 convolutions whose float32 accumulation runs in
  another order in XLA and in PyTorch, so the folded logits are held to
  2e-2 of the spread (5.5e-3 measured), the calibrated scales to a
  relative 2e-2 (8.5e-3 measured), and argmax exactly;
- the `.npz` files of `save_int8` read by the other package's `load_int8`,
  both ways, arrays equal;
- `EnsemblePredictor.quantize_int8` probabilities on two folds within 1e-3
  of the JAX predictor's (1.0e-4 measured);
- the folded forward against the port's eval-mode ResNet3D (the
  tolerances of tests/test_int8.py), and a trained model's held-out AUC
  kept within 0.01 by int8 (trained with the port's train/loop.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_ad_tpu.models import resnet3d_int8 as jq8
from multimodal_ad_tpu.models.resnet3d import ResNet3D as JaxResNet3D
from multimodal_ad_tpu.serve import EnsemblePredictor as JaxPredictor
from multimodal_ad_tpu_torch.models import resnet3d_int8 as tq8
from multimodal_ad_tpu_torch.models.resnet3d import generate_model
from multimodal_ad_tpu_torch.ops import int8_conv as k3
from multimodal_ad_tpu_torch.serve import EnsemblePredictor
from multimodal_ad_tpu_torch.train.metrics import binary_auc
from multimodal_ad_tpu_torch.utils.torch_weights import state_dict_from_flax
from test_torch_port_support import cap_torch_threads

cap_torch_threads()

SHAPE = (16, 20, 16)


def random_flax_variables(model, shape, seed):
    """Seeded numpy variables: He-normal kernels, BN scale and var in
    [0.5, 1.5], BN bias and mean ~ N(0, 0.1)."""
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, *shape), jnp.float32),
        train=False))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return rng.normal(0, 0.1, s.shape).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.normal(size=s.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)

    v = jax.tree_util.tree_map_with_path(fill, shapes)
    return {"params": v["params"], "batch_stats": v["batch_stats"]}


def _model_and_variables(depth, sc, seed):
    jm = JaxResNet3D(depth=depth, num_classes=2, shortcut_type=sc, dropout_rate=0.0)
    v = random_flax_variables(jm, (*SHAPE, 1), seed)
    sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, v), depth, sc)
    return jm, v, sd


def _inputs(n, seed):
    return np.random.default_rng(seed).normal(size=(n, *SHAPE, 1)).astype(np.float32)


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


# ---- K3's plain version -----------------------------------------------------


@pytest.mark.parametrize("ksize,stride,dil", [(3, 1, 1), (3, 2, 1), (3, 1, 2), (3, 1, 4),
                                              (3, 2, 2), (1, 1, 1), (1, 2, 1)])
@pytest.mark.parametrize("c_in", [32, 64])
def test_conv_plain_matches_conv_i8(ksize, stride, dil, c_in):
    """Odd grids, full-range int8 values (and one saturated corner)."""
    rng = np.random.default_rng(ksize * 100 + stride * 10 + dil + c_in)
    x = rng.integers(-127, 128, (2, 7, 9, 5, c_in), dtype=np.int8)
    x[0, :3, :3, :3] = 127
    w = rng.integers(-127, 128, (ksize,) * 3 + (c_in, 24), dtype=np.int8)
    w[..., 0] = 127
    ref = np.asarray(jq8._conv_i8(jnp.asarray(x), jnp.asarray(w), stride, dil, ksize))
    ours = k3.conv_i8(torch.from_numpy(x), k3.relayout_weight(torch.from_numpy(w)),
                      stride, dil)
    assert ours.dtype == torch.int32 and ours.shape == ref.shape
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_epilogues_match_the_tpu_expressions():
    """Dequant (float32 out) and dequant + ReLU + requant (int8 out) on the
    same int32 sums, against the TPU package's expressions run op by op:
    bit-equal, including sums above 2**24 (rounded to float32) and exact
    halves (round half to even)."""
    rng = np.random.default_rng(3)
    acc = rng.integers(-3_000_000, 3_000_000, (3, 5, 4, 6, 16)).astype(np.int32)
    acc[0, 0, 0, 0] = np.arange(16) + 2 ** 24 + 1
    s_act = 0.0123456789  # a Python float, as calibrate_int8 returns
    s_w = rng.uniform(1e-4, 1e-2, 16).astype(np.float32)
    b = rng.normal(0, 0.5, 16).astype(np.float32)
    s_next = 0.0713
    k = torch.tensor(s_act, dtype=torch.float32) * torch.from_numpy(s_w)
    ref = jnp.asarray(acc).astype(jnp.float32) * (s_act * s_w) + b
    got = k3.epilogue_plain(torch.from_numpy(acc), "float32", k, torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    got = k3.epilogue_plain(torch.from_numpy(acc), "int8", k, torch.from_numpy(b), s_next)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jq8._quantize(jax.nn.relu(ref),
                                                                        s_next)))
    # exact halves: h = o + 0.5 with s_next 1 rounds to even both ways
    ones, half = np.ones(16, np.float32), np.full(16, 0.5, np.float32)
    small = np.arange(-16, 144, dtype=np.int32).reshape(10, 16)
    ref = jq8._quantize(jax.nn.relu(jnp.asarray(small).astype(jnp.float32) * ones + half), 1.0)
    got = k3.epilogue_plain(torch.from_numpy(small), "int8", torch.from_numpy(ones),
                            torch.from_numpy(half), 1.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ties = got.numpy()[(small >= 0) & (small < 126)]
    assert (ties % 2 == 0).all() and got.numpy().max() == 127


def test_conv_i8_rejects_what_it_does_not_take():
    x = torch.zeros((1, 4, 4, 4, 32), dtype=torch.int8)
    w = torch.zeros((8, 3, 3, 3, 32), dtype=torch.int8)
    with pytest.raises(TypeError):
        k3.conv_i8(x.float(), w)
    with pytest.raises(ValueError):  # channel mismatch
        k3.conv_i8(x, w[..., :16])
    with pytest.raises(ValueError):  # kernel size 2
        k3.conv_i8(x, torch.zeros((8, 2, 2, 2, 32), dtype=torch.int8))
    with pytest.raises(ValueError):  # epilogue without its vectors
        k3.conv_i8(x, w, epilogue="float32")
    with pytest.raises(ValueError):
        k3.conv_i8(x, w, epilogue="int4")
    assert k3.conv_i8(x, w).shape == (1, 4, 4, 4, 8)


# ---- export -------------------------------------------------------------------


def _assert_same_array(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _assert_same_qp(ours, ref, with_fp=True):
    for key in ("kernel", "g", "b"):
        _assert_same_array(ours["stem"][key], ref["stem"][key], f"stem {key}")
    assert ours["shortcut_type"] == ref["shortcut_type"]
    assert (ours["dense"] is None) == (ref["dense"] is None)
    if ref["dense"] is not None:
        for key in ("kernel", "bias"):
            _assert_same_array(ours["dense"][key], ref["dense"][key], f"dense {key}")
    assert len(ours["blocks"]) == len(ref["blocks"])
    for i, (a, b) in enumerate(zip(ours["blocks"], ref["blocks"])):
        for key in ("kind", "stride", "dilation", "planes"):
            assert a[key] == b[key], (i, key)
        assert isinstance(a["down"], dict) == isinstance(b["down"], dict)
        if not isinstance(b["down"], dict):
            assert a["down"] == b["down"]
        for name in ("conv1", "conv2", "conv3", "down"):
            if not isinstance(b.get(name), dict):
                assert not isinstance(a.get(name), dict), (i, name)
                continue
            keys = ("wq", "s", "b") + (("w_fp",) if with_fp else ())
            for key in keys:
                _assert_same_array(a[name][key], b[name][key], f"block {i} {name} {key}")


@pytest.mark.parametrize("depth,sc", [(10, "B"), (10, "A"), (50, "B")])
def test_export_matches_jax(depth, sc):
    """Folded, quantized and shadow kernels, scales, biases, the stem's
    affine, the head and the geometry: bit-equal on converted weights."""
    _, v, sd = _model_and_variables(depth, sc, seed=depth)
    ref = jq8.export_int8(v, depth=depth, shortcut_type=sc)
    ours = tq8.export_int8(sd, depth=depth, shortcut_type=sc)
    _assert_same_qp(ours, ref)
    assert tq8.block_scale_keys(ours) == jq8._block_scale_keys(ref)
    if depth == 50:
        assert all(b["kind"] == "bottleneck" for b in ours["blocks"])
    if sc == "A":
        assert any(b["down"] == "A" for b in ours["blocks"])


# ---- forwards -------------------------------------------------------------------


def _jax_blocks(qp, scales, h):
    """The TPU package's _forward block loop (quantized), op by op with its
    own primitives, keeping every int8 quant point."""
    taps = []

    def qconv(inp, kd, stride, dil, ksize, s_act):
        o = jq8._conv_i8(inp, jnp.asarray(kd["wq"]), stride, dil, ksize)
        return o.astype(jnp.float32) * (s_act * kd["s"]) + kd["b"]

    for i, blk in enumerate(qp["blocks"]):
        stride, dil = blk["stride"], blk["dilation"]
        s_in, s_mid = scales[f"b{i}_in"], scales[f"b{i}_mid"]
        hq = jq8._quantize(h, s_in)
        if blk["kind"] == "bottleneck":
            aq = jq8._quantize(jax.nn.relu(qconv(hq, blk["conv1"], 1, 1, 1, s_in)), s_mid)
            s_mid2 = scales[f"b{i}_mid2"]
            a2q = jq8._quantize(jax.nn.relu(qconv(aq, blk["conv2"], stride, dil, 3, s_mid)),
                                s_mid2)
            o = qconv(a2q, blk["conv3"], 1, 1, 1, s_mid2)
            taps += [hq, aq, a2q]
        else:
            aq = jq8._quantize(jax.nn.relu(qconv(hq, blk["conv1"], stride, dil, 3, s_in)),
                               s_mid)
            o = qconv(aq, blk["conv2"], 1, dil, 3, s_mid)
            taps += [hq, aq]
        if blk["down"] is None:
            r = h.astype(jnp.float32)
        elif blk["down"] == "A":
            r = jq8._shortcut_a(h.astype(jnp.float32), blk["planes"], stride)
        else:
            r = qconv(hq, blk["down"], stride, 1, 1, s_in)
        h = jax.nn.relu(o + r).astype(jnp.bfloat16)
    return taps


@pytest.fixture(scope="module", params=[(10, "B", 21), (10, "A", 22), (50, "B", 23)],
                ids=["d10B", "d10A", "d50B"])
def jax_int8(request):
    """A depth-10 B, 10 A or 50 B export, calibrated by the JAX package,
    with its stem output and its (eager) int8 and folded logits."""
    depth, sc, seed = request.param
    _, v, sd = _model_and_variables(depth, sc, seed)
    qp = jq8.export_int8(v, depth=depth, shortcut_type=sc)
    cal, x = _inputs(2, seed + 1), _inputs(2, seed + 2)
    scales = jq8.calibrate_int8(qp, [cal])
    return {"depth": depth, "sc": sc, "sd": sd, "qp": qp, "cal": cal, "x": x,
            "scales": scales, "stem": _f32(jq8._stem_bf16(qp, jnp.asarray(x))),
            "int8": _f32(jq8.resnet3d_int8_apply(qp, scales, jnp.asarray(x))),
            "folded": _f32(jq8.resnet3d_folded_apply(qp, jnp.asarray(x)))}


def test_blocks_from_the_jax_stem_are_bit_equal(jax_int8):
    ref = jax_int8
    depth, sc = ref["depth"], ref["sc"]
    h = torch.from_numpy(ref["stem"]).to(torch.bfloat16)
    net = tq8.ResNet3DInt8(tq8.export_int8(ref["sd"], depth, sc), ref["scales"])
    taps = []
    with torch.inference_mode():
        out, _ = net.blocks_forward(h, quantized=True, taps=taps)
        logits = net.head(out).numpy()
    jtaps = _jax_blocks(ref["qp"], ref["scales"], jnp.asarray(ref["stem"], jnp.bfloat16))
    assert len(taps) == len(jtaps) == len(net.scale_keys)
    for key, a, b in zip(net.scale_keys, taps, jtaps):
        assert a.dtype == torch.int8
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=key)
    np.testing.assert_allclose(logits, ref["int8"], rtol=1e-5, atol=1e-5)


def test_forwards_and_calibration_track_jax(jax_int8):
    ref = jax_int8
    depth, sc = ref["depth"], ref["sc"]
    qp = tq8.export_int8(ref["sd"], depth, sc)
    scales = tq8.calibrate_int8(qp, [torch.from_numpy(ref["cal"])])
    assert list(scales) == list(ref["scales"])
    rel = max(abs(scales[k] / ref["scales"][k] - 1) for k in scales)
    assert rel <= 2e-2, rel
    x = torch.from_numpy(ref["x"])
    stem = tq8.ResNet3DInt8(qp).stem(x).float().numpy()
    np.testing.assert_allclose(stem, ref["stem"], rtol=2 ** -7, atol=2 ** -7)
    for name, ours, tol in (("int8", tq8.resnet3d_int8_apply(qp, ref["scales"], x), 1e-4),
                            ("folded", tq8.resnet3d_folded_apply(qp, x), 2e-2)):
        ours = ours.numpy()
        spread = np.abs(ref[name]).max()
        assert np.abs(ours - ref[name]).max() <= tol * spread, (name, ours, ref[name])
        np.testing.assert_array_equal(ours.argmax(1), ref[name].argmax(1))


@pytest.mark.parametrize("depth,sc,atol", [(10, "B", 0.15), (10, "A", 0.15), (50, "B", 0.2)])
def test_folded_forward_matches_eval_mode(depth, sc, atol):
    """BN folding and topology: the folded bf16 graph against the port's
    eval-mode ResNet3D (bf16 autocast), at tests/test_int8.py's bounds."""
    _, _, sd = _model_and_variables(depth, sc, seed=depth + 40)
    model = generate_model(model_depth=depth, resnet_shortcut=sc, dropout_rate=0.0)
    model.load_state_dict(sd)
    x = torch.from_numpy(_inputs(3, seed=depth))
    with torch.inference_mode():
        ref = model.eval()(x).numpy()
        fold = tq8.resnet3d_folded_apply(tq8.export_int8(sd, depth, sc), x).numpy()
    assert fold.shape == ref.shape == (3, 2)
    np.testing.assert_allclose(fold, ref, atol=atol, rtol=0.05)


def test_npz_files_interchange(jax_int8, tmp_path):
    """The JAX package's save_int8 file loads here and ours loads there:
    same arrays, same scales; the loaded artifact gives the same int8
    logits as the in-memory export."""
    ref = jax_int8
    ours = tq8.export_int8(ref["sd"], ref["depth"], ref["sc"])
    jpath = jq8.save_int8(str(tmp_path / "jax.npz"), ref["qp"], ref["scales"])
    qp, scales = tq8.load_int8(jpath)
    assert scales == ref["scales"]
    _assert_same_qp(qp, tq8.strip_fp(ours), with_fp=False)
    tpath = tq8.save_int8(str(tmp_path / "port.npz"), ours, ref["scales"])
    qp2, scales2 = jq8.load_int8(tpath)
    assert scales2 == ref["scales"]
    _assert_same_qp(qp2, jq8.strip_fp(ref["qp"]), with_fp=False)
    x = torch.from_numpy(ref["x"])
    np.testing.assert_array_equal(tq8.resnet3d_int8_apply(qp, scales, x).numpy(),
                                  tq8.resnet3d_int8_apply(ours, ref["scales"], x).numpy())


def test_quantize_int8_matches_jax_predictor():
    """Two depth-10 folds: calibration through each package's own
    preprocessing, then int8 probabilities within 1e-3, labels equal."""
    jm = JaxResNet3D(depth=10, num_classes=2, dropout_rate=0.0)
    fold_vars = [random_flax_variables(jm, (*SHAPE, 1), seed) for seed in (31, 32)]
    sds = [state_dict_from_flax(jax.tree_util.tree_map(np.asarray, v), 10, "B")
           for v in fold_vars]
    rng = np.random.default_rng(33)
    cal = rng.normal(100, 30, size=(3, *SHAPE)).astype(np.float32)
    vols = rng.normal(100, 30, size=(5, *SHAPE)).astype(np.float32)
    ref = JaxPredictor(jm, fold_vars, batch_size=4).quantize_int8(cal).predict_proba(vols)
    port = EnsemblePredictor(generate_model(model_depth=10), sds, batch_size=4, device="cpu")
    assert port.quantize_int8(cal) is port and len(port.int8_folds) == 2
    proba = port.predict_proba(vols)
    assert proba.shape == (5, 2) and proba.dtype == np.float32
    np.testing.assert_allclose(proba, ref, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(proba.argmax(1), ref.argmax(1))


def test_int8_preserves_trained_auc():
    """tests/test_int8.py's proof, trained with the port's loop: a depth-10
    net learns to separate two classes at 12x16x12 (held-out AUC >= 0.9),
    then int8 keeps the held-out AUC within 0.01."""
    from multimodal_ad_tpu_torch.train import loop

    shape = (12, 16, 12)

    def make_data(n, seed):
        r = np.random.default_rng(seed)
        y = r.integers(0, 2, n)
        x = r.normal(size=(n, *shape, 1)).astype(np.float32)
        x[:, 4:8, 6:10, 4:8, :] += (y * 1.5)[:, None, None, None, None]
        return x, y

    xtr, ytr = make_data(24, 1)
    xte, yte = make_data(16, 2)
    model = generate_model(model_depth=10, dropout_rate=0.0, compute_dtype=torch.float32,
                           generator=torch.Generator().manual_seed(0))
    state = loop.create_train_state(model, lambda _: 3e-3, 0.0, grad_clip_norm=0.0)
    rng = np.random.default_rng(0)
    for _ in range(12):
        j = rng.permutation(24)[:8]
        loop.train_step(state, {"image": torch.from_numpy(xtr[j]),
                                "label": torch.from_numpy(ytr[j]),
                                "mask": torch.ones(8)}, torch.ones(2))
    pred = EnsemblePredictor(model, [model.state_dict()], batch_size=8, device="cpu")
    auc_fp = binary_auc(yte, pred.predict_proba(xte, preprocess=False)[:, 1])
    assert auc_fp >= 0.9, f"model failed to learn (AUC {auc_fp:.3f})"
    pred.quantize_int8(xtr[:4], preprocess=False)
    auc_q8 = binary_auc(yte, pred.predict_proba(xte, preprocess=False)[:, 1])
    assert abs(auc_q8 - auc_fp) <= 0.01, (auc_q8, auc_fp)
