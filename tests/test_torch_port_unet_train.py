"""Port parity on the CPU: the U-Net training slice.

The same seeded numpy inputs go through the JAX package and the port:

- `UNet3DClassifier` eval forward (base 4, fp32, 19x23x27 so that every up
  step's centre pad is hit) on converted weights with randomized BN
  statistics: rtol = atol = 1e-4;
- the `UNet3D` train-mode BatchNorm statistics after one forward against
  flax's ``batch_stats`` (``mutable=["batch_stats"]``): atol 1e-5;
- `cosine_decay_schedule` against optax's over updates 0-30: rel 1e-6, 0
  from update `decay_steps` on;
- three fp32 AdamW steps of the classifier (no clip, unit class weights,
  the per-update cosine) against `make_train_step` and the chain of
  `create_train_state(optimizer="adamw", grad_clip_norm=0.0)`: the first
  step within tests/test_torch_port_train.py's bounds but one (99.7 % of
  the parameters within 1e-5, not 99.9 %), three steps within the bounds
  the test states (float32 gradient noise and Adam's sign-like first
  update, see there); the optimizer alone fed the JAX gradients over three
  updates: rel 1e-5;
- one autoencoder step fed the JAX package's own keep mask against
  `make_ae_steps`: loss rel 1e-4, BN statistics 1e-5, parameters as the
  first classifier step;
- `cli.train_unet3d --device cpu` (with host augmentation) and
  `train_unet_autoencoder` -> `load_autoencoder` -> `extract_unet_features`
  end to end at 16x20x16: split membership equal to the JAX package's,
  the files and columns the JAX package writes.
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_ad_tpu.data import splits as jsplits
from multimodal_ad_tpu.models.unet3d import UNet3D as JaxUNet3D
from multimodal_ad_tpu.models.unet3d import UNet3DClassifier as JaxClassifier
from multimodal_ad_tpu.train import autoencoder as jae
from multimodal_ad_tpu.train import loop as jloop
from multimodal_ad_tpu.utils.logging import CV_CSV_HEADER as JAX_HEADER
from multimodal_ad_tpu_torch.data.synthetic import make_adni_dir
from multimodal_ad_tpu_torch.models.unet3d import UNet3D, UNet3DClassifier
from multimodal_ad_tpu_torch.train import autoencoder as tae
from multimodal_ad_tpu_torch.train import checkpoint as ckpt
from multimodal_ad_tpu_torch.train import loop as tloop
from multimodal_ad_tpu_torch.train import single_split as tss
from multimodal_ad_tpu_torch.utils.torch_weights import (
    unet3d_classifier_name_map, unet3d_classifier_state_dict_from_flax,
    unet3d_state_dict_from_flax)
from test_torch_port_support import cap_torch_threads, default_torch_threads  # noqa: F401

cap_torch_threads()

LR = 1e-3
WD = 1e-4
NARROW = dict(level_channels=(8, 16, 32), bottleneck_channel=64)


def random_variables(model, shape, seed):
    """Seeded numpy variables (no init compile: shapes from eval_shape):
    He-normal kernels, BN scale and var in [0.5, 1.5], biases and BN mean
    ~ N(0, 0.1)."""
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, *shape, 1), jnp.float32),
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


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_classifier(variables):
    tm = UNet3DClassifier(base_ch=4, compute_dtype=torch.float32)
    tm.load_state_dict(unet3d_classifier_state_dict_from_flax(_np(variables)))
    return tm


def test_classifier_forward_matches_jax():
    shape = (19, 23, 27)  # pads at every up step: 1->2|3, 4|6->5|6, 8|12->9|13, ...
    jm = JaxClassifier(num_classes=2, base_ch=4, dtype=jnp.float32)
    variables = random_variables(jm, shape, seed=0)
    x = np.random.default_rng(1).normal(size=(2, *shape, 1)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(x)))
    tm = _port_classifier(variables).eval()
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert out.shape == (2, 2) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)
    names = {k for k in tm.state_dict() if not k.endswith("num_batches_tracked")}
    assert names == {row[0] for row in unet3d_classifier_name_map()}
    assert len(jax.tree_util.tree_leaves(variables)) == len(names)


def test_classifier_defaults_follow_flax():
    """bf16 autocast by default, flax-default init from the generator (one
    seed, one network; the Dense kernel lecun_normal, biases 0)."""
    a, b = (UNet3DClassifier(base_ch=4, generator=torch.Generator().manual_seed(3))
            for _ in range(2))
    assert a.compute_dtype == torch.bfloat16
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
    assert float(a.fc.bias.detach().abs().max()) == 0.0
    assert float(a.fc.weight.detach().abs().max()) <= 2 / 0.87962566103423978 / 2 + 1e-7  # fan_in 4
    logits = a(torch.rand((2, 16, 16, 16, 1)))
    assert logits.dtype == torch.float32 and logits.shape == (2, 2)
    with pytest.raises(ValueError, match="channels"):
        a(torch.rand((1, 16, 16, 16, 2)))


@pytest.mark.usefixtures("default_torch_threads")
def test_unet3d_train_mode_batchnorm_statistics_match_flax():
    """Repair: UNet3D's BatchNorms are FlaxBatchNorm3d, so one train-mode
    forward leaves flax's (biased) running statistics."""
    shape = (12, 14, 10)
    jm = JaxUNet3D(dtype=jnp.float32, **NARROW)
    variables = random_variables(jm, shape, seed=3)
    x = np.random.default_rng(2).normal(size=(2, *shape, 1)).astype(np.float32) * 2 + 1
    _, upd = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    tm = UNet3D(**NARROW).train()
    tm.load_state_dict(unet3d_state_dict_from_flax(_np(variables)))
    tm(torch.from_numpy(x))
    ref = unet3d_state_dict_from_flax(_np({"params": variables["params"],
                                           "batch_stats": upd["batch_stats"]}))
    ours = tm.state_dict()
    stats = [k for k in ref if ".running_" in k]
    assert len(stats) == 28
    for k in stats:
        np.testing.assert_allclose(ours[k].numpy(), ref[k].numpy(), rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("epochs", [1, 2, 15])
def test_cosine_schedule_is_optax(epochs):
    ref = optax.cosine_decay_schedule(LR, epochs)
    ours = tloop.cosine_decay_schedule(LR, epochs)
    for k in range(31):
        assert ours(k) == pytest.approx(float(ref(jnp.int32(k))), rel=1e-6, abs=1e-12)
    assert ours(epochs) == ours(30) == 0.0
    with pytest.raises(ValueError):
        tloop.cosine_decay_schedule(LR, 0)


def _batches(seed, shape, n=3):
    rng = np.random.default_rng(seed)
    return [{"image": rng.random((4, *shape, 1)).astype(np.float32),
             "label": np.array([0, 1, 1, 0], np.int32),
             "mask": np.array([1, 1, 1, 0], np.float32)} for _ in range(n)]


def _pre_bn_bias(name: str) -> str:
    """'enc1.bn1.running_mean' -> 'enc1.conv1.bias', the bias of the conv
    the BatchNorm normalizes."""
    return name.replace(".bn", ".conv").replace(".running_mean", ".bias")


def _deltas(tm, ref_sd):
    """|port - JAX| of every parameter but the conv biases right before a
    BatchNorm (see `_assert_stats_close`), flattened."""
    ours = tm.state_dict()
    return torch.cat([(ours[k] - v).abs().flatten() for k, v in ref_sd.items()
                      if not k.endswith("num_batches_tracked") and ".running_" not in k
                      and not (k.endswith(".bias") and ".conv" in k)])


def _assert_stats_close(tm, ref_sd, bias_deltas=(), tol=1e-5):
    """BatchNorm running statistics within `tol`. A conv bias right before a
    BatchNorm has a gradient of rounding noise (the BatchNorm subtracts it),
    which Adam turns into a step of about lr in the noise's sign, so the two
    packages move it apart; it changes no output, only the running mean, by
    the momentum-weighted bias differences of the forwards after the first
    (`bias_deltas`: port minus JAX after each update but the last)."""
    ours = tm.state_dict()
    t = len(bias_deltas) + 1  # forwards
    for name, v in ref_sd.items():
        if ".running_" not in name:
            continue
        shift = 0.0
        if name.endswith("running_mean"):
            shift = sum(0.1 * 0.9 ** (t - 2 - k) * d[_pre_bn_bias(name)]
                        for k, d in enumerate(bias_deltas))
        np.testing.assert_allclose((ours[name] - shift).numpy(), v.numpy(), rtol=tol,
                                   atol=tol, err_msg=name)


def _conv_bias_deltas(tm, ref_sd):
    ours = tm.state_dict()
    return {k: ours[k] - v for k, v in ref_sd.items() if k.endswith(".bias") and ".conv" in k}


def _jax_adamw_state(jm, variables, decay_steps):
    """The TPU package's create_train_state(optimizer="adamw",
    grad_clip_norm=0.0) chain (`make_optimizer`), over seeded variables
    instead of an init (whose eager CPU run takes most of a minute)."""
    tx = jloop.make_optimizer(optax.cosine_decay_schedule(LR, decay_steps), WD,
                              grad_clip_norm=0.0, kind="adamw")
    return jloop.TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                            opt_state=tx.init(variables["params"]),
                            epoch=jnp.zeros((), jnp.int32), tx=tx, apply_fn=jm.apply)


def test_three_adamw_steps_match_jax():
    """Three fp32 steps of `make_train_step` and of the port's `train_step`
    (base-4 classifier, 16^3, B = 4 with a padded row, unit class weights,
    the cosine over 4 updates, AdamW, no clip).

    The first step holds tests/test_torch_port_train.py's bounds but one:
    loss rel 1e-4 (measured 1.4e-6), probabilities, BN statistics 1e-5,
    parameters within 2 lr, and 99.7 % of them within 1e-5 (measured
    99.76 %; the ResNet test asks 99.9 %). Adam's first update is lr times
    the gradient's sign, and this network's float32 gradients carry
    rounding noise of 1e-5 to 1e-4 of their size (its BatchNorms' backward
    cancels; against float64, the JAX CPU gradients of one conv block are
    off by up to 5.8e-4 relative, the port's by 8.9e-5), so the smallest
    gradients flip sign between the packages. Those moves feed the next
    forwards: after three steps the losses agree to rel 5e-4 (measured
    1.6e-4), the BN statistics to 2e-3 (measured 1.1e-3, at the 1-voxel
    bottleneck) and every parameter to 6 lr."""
    shape = (16, 16, 16)
    jm = JaxClassifier(num_classes=2, base_ch=4, dtype=jnp.float32)
    variables = random_variables(jm, shape, seed=4)
    jstate = _jax_adamw_state(jm, variables, 4)
    tm = _port_classifier(variables)
    tstate = tloop.create_train_state(tm, tloop.cosine_decay_schedule(LR, 4), WD,
                                      grad_clip_norm=0.0, optimizer="adamw")
    step = jloop.make_train_step(2)
    ones = np.ones(2, np.float32)
    bias_deltas = []
    for i, batch in enumerate(_batches(5, shape)):
        jstate, jl, jp = step(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                              jnp.asarray(ones), jax.random.PRNGKey(0))
        tl, tp = tloop.train_step(tstate, {k: torch.from_numpy(v) for k, v in batch.items()},
                                  torch.from_numpy(ones))
        ref = unet3d_classifier_state_dict_from_flax(
            _np({"params": jstate.params, "batch_stats": jstate.batch_stats}))
        d = _deltas(tm, ref)
        if i == 0:
            assert float(tl) == pytest.approx(float(jl), rel=1e-4)
            np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-4, atol=1e-6)
            _assert_stats_close(tm, ref)
            assert float(d.max()) <= 2 * LR
            assert float((d <= 1e-5).float().mean()) >= 0.997
        else:
            assert float(tl) == pytest.approx(float(jl), rel=5e-4)
            np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-3, atol=1e-4)
        if i < 2:
            bias_deltas.append(_conv_bias_deltas(tm, ref))
    assert tstate.step == 3
    assert tstate.optimizer.param_groups[0]["lr"] == pytest.approx(0.5 * LR, rel=1e-6)
    _assert_stats_close(tm, ref, bias_deltas, tol=2e-3)
    assert float(_deltas(tm, ref).max()) <= 6 * LR


def test_three_adamw_updates_on_the_jax_gradients():
    """The optimizer alone, fed the JAX step's own gradients: AdamW, no
    clip, the per-update cosine, three updates; each parameter's total move
    within rel 1e-5 of optax's (optax's float32 bias correction differs from
    torch's float64 one by 6.4e-6 in the first direction), and 5e-7 absolute
    (three float32 roundings of parameters of size up to 1.5)."""
    shape = (12, 12, 12)
    jm = JaxClassifier(num_classes=2, base_ch=4, dtype=jnp.float32)
    variables = random_variables(jm, shape, seed=6)
    jstate = _jax_adamw_state(jm, variables, 3)
    tm = _port_classifier(variables)
    p0 = {k: v.clone() for k, v in tm.state_dict().items()}
    tstate = tloop.create_train_state(tm, tloop.cosine_decay_schedule(LR, 3), WD,
                                      grad_clip_norm=0.0, optimizer="adamw")
    params = dict(tm.named_parameters())

    def loss_fn(p, batch):
        logits, _ = jm.apply({"params": p, "batch_stats": jstate.batch_stats},
                             batch["image"], train=True, mutable=["batch_stats"])
        return jloop.weighted_ce(logits, batch["label"], jnp.ones(2), batch["mask"])

    @jax.jit
    def grad_and_update(params, opt_state, batch):
        g = jax.grad(loss_fn)(params, batch)
        upd, opt_state = jstate.tx.update(g, opt_state, params)
        return g, optax.apply_updates(params, upd), opt_state

    for batch in _batches(7, shape):
        g, new, opt = grad_and_update(jstate.params, jstate.opt_state,
                                      {k: jnp.asarray(v) for k, v in batch.items()})
        jstate = jstate.replace(params=new, opt_state=opt)
        tg = unet3d_classifier_state_dict_from_flax(
            _np({"params": g, "batch_stats": jstate.batch_stats}))
        for name, p in params.items():
            p.grad = tg[name].clone()
        tloop.apply_gradients(tstate)
    ref = unet3d_classifier_state_dict_from_flax(
        _np({"params": jstate.params, "batch_stats": jstate.batch_stats}))
    for name, p in params.items():
        moved = (p.detach() - p0[name]).double()
        np.testing.assert_allclose(moved.numpy(), (ref[name] - p0[name]).double().numpy(),
                                   rtol=1e-5, atol=5e-7, err_msg=name)
    assert tstate.optimizer.param_groups[0]["lr"] == pytest.approx(0.25 * LR, rel=1e-6)


@pytest.mark.usefixtures("default_torch_threads")
def test_autoencoder_step_on_the_jax_mask_matches():
    shape = (12, 12, 12)
    jm = JaxUNet3D(dtype=jnp.float32, **NARROW)
    variables = random_variables(jm, shape, seed=9)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(optax.cosine_decay_schedule(LR, 2)))
    jstate = jloop.TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                              opt_state=tx.init(variables["params"]),
                              epoch=jnp.zeros((), jnp.int32), tx=tx, apply_fn=jm.apply)
    batch = _batches(6, shape, n=1)[0]
    key = jax.random.PRNGKey(7)
    keep = np.asarray(jax.random.bernoulli(jax.random.fold_in(key, 0), 0.8, batch["image"].shape))
    assert 0.7 < keep.mean() < 0.9
    jtrain, jeval = jae.make_ae_steps(jm, noise_rate=0.2)
    jv = jeval(jstate, {k: jnp.asarray(v) for k, v in batch.items()})  # noise-free
    jstate, jl = jtrain(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)

    tm = UNet3D(**NARROW)
    tm.load_state_dict(unet3d_state_dict_from_flax(_np(variables)))
    tstate = tloop.create_train_state(tm, tloop.cosine_decay_schedule(LR, 2), tae.WEIGHT_DECAY,
                                      grad_clip_norm=1.0, optimizer="adamw")
    ttrain, teval = tae.make_ae_steps(noise_rate=0.2)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    assert float(teval(tstate, tbatch)) == pytest.approx(float(jv), rel=1e-4)
    tl = ttrain(tstate, tbatch, keep=torch.from_numpy(keep.copy()))
    assert float(tl) == pytest.approx(float(jl), rel=1e-4)
    ref = unet3d_state_dict_from_flax(_np({"params": jstate.params,
                                           "batch_stats": jstate.batch_stats}))
    _assert_stats_close(tm, ref)
    d = _deltas(tm, ref)
    assert float(d.max()) <= 2 * LR and float((d <= 1e-5).float().mean()) >= 0.997
    # without a mask the step draws one from its generator: the same seed,
    # the same mask
    losses = []
    for _ in range(2):
        tm.load_state_dict(unet3d_state_dict_from_flax(_np(variables)))
        st = tloop.create_train_state(tm, tloop.cosine_decay_schedule(LR, 2), tae.WEIGHT_DECAY,
                                      grad_clip_norm=1.0, optimizer="adamw")
        step, _ = tae.make_ae_steps(0.2, torch.Generator().manual_seed(14))
        losses.append(float(step(st, tbatch)))
    assert losses[0] == losses[1] and np.isfinite(losses[0])


# ---- end to end ---------------------------------------------------------------

@pytest.fixture(scope="module")
def adni(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_unet")
    return make_adni_dir(str(root), n_per_class=6, shape=(16, 20, 16), seed=4,
                         extent_jitter=0.3, center_jitter=0.04)


def _recording_batchers(monkeypatch, module):
    """Record the records each VolumeBatcher of `module` is built over."""
    seen = []
    base = module.VolumeBatcher

    class Recording(base):
        def __init__(self, records, *a, **kw):
            seen.append([r["Subject"] for r in records])
            super().__init__(records, *a, **kw)

    monkeypatch.setattr(module, "VolumeBatcher", Recording)
    return seen


def _jax_split(adni):
    from multimodal_ad_tpu.data.adni import ADNIManifest as JaxManifest

    recs = JaxManifest(*adni, "ADCN", verbose=False).data_dict
    train_val, _ = jsplits.stratified_test_split(recs, 0.2, 42)
    train, val = jsplits.stratified_test_split(train_val, 0.2, 42)
    return [[r["Subject"] for r in part] for part in (train, val)]


def test_cli_train_unet3d_end_to_end(adni, tmp_path, monkeypatch):
    """cli.train_unet3d on the CPU with host augmentation (the default
    base-32 classifier, fp32): the JAX package's split, its 19-column
    unet_results.csv, a best_model checkpoint that restores."""
    from multimodal_ad_tpu_torch.cli.train_unet3d import main

    seen = _recording_batchers(monkeypatch, tss)
    out = tmp_path / "ckpt"
    csv_path, mri = adni
    best = main(["--device", "cpu", f"label_file={csv_path}", f"mri_dir={mri}",
                 "num_epochs=2", "batch_size=4", "lr=1e-3", "augment=true",
                 "compute_dtype=float32", "loader_threads=2", f"checkpoint_dir={out}"])
    assert seen == _jax_split(adni)
    assert len(seen[0]) == 7 and len(seen[1]) == 2
    with open(out / "unet_results.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == JAX_HEADER and all(len(r) == 19 for r in rows)
    assert [(r[0], r[1]) for r in rows[1:]] == [("1", "1"), ("1", "2")]
    assert [float(r[-1]) for r in rows[1:]] == [1e-3, 5e-4]  # schedule(epoch), 2 epochs
    aucs = [float(r[JAX_HEADER.index("vl_auc")]) for r in rows[1:]]
    weights, meta = ckpt.restore_state(str(out / "best_model"))
    assert meta["metrics"]["val_auc"] == pytest.approx(best) == pytest.approx(max(aucs), abs=1e-6)
    assert meta["metrics"]["epoch"] in (1.0, 2.0)
    UNet3DClassifier().load_state_dict(weights)


def test_autoencoder_trains_and_feeds_extraction(adni, tmp_path, monkeypatch):
    from multimodal_ad_tpu_torch.core.config import Config
    from multimodal_ad_tpu_torch.data.adni import ADNIManifest
    from multimodal_ad_tpu_torch.data.synthetic import make_atlas
    from multimodal_ad_tpu_torch.eval.features import extract_unet_features

    seen = _recording_batchers(monkeypatch, tae)
    csv_path, mri = adni
    cfg = Config(label_file=csv_path, mri_dir=mri, task="ADCN", num_epochs=2,
                 batch_size=4, lr=3e-3, checkpoint_dir=str(tmp_path / "ckpt"),
                 compute_dtype="float32", loader_threads=2)
    best, path = tae.train_unet_autoencoder(
        cfg, model=UNet3D(generator=torch.Generator().manual_seed(0), **NARROW),
        verbose=False, device="cpu")
    assert seen == _jax_split(adni)
    assert path == str(tmp_path / "ckpt" / "unet_ae_best") and np.isfinite(best)
    _, meta = ckpt.restore_state(path)
    assert meta["metrics"]["val_mse"] == pytest.approx(best)

    model = tae.load_autoencoder(path, cfg, model=UNet3D(**NARROW), device="cpu")
    assert not model.training
    records = ADNIManifest(csv_path, mri, verbose=False).data_dict[:3]
    feat, roi = extract_unet_features(records, make_atlas((16, 20, 16), n_rois=3, seed=0),
                                      ["A", "B", "C"], str(tmp_path / "out"), model=model,
                                      batch_size=2, num_threads=2, device="cpu")
    with open(feat) as f:
        frows = list(csv.reader(f))
    with open(roi) as f:
        rrows = list(csv.reader(f))
    assert frows[0][:2] == ["Subject_ID", "f0"] and len(frows[0]) == 1 + 16 * 20 * 16
    assert rrows[0][:3] == ["Subject_ID", "A_c0", "A_c1"] and len(rrows[0]) == 1 + 3 * 8
    assert [r[0] for r in rrows[1:]] == [r["Subject"] for r in records]
    assert np.isfinite(np.asarray([r[1:] for r in rrows[1:]], np.float64)).all()
