"""Port parity on the CPU: the training loop of the training slice.

The same seeded numpy inputs go through the JAX package's train/loop.py
(optax, flax) and the port's train/loop.py:

- `weighted_ce` with a mask: rel 1e-6;
- the schedule over updates 0-30 for 5, 20 and 100 epochs against the rate
  optax applies (read from the update, not from schedule(epoch)): rel 1e-6;
- one adam and one adamw update (clipped) against optax: rel 1e-5 of the
  update;
- three fp32 train steps of ResNet-10 (shortcut A and B) at 16x20x16,
  B = 4 with a padded row, dropout 0, from converted weights: losses rel
  1e-4, BN running statistics 1e-5, every parameter within 6 * lr and at
  least 99.9 % within 1e-5 (Adam can flip the sign of an update where a
  gradient is near zero), the eval step's loss and probabilities rel 1e-4;
- precise-BN against `recompute_batch_stats`: 1e-5;
- the optax -> torch Adam state converter: a JAX state after two steps
  resumes in the port and its third step matches JAX's as above;
- the BatchNorm subclass's biased running variance, the generator-driven
  dropout, and the device augmentation: geometry against JAX for explicit
  angles, zooms and flips (1e-5, points outside the volume included), and
  its probabilities over many draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_ad_tpu.models.resnet3d import generate_model as jax_generate_model
from multimodal_ad_tpu.ops import augment as jaug
from multimodal_ad_tpu.train import loop as jloop
from multimodal_ad_tpu_torch.models.resnet3d import (FlaxBatchNorm3d,
                                                     GeneratorDropout,
                                                     generate_model,
                                                     set_dropout_generator)
from multimodal_ad_tpu_torch.ops import augment as taug
from multimodal_ad_tpu_torch.train import loop as tloop
from multimodal_ad_tpu_torch.utils.torch_weights import (load_optax_adam_state,
                                                         state_dict_from_flax)

SHAPE = (16, 20, 16, 1)
LR = 1e-3
WD = 1e-4
CW = np.array([0.3, 0.7], np.float32)


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _batches(seed, n=3):
    rng = np.random.default_rng(seed)
    return [{"image": (rng.normal(size=(4, *SHAPE)) * 2 + 1).astype(np.float32),
             "label": np.array([0, 1, 1, 0], np.int32),
             "mask": np.array([1, 1, 1, 0], np.float32)} for _ in range(n)]


def test_weighted_ce_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(7, 3)).astype(np.float32) * 3
    labels = np.array([0, 2, 1, 1, 0, 2, 2], np.int32)
    w = np.array([0.2, 0.5, 0.3], np.float32)
    for mask in (np.ones(7, np.float32), np.array([1, 1, 0, 1, 1, 0, 0], np.float32)):
        ref = float(jloop.weighted_ce(jnp.asarray(logits), jnp.asarray(labels),
                                      jnp.asarray(w), jnp.asarray(mask)))
        ours = float(tloop.weighted_ce(torch.from_numpy(logits), torch.from_numpy(labels),
                                       torch.from_numpy(w), torch.from_numpy(mask)))
        assert ours == pytest.approx(ref, rel=1e-6)
    # an all-masked batch gives 0, not NaN
    zero = tloop.weighted_ce(torch.from_numpy(logits), torch.from_numpy(labels),
                             torch.from_numpy(w), torch.zeros(7))
    assert float(zero) == 0.0


@pytest.mark.parametrize("epochs", [5, 20, 100])
def test_schedule_is_the_rate_optax_applies(epochs):
    """optax evaluates the schedule at its update count: the rate of update
    k is schedule(k), not schedule(epoch) (the JAX docstring's claim)."""
    # the full chain twice, with the schedule and with rate 1: their
    # updates share the Adam direction, so the ratio is the applied rate
    txs = [jloop.make_optimizer(sched, weight_decay=0.0, grad_clip_norm=0.0)
           for sched in (jloop.make_epoch_schedule(LR, epochs), lambda _: 1.0)]
    params = {"w": jnp.ones((), jnp.float32)}
    states = [tx.init(params) for tx in txs]
    applied = []
    for _ in range(31):
        upd = []
        for i, tx in enumerate(txs):
            u, states[i] = tx.update({"w": jnp.ones((), jnp.float32)}, states[i], params)
            upd.append(float(u["w"]))
        applied.append(upd[0] / upd[1])

    p = torch.nn.Parameter(torch.ones(()))
    sched = tloop.make_epoch_schedule(LR, epochs)
    state = tloop.TrainState(torch.nn.Module(), tloop.make_optimizer([p], sched, 0.0),
                             sched, grad_clip_norm=0.0)
    ours = []
    for _ in range(31):
        p.grad = torch.ones(())
        tloop.apply_gradients(state)
        ours.append(state.optimizer.param_groups[0]["lr"])
    np.testing.assert_allclose(ours, applied, rtol=1e-6)
    assert state.step == 31
    if epochs == 20:  # warmup over 2 updates: 0.1, 0.55, then the cosine
        np.testing.assert_allclose(ours[:3], [1e-4, 5.5e-4, 1e-3], rtol=1e-6)


@pytest.mark.parametrize("kind", ["adam", "adamw"])
def test_one_update_matches_optax(kind):
    rng = np.random.default_rng(1)
    p0 = {"a": rng.normal(size=(3, 4)).astype(np.float32),
          "b": rng.normal(size=(5,)).astype(np.float32)}
    g = {k: (rng.normal(size=v.shape) * 2).astype(np.float32) for k, v in p0.items()}
    tx = jloop.make_optimizer(lambda _: 0.05, weight_decay=0.1, grad_clip_norm=1.0,
                              kind=kind)
    params = jax.tree_util.tree_map(jnp.asarray, p0)
    upd, _ = tx.update(jax.tree_util.tree_map(jnp.asarray, g), tx.init(params), params)
    ref = optax.apply_updates(params, upd)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = tloop.make_optimizer(list(tp.values()), lambda _: 0.05, 0.1, kind)
    state = tloop.TrainState(torch.nn.Module(), opt, lambda _: 0.05, grad_clip_norm=1.0)
    for k, v in tp.items():
        v.grad = torch.from_numpy(g[k].copy())
    tloop.apply_gradients(state)
    for k in p0:  # the global norm is above 1, so the update is clipped.
        # Updates agree to rel 1e-5: optax corrects the second moment's bias
        # with 1 - 0.999**t in float32 (0.999 rounds to 0.99900001), torch in
        # float64, so the first update's direction differs by 6.4e-6.
        ours = tp[k].detach().numpy().astype(np.float64) - p0[k]
        np.testing.assert_allclose(ours, np.asarray(ref[k], np.float64) - p0[k], rtol=1e-5)


# ---- three train steps --------------------------------------------------

_JAX = {}


def _jax_model(shortcut):
    """(model, train step, eval step, stats pass), compiled once per file."""
    if shortcut not in _JAX:
        jm = jax_generate_model(model_depth=10, resnet_shortcut=shortcut,
                                dropout_rate=0.0, compute_dtype=jnp.float32)
        _JAX[shortcut] = (jm, jloop.make_train_step(2), jloop.make_eval_step())
    return _JAX[shortcut]


def _jax_state(shortcut, seed):
    """A JAX TrainState with seeded He-normal kernels and randomized BN
    scale/bias/mean/var (no init compile: shapes from eval_shape)."""
    jm = _jax_model(shortcut)[0]
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                            jnp.zeros((1, *SHAPE)), train=False))
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
    tx = jloop.make_optimizer(jloop.make_epoch_schedule(LR, 20), WD, 1.0, "adam")
    return jloop.TrainState(params=v["params"], batch_stats=v["batch_stats"],
                            opt_state=tx.init(v["params"]),
                            epoch=jnp.zeros((), jnp.int32), tx=tx, apply_fn=jm.apply)


def _variables(jstate):
    return jax.tree_util.tree_map(np.asarray, {"params": jstate.params,
                                               "batch_stats": jstate.batch_stats})


def _port_state(shortcut, jstate):
    tm = generate_model(model_depth=10, resnet_shortcut=shortcut, dropout_rate=0.0,
                        compute_dtype=torch.float32)
    tm.load_state_dict(state_dict_from_flax(_variables(jstate), 10, shortcut))
    return tloop.create_train_state(tm, tloop.make_epoch_schedule(LR, 20), WD, 1.0)


def _assert_weights_close(tstate, jstate, shortcut):
    ref = state_dict_from_flax(_variables(jstate), 10, shortcut)
    ours = tstate.model.state_dict()
    deltas = []
    for name, v in ref.items():
        if name.endswith("num_batches_tracked"):
            continue
        if ".running_" in name:  # BN statistics
            np.testing.assert_allclose(ours[name].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=name)
        else:
            deltas.append((ours[name] - v).abs().flatten())
    d = torch.cat(deltas)
    assert float(d.max()) <= 6 * LR
    assert float((d <= 1e-5).float().mean()) >= 0.999


@pytest.mark.parametrize("shortcut", ["A", "B"])
def test_three_train_steps_match_jax(shortcut):
    _, step, evaluate = _jax_model(shortcut)
    jstate = _jax_state(shortcut, seed=7)
    tstate = _port_state(shortcut, jstate)
    cw = torch.from_numpy(CW)
    for batch in _batches(seed=8):
        jstate, jl, jp = step(jstate, _j(batch), jnp.asarray(CW), jax.random.PRNGKey(0))
        tl, tp = tloop.train_step(tstate, _t(batch), cw)
        assert float(tl) == pytest.approx(float(jl), rel=1e-4)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-4, atol=1e-6)
    assert tstate.step == 3
    assert tstate.optimizer.param_groups[0]["lr"] == pytest.approx(LR, rel=1e-6)
    _assert_weights_close(tstate, jstate, shortcut)

    batch = _batches(seed=9, n=1)[0]
    jl, jp = evaluate(jstate, _j(batch))
    tl, tp = tloop.eval_step(tstate, _t(batch))
    assert float(tl) == pytest.approx(float(jl), rel=1e-4)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-4, atol=1e-6)


def test_optax_adam_state_resumes_in_the_port():
    """Two JAX steps, then the params, BN statistics and Adam moments
    (count 2) move to the port; the third step agrees as in the
    three-step test, the rate included (update 2 applies lr)."""
    _, step, _ = _jax_model("B")
    jstate = _jax_state("B", seed=11)
    batches = _batches(seed=12)
    for batch in batches[:2]:
        jstate, _, _ = step(jstate, _j(batch), jnp.asarray(CW), jax.random.PRNGKey(0))
    tstate = _port_state("B", jstate)
    adam = next(s for s in jstate.opt_state if isinstance(s, optax.ScaleByAdamState))
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    load_optax_adam_state(tstate.optimizer, tstate.model, as_np(adam.mu),
                          as_np(adam.nu), adam.count)
    tstate.step = int(adam.count)
    p = tstate.model.conv1.weight
    assert tstate.optimizer.state[p]["exp_avg"].shape == p.shape
    assert float(tstate.optimizer.state[p]["step"]) == 2.0

    jstate, jl, _ = step(jstate, _j(batches[2]), jnp.asarray(CW), jax.random.PRNGKey(0))
    tl, _ = tloop.train_step(tstate, _t(batches[2]), torch.from_numpy(CW))
    assert float(tl) == pytest.approx(float(jl), rel=1e-4)
    _assert_weights_close(tstate, jstate, "B")


def test_precise_bn_matches_jax():
    jstate = _jax_state("B", seed=13)
    tstate = _port_state("B", jstate)
    batches = _batches(seed=14, n=2)
    jstate = jloop.recompute_batch_stats(jstate, [_j(b) for b in batches])
    dropout = next(m for m in tstate.model.modules() if isinstance(m, GeneratorDropout))
    dropout.p = 0.5  # eval-mode dropout during the stats pass: no draws
    set_dropout_generator(tstate.model, torch.Generator().manual_seed(0))
    before = torch.Generator().manual_seed(0).get_state()
    tstate.model.eval()
    tloop.recompute_batch_stats(tstate, [_t(b) for b in batches])
    assert torch.equal(dropout.generator.get_state(), before)
    assert not tstate.model.training  # the mode it had
    _assert_weights_close(tstate, jstate, "B")
    bn = tstate.model.bn1
    assert bn.momentum == 0.1 and int(bn.num_batches_tracked) == 0
    # no batches: the statistics stay as they were
    mean = bn.running_mean.clone()
    tloop.recompute_batch_stats(tstate, [])
    assert torch.equal(bn.running_mean, mean)


@pytest.mark.parametrize("momentum", [0.1, None])
def test_batchnorm_keeps_the_biased_variance(momentum):
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 3, 4, 3, 2), generator=g) * 3 + 1
    bn = FlaxBatchNorm3d(3, momentum=momentum).train()
    assert isinstance(bn, torch.nn.BatchNorm3d)
    bn.running_var.fill_(2.0)
    y = bn(x)
    var = x.transpose(0, 1).reshape(3, -1).var(dim=1, unbiased=False)
    f = 1.0 if momentum is None else momentum
    torch.testing.assert_close(bn.running_var, (1 - f) * 2.0 + f * var,
                               rtol=1e-6, atol=1e-6)
    ref = torch.nn.BatchNorm3d(3, momentum=momentum).train()
    torch.testing.assert_close(y, ref(x))  # the output is the stock one
    y.sum().backward()  # the replaced buffer leaves the graph intact


def test_dropout_draws_from_its_generator():
    drop = GeneratorDropout(0.5).train()
    x = torch.ones(4000)
    drop.generator = torch.Generator().manual_seed(3)
    a = drop(x)
    drop.generator = torch.Generator().manual_seed(3)
    b = drop(x)
    assert torch.equal(a, b)
    assert set(a.unique().tolist()) <= {0.0, 2.0}
    assert abs(float((a == 0).float().mean()) - 0.5) < 0.03
    assert torch.equal(drop.eval()(x), x)


# ---- augmentation ----------------------------------------------------------

@pytest.mark.parametrize("angle,zoom", [(0.0, 1.0), (0.05, 1.0), (-0.04, 0.96),
                                        (0.6, 0.8), (1.3, 1.25)])
def test_rotate_zoom_matches_jax(angle, zoom):
    """Large angles and zooms move points outside the volume: those are 0
    in both."""
    v = np.random.default_rng(2).random((9, 11, 8, 2)).astype(np.float32)
    ref = np.asarray(jaug.rotate_zoom_volume(jnp.asarray(v), jnp.float32(angle),
                                             jnp.float32(zoom)))
    ours = taug.rotate_zoom_volume(torch.from_numpy(v), angle, zoom).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)
    if (angle, zoom) == (0.0, 1.0):
        np.testing.assert_array_equal(ours, v)
    if abs(angle) > 0.5:
        assert (ref == 0).any()


def test_flip_matches_jax():
    x = np.random.default_rng(3).random((5, 4, 3, 2, 1)).astype(np.float32)
    ref = np.asarray(jnp.flip(jnp.asarray(x), axis=1))
    g = torch.Generator().manual_seed(0)
    np.testing.assert_array_equal(taug.random_flip(torch.from_numpy(x), g, 1.0).numpy(), ref)
    np.testing.assert_array_equal(taug.random_flip(torch.from_numpy(x), g, 0.0).numpy(), x)


def test_augmentation_probabilities(monkeypatch):
    """Flip, rotate and zoom each apply with p = 0.3 per sample, with angles
    in [-0.05, 0.05] and zooms in [0.95, 1]; intensity jitter stays in its
    bounds. 6,000 draws: 3.5 standard deviations is 0.021."""
    n = 6000
    g = torch.Generator().manual_seed(0)
    x = torch.arange(2.0).reshape(1, 2, 1, 1, 1).repeat(n, 1, 1, 1, 1)
    flipped = taug.random_flip(x, g, 0.3)[:, 0, 0, 0, 0] == 1.0
    assert abs(float(flipped.float().mean()) - 0.3) < 0.021

    seen = []
    monkeypatch.setattr(taug, "rotate_zoom",
                        lambda v, a, z: seen.extend(zip(a, z)) or v)
    taug.random_rotate_zoom(torch.zeros((n, 1, 1, 1, 1)), g)
    angles = np.array([a for a, _ in seen])
    zooms = np.array([z for _, z in seen])
    assert abs(len(seen) / n - (1 - 0.7 * 0.7)) < 0.021
    assert abs((angles != 0).sum() / n - 0.3) < 0.021
    assert abs((zooms != 1).sum() / n - 0.3) < 0.021
    assert np.abs(angles).max() <= 0.05 and zooms.min() >= 0.95 and zooms.max() <= 1.0

    ones = torch.ones((n, 1, 1, 1, 1))
    s = taug.random_intensity_scale(ones, g, 0.3, 0.1).flatten()
    assert abs(float((s != 1).float().mean()) - 0.3) < 0.021
    assert float(s.min()) >= 0.9 - 1e-6 and float(s.max()) <= 1.1 + 1e-6
    s = taug.random_intensity_shift(ones, g, 0.3, 0.1).flatten()
    assert abs(float((s != 1).float().mean()) - 0.3) < 0.021
    assert float(s.min()) >= 0.9 - 1e-6 and float(s.max()) <= 1.1 + 1e-6


def test_augment_batch_is_reproducible_and_keeps_shape():
    x = torch.from_numpy(np.random.default_rng(4).random((8, 6, 7, 5, 1)).astype(np.float32))
    a = taug.augment_batch(x, torch.Generator().manual_seed(5), flip_prob=1.0)
    b = taug.augment_batch(x, torch.Generator().manual_seed(5), flip_prob=1.0)
    assert a.shape == x.shape and torch.equal(a, b)
    assert not torch.equal(a, x)
    same = taug.augment_batch(x, torch.Generator(), flip_prob=0.0, rotate_prob=0.0,
                              zoom_prob=0.0)
    assert same is x
