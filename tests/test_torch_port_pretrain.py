"""ICL meta-training of the port against the JAX package on the CPU: the
host prior array for array; the torch device prior's masking invariants and
coarse moments against the host prior (classes and regression); the
meta-training losses, first gradients and 3-step parameters of
`pretrain_icl` against the JAX package's, with and without the auxiliary
losses; a regression meta-step; the init distributions; the msgpack
writer's bytes against flax's; `merge_compatible_params`; a
`cli.pretrain_icl` file read by both packages; the estimators meta-training
where no asset applies. TINY is the JAX tests' config."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from multimodal_ad_tpu.tabular import icl as jicl
from multimodal_ad_tpu.tabular import icl_regression as jreg
from multimodal_ad_tpu_torch.cli import pretrain_icl as cli
from multimodal_ad_tpu_torch.tabular import icl as ticl
from multimodal_ad_tpu_torch.tabular import icl_prior as tprior
from multimodal_ad_tpu_torch.tabular import icl_regression as treg
from multimodal_ad_tpu_torch.tabular.flax_msgpack import read_state, to_bytes, tree_leaves
from multimodal_ad_tpu_torch.tabular.meta_train import MetaTrainer
from multimodal_ad_tpu_torch.utils.torch_weights import (icl_flax_from_state_dict,
                                                         icl_state_dict_from_flax,
                                                         reg_icl_state_dict_from_flax)
from test_torch_port_support import cap_torch_threads

cap_torch_threads()

SMALL = dict(d_model=32, n_heads=2, n_layers=2, d_ff=64, max_features=16)
J_TINY = jicl.ICLConfig(max_classes=4, max_context=64, **SMALL)
T_TINY = ticl.ICLConfig(max_classes=4, max_context=64, **SMALL)
J_REG = jreg.RegICLConfig(max_context=64, **SMALL)
T_REG = treg.RegICLConfig(max_context=64, **SMALL)
LOSS_RTOL = 1e-5  # per-step losses, relative
GRAD_TOL = 1e-5  # first-step gradients, relative to their global norm
B, N_CTX, N_QRY, LR, STEPS = 8, 32, 8, 1e-3, 3


def _np_tree(t):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), t)


def _leaves(tree):
    return dict(tree_leaves(_np_tree(tree)))


@pytest.mark.parametrize("seed,var_ctx,mix", [
    (0, True, None), (1, True, None), (7, False, None), (3, True, (0.0, 0.0, 1.0, 0.0, 0.0)),
    (5, True, (0.5, 0.5, 0.0, 0.0, 0.0)), (11, True, (0.0, 0.0, 0.0, 0.3, 0.7))])
def test_host_prior_equals_jax(seed, var_ctx, mix):
    cfg_j = jicl.ICLConfig(max_features=24, max_classes=6)
    cfg_t = ticl.ICLConfig(max_features=24, max_classes=6)
    a = jicl.sample_tasks(np.random.default_rng(seed), 12, cfg_j, 40, 9, var_ctx, mix)
    b = ticl.sample_tasks(np.random.default_rng(seed), 12, cfg_t, 40, 9, var_ctx, mix)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])
    assert ticl._mix_thresholds(ticl.DEFAULT_FAMILY_MIX) == (0.22, 0.4, 0.62, 0.74)
    for bad in ((1.0, 0.0, 0.0), (1.0, -0.1, 0.0, 0.0, 0.0)):
        with pytest.raises(ValueError):
            ticl._mix_thresholds(bad)


def _check_masking(t, batch, n_ctx):
    lens = t["ctx_mask"].sum(1).astype(int)
    assert lens.min() >= 16 and len(np.unique(lens)) > 3
    for b in range(batch):
        nv = lens[b]
        assert (t["ctx_mask"][b, :nv] == 1).all()
        assert (t["x_ctx"][b, nv:] == 0).all() and (t["y_ctx"][b, nv:] == 0).all()


def _moments(t, C):
    x = t["x_ctx"]
    nz = np.abs(x) > 0
    used = (np.abs(x).sum(1) > 0).mean()
    counts = np.bincount(np.concatenate([t["y_ctx"], t["y_qry"]], 1).ravel().astype(int),
                         minlength=C)
    return float(x[nz].std()), float(used), counts


def test_device_prior_masking_and_moments_against_the_host_prior():
    """The JAX TestDevicePrior's invariants and coarse moments, for the
    torch device prior (on the CPU) and the host prior alike; the features
    used and the value spread agree between the two within sampling error."""
    gen = torch.Generator().manual_seed(3)
    td = {k: v.numpy() for k, v in tprior.sample_tasks_device(gen, 96, T_TINY, 48, 8).items()}
    th = ticl.sample_tasks(np.random.default_rng(3), 96, T_TINY, 48, 8)
    assert td["x_ctx"].shape == (96, 48, 16) and td["y_qry"].shape == (96, 8)
    assert td["cat_mask"].shape == (96, 16)
    assert td["y_ctx"].max() < T_TINY.max_classes
    _check_masking(td, 96, 48)
    stats = {}
    for name, t in (("device", td), ("host", th)):
        std, used, counts = _moments(t, 4)
        assert 1.0 < std < 2.5, (name, std)
        assert 0.25 < used < 0.55, (name, used)
        assert counts.argmax() == 0 and counts[1] > 0, (name, counts)
        stats[name] = (std, used)
    assert abs(stats["device"][1] - stats["host"][1]) < 0.08, stats
    # categorical columns only where features are real
    real = np.abs(td["x_ctx"]).sum(1) > 0
    assert (td["cat_mask"] <= real).all() and td["cat_mask"].any()
    full = tprior.sample_tasks_device(torch.Generator().manual_seed(0), 4, T_TINY, 48, 8, False)
    assert float(full["ctx_mask"].min()) == 1.0


def test_device_prior_mix_default_equals_none_and_overrides():
    draws = {}
    for mix in (None, ticl.DEFAULT_FAMILY_MIX):
        gen = torch.Generator().manual_seed(5)
        draws[mix] = tprior.sample_tasks_device(gen, 8, T_TINY, 32, 4, True, mix)
    for k in draws[None]:
        assert torch.equal(draws[None][k], draws[ticl.DEFAULT_FAMILY_MIX][k])
    pw = tprior.sample_tasks_device(torch.Generator().manual_seed(5), 8, T_TINY, 32, 4, True,
                                    (0.0, 0.0, 1.0, 0.0, 0.0))
    assert torch.isfinite(pw["x_ctx"]).all() and (pw["x_ctx"].abs() > 0).any()
    assert not pw["cat_mask"].any()  # the pairwise family quantizes no column


def test_regression_device_prior_masking_and_moments():
    gen = torch.Generator().manual_seed(0)
    t = {k: v.numpy() for k, v in tprior.sample_reg_tasks_device(gen, 32, T_REG, 48, 8).items()}
    assert t["x_ctx"].shape == (32, 48, 16) and t["y_ctx"].shape == (32, 48)
    assert t["y_ctx"].dtype == np.float32 and np.isfinite(t["y_qry"]).all()
    _check_masking(t, 32, 48)
    assert (t["y_qry"].var(axis=1) > 0).all()
    std, used, _ = _moments({**t, "y_ctx": np.zeros((1, 1)), "y_qry": np.zeros((1, 1))}, 1)
    assert 0.7 < std < 2.5 and 0.25 < used < 0.55, (std, used)


def _jax_loss(model, aux_embed, aux_tau, aux_qc):
    """The JAX package's meta-training loss (tabular/icl.py:393-440),
    composed from its public pieces."""
    def loss_fn(p, task):
        xc, xq = jicl._zscore_by_ctx(task["x_ctx"], task["x_qry"], task["ctx_mask"])
        logits, q_emb, c_emb = model.apply(p, xc, task["y_ctx"], task["ctx_mask"], xq,
                                           task.get("cat_mask"))
        logp = jax.nn.log_softmax(logits)
        loss = -jnp.take_along_axis(logp, task["y_qry"][..., None], axis=-1).mean()

        def con(sim, same):
            log_z = jax.nn.logsumexp(sim, axis=-1)
            pos = jnp.where(same, sim - log_z[..., None], 0.0).sum(-1)
            n_pos = same.sum(-1)
            c = -jnp.where(n_pos > 0, pos / jnp.maximum(n_pos, 1), 0.0)
            return c.sum() / jnp.maximum((n_pos > 0).sum(), 1)

        def unit(h):
            return h / jnp.maximum(jnp.linalg.norm(h, axis=-1, keepdims=True), 1e-6)
        y = task["y_qry"]
        if aux_embed > 0:
            z = unit(q_emb)
            sim = jnp.einsum("bmd,bnd->bmn", z, z) / aux_tau
            eye = jnp.eye(sim.shape[1], dtype=bool)[None]
            sim = jnp.where(eye, -jnp.inf, sim)
            loss = loss + aux_embed * con(sim, (y[:, :, None] == y[:, None, :]) & ~eye)
        if aux_qc > 0:
            valid = task["ctx_mask"] > 0
            sim = jnp.einsum("bmd,bnd->bmn", unit(q_emb), unit(c_emb)) / aux_tau
            sim = jnp.where(valid[:, None, :], sim, -jnp.inf)
            same = (y[:, :, None] == task["y_ctx"][:, None, :]) & valid[:, None, :]
            loss = loss + aux_qc * con(sim, same)
        return loss
    return loss_fn


def _adam_bound(lr, steps):
    """The most two Adam trajectories can part per element in `steps`
    updates when their gradients differ only at rounding level: each update
    of optax's adamw moves an element by at most lr_t * U_t (+ the decay,
    wd * lr_t * |p|), U_t = sqrt(sum_i a_i^2 / b_i) the Cauchy-Schwarz bound
    of |m_hat| / sqrt(v_hat) (a_i, b_i the bias-corrected moment weights),
    and a sign flip of an element's rounding-level gradient turns that into
    2 lr_t U_t."""
    b1, b2 = 0.9, 0.999
    sched = optax.cosine_decay_schedule(lr, steps)
    total = 0.0
    for t in range(1, steps + 1):
        a = [(1 - b1) * b1 ** (t - i) / (1 - b1 ** t) for i in range(1, t + 1)]
        b = [(1 - b2) * b2 ** (t - i) / (1 - b2 ** t) for i in range(1, t + 1)]
        u = math.sqrt(sum(x * x / y for x, y in zip(a, b)))
        total += 2 * float(sched(t - 1)) * u * (1 + 1e-4 * 3.0)  # |p| < 3 here
    return total


@pytest.mark.parametrize("aux", [(0.0, 0.0), (0.5, 0.3)], ids=["nll", "nll+aux"])
def test_pretrain_matches_jax(aux):
    """From the same converted initial weights and seed: per-step losses
    within 1e-5 relative, first-step gradients within 1e-5 of their global
    norm, the 3-step parameters within the derived Adam bound; the port's
    own pretrain_icl equals its step-by-step run."""
    aux_embed, aux_qc = aux
    seed = 2
    model = jicl.ICLTransformer(J_TINY)
    t0 = jicl.sample_tasks(np.random.default_rng(seed), B, J_TINY, N_CTX, N_QRY)
    init = _np_tree(model.init(jax.random.PRNGKey(seed), t0["x_ctx"], t0["y_ctx"],
                               t0["ctx_mask"], t0["x_qry"]))
    init["params"]["cat_proj"]["kernel"] = np.random.default_rng(4).normal(
        size=init["params"]["cat_proj"]["kernel"].shape).astype(np.float32) * 0.1
    rng = np.random.default_rng(seed)
    jicl.sample_tasks(rng, B, J_TINY, N_CTX, N_QRY)
    tasks = [jicl.sample_tasks(rng, B, J_TINY, N_CTX, N_QRY) for _ in range(STEPS)]
    # JAX: the package's own pretrain_icl, and the same steps composed
    jax_final, _ = jicl.pretrain_icl(J_TINY, steps=STEPS, batch=B, n_ctx=N_CTX, n_qry=N_QRY,
                                     lr=LR, seed=seed, init_params=init,
                                     aux_embed=aux_embed, aux_qc=aux_qc)
    loss_fn = _jax_loss(model, aux_embed, 0.2, aux_qc)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(optax.cosine_decay_schedule(LR, STEPS)))
    p, opt = init, tx.init(init)

    @jax.jit
    def step(p, opt, task):  # the JAX package's step (tabular/icl.py:478-482)
        loss, g = jax.value_and_grad(loss_fn)(p, task)
        upd, opt = tx.update(g, opt, p)
        return optax.apply_updates(p, upd), opt, loss, g

    j_losses, j_grad0 = [], None
    for task in tasks:
        p, opt, loss, g = step(p, opt, {k: jnp.asarray(v) for k, v in task.items()})
        j_grad0 = g if j_grad0 is None else j_grad0
        j_losses.append(float(loss))
    for k, v in _leaves(p).items():
        np.testing.assert_allclose(v, _leaves(jax_final)[k], rtol=0, atol=1e-6)
    # the port, step by step
    net = ticl.ICLTransformer(T_TINY)
    net.load_state_dict(icl_state_dict_from_flax(init, T_TINY))
    trainer = MetaTrainer(net, LR, STEPS, lambda m, t: ticl.icl_meta_loss(
        m, t, aux_embed=aux_embed, aux_qc=aux_qc))
    t_losses = []
    for i, task in enumerate(tasks):
        tt = {k: torch.from_numpy(v) for k, v in task.items()}
        if i == 0:
            loss = ticl.icl_meta_loss(net, tt, aux_embed=aux_embed, aux_qc=aux_qc)
            loss.backward()
            grads = {n: q.grad.clone() for n, q in net.named_parameters()}
            gtree = icl_flax_from_state_dict(grads, T_TINY)
            jl = _leaves(j_grad0)
            norm = math.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in jl.values()))
            assert all(bool(torch.isfinite(g).all()) for g in grads.values())
            for k, v in _leaves(gtree).items():
                assert float(np.abs(v - jl[k]).max()) <= GRAD_TOL * norm, k
        t_losses.append(float(trainer.step(tt)))
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_RTOL)
    port = icl_flax_from_state_dict(net.state_dict(), T_TINY)
    bound = _adam_bound(LR, STEPS)
    diffs = {k: float(np.abs(v - _leaves(jax_final)[k]).max()) for k, v in _leaves(port).items()}
    assert max(diffs.values()) <= bound, (bound, sorted(diffs.items(), key=lambda kv: -kv[1])[:3])
    # pretrain_icl runs the same steps (the same init draw and task stream)
    final, cfg = ticl.pretrain_icl(T_TINY, steps=STEPS, batch=B, n_ctx=N_CTX, n_qry=N_QRY,
                                   lr=LR, seed=seed, init_params=init, aux_embed=aux_embed,
                                   aux_qc=aux_qc, device="cpu")
    assert cfg is T_TINY
    for k, v in _leaves(final).items():
        np.testing.assert_array_equal(v, _leaves(port)[k])


def test_regression_meta_step_matches_jax():
    """One regression meta-step on a fixed task: the loss within 1e-5
    relative and the gradients within 1e-5 of their global norm, against
    the JAX step composed from RegICLTransformer, _zscore_by_ctx,
    _zscore_y_by_ctx and soft_two_hot."""
    rng = np.random.default_rng(8)
    task = {"x_ctx": rng.normal(size=(4, 24, 16)).astype(np.float32),
            "y_ctx": rng.normal(size=(4, 24)).astype(np.float32) * 3 + 1,
            "ctx_mask": np.ones((4, 24), np.float32),
            "x_qry": rng.normal(size=(4, 6, 16)).astype(np.float32),
            "y_qry": rng.normal(size=(4, 6)).astype(np.float32) * 3 + 1}
    task["ctx_mask"][1, 17:] = 0
    task["x_ctx"][1, 17:] = 0
    task["y_ctx"][1, 17:] = 0
    model = jreg.RegICLTransformer(J_REG)
    t = jreg.sample_template_task(J_REG)
    params = _np_tree(model.init(jax.random.PRNGKey(0), t["x_ctx"], t["y_ctx"],
                                 t["ctx_mask"], t["x_qry"]))
    centers = jnp.asarray(jreg.bin_centers(J_REG))

    def loss_fn(p, task):
        xc, xq = jicl._zscore_by_ctx(task["x_ctx"], task["x_qry"], task["ctx_mask"])
        zc, zq = jreg._zscore_y_by_ctx(task["y_ctx"], task["ctx_mask"], task["y_qry"])
        logits, _, _ = model.apply(p, xc, zc, task["ctx_mask"], xq)
        return -(jreg.soft_two_hot(zq, centers) * jax.nn.log_softmax(logits)).sum(-1).mean()

    jl, jg = jax.value_and_grad(loss_fn)(params, {k: jnp.asarray(v) for k, v in task.items()})
    net = treg.RegICLTransformer(T_REG)
    net.load_state_dict(reg_icl_state_dict_from_flax(params, T_REG))
    loss = treg.reg_meta_loss(net, {k: torch.from_numpy(v) for k, v in task.items()},
                              torch.from_numpy(treg.bin_centers(T_REG)))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    from multimodal_ad_tpu_torch.utils.torch_weights import reg_icl_flax_from_state_dict

    gt = _leaves(reg_icl_flax_from_state_dict(
        {n: q.grad for n, q in net.named_parameters()}, T_REG))
    jg = _leaves(jg)
    norm = math.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in jg.values()))
    for k, v in gt.items():
        assert float(np.abs(v - jg[k]).max()) <= GRAD_TOL * norm, k
    np.testing.assert_array_equal(treg.sample_template_task(T_REG)["x_qry"],
                                  np.asarray(t["x_qry"]))


def test_init_draws_follow_flax():
    """init_icl_params against flax's initializers, leaf by leaf: the same
    tree and shapes as the JAX init; zero-init leaves zero, LayerNorm
    scales one; every random leaf's mean and std within sampling error of
    its distribution (LeCun-normal truncated at 2 std, flax's embed init,
    normal(0.02)), and truncated at 2 std where flax truncates."""
    cfg_t = ticl.ICLConfig()
    cfg_j = jicl.ICLConfig()
    t = jicl.sample_tasks(np.random.default_rng(0), 1, cfg_j, 8, 4)
    shapes = jax.eval_shape(lambda: jicl.ICLTransformer(cfg_j).init(
        jax.random.PRNGKey(0), t["x_ctx"], t["y_ctx"], t["ctx_mask"], t["x_qry"]))
    jshape = {k: v.shape for k, v in tree_leaves(jax.tree_util.tree_map(lambda s: s, shapes)
                                                 ) if hasattr(v, "shape")}
    tree = ticl.init_icl_params(cfg_t, seed=0)
    leaves = dict(tree_leaves(tree))
    assert {k: v.shape for k, v in leaves.items()} == jshape
    for k, v in leaves.items():
        name, owner = k[-1], k[-2]
        if name == "bias" or owner in ("cat_proj", "cat_ind"):
            assert not v.any(), k
            continue
        if name == "scale":
            assert (v == 1).all(), k
            continue
        if name == "embedding":
            std, trunc = 1 / math.sqrt(v.shape[-1]), False
        elif name == "query_token":
            std, trunc = 0.02, False
        else:
            fan_in = v.shape[0] * (v.shape[1] if owner == "out" else 1)
            std, trunc = 1 / math.sqrt(fan_in), True
        se = std / math.sqrt(v.size)
        assert abs(float(v.mean())) < 5 * se, k
        assert abs(float(v.std()) - std) < 5 * std / math.sqrt(2 * v.size) + 1e-3 * std, k
        if trunc:
            assert float(np.abs(v).max()) <= 2 * std / 0.87962566103423978 + 1e-6, k
    reg = dict(tree_leaves(treg.init_reg_icl_params(treg.RegICLConfig(), seed=0)))
    assert abs(float(reg[("params", "target_proj", "kernel")].std()) - 1.0) < 0.2


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_msgpack_writer_bytes_equal_flax(dtype):
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype),
                                  ticl.init_icl_params(T_TINY, seed=1))
    tree["params"]["extra"] = {"n": np.arange(300, dtype=np.int32), "s": np.float32(2.5),
                               "e": np.zeros((0, 3), dtype)}
    blob = to_bytes(tree)
    assert blob == serialization.to_bytes(tree)
    back = serialization.msgpack_restore(blob)
    for k, v in tree_leaves(tree):
        np.testing.assert_array_equal(dict(tree_leaves(back))[k], v)


def test_merge_compatible_params_matches_jax(tmp_path):
    """A file of an older revision (no categorical pathway, one leaf of
    another shape): the port's merge equals the JAX package's."""
    old_cfg = ticl.ICLConfig(**{**SMALL, "cat_input": False}, max_classes=4)
    stored = ticl.init_icl_params(old_cfg, seed=3)
    stored["params"]["cls_head"]["kernel"] = np.ones((32, 5), np.float32)  # other shape
    path = str(tmp_path / "old.msgpack")
    with open(path, "wb") as f:
        f.write(to_bytes(jax.tree_util.tree_map(lambda a: a.astype(np.float16), stored)))
    template = ticl.init_icl_params(T_TINY, seed=9)
    ours = ticl.merge_compatible_params(template, path)
    theirs = jicl.merge_compatible_params(template, path)
    lo, lt = _leaves(ours), _leaves(theirs)
    assert lo.keys() == lt.keys()
    for k in lo:
        np.testing.assert_array_equal(lo[k], lt[k])
    assert (lo[("params", "cls_head", "kernel")] == template["params"]["cls_head"]["kernel"]).all()
    assert not lo[("params", "cat_proj", "kernel")].any()


def test_cli_files_load_in_both_packages(tmp_path, capsys):
    """cli.pretrain_icl (classifier with the categorical pathway and both
    auxiliary losses, float16; a resumed phase; the regressor, and its
    strict resume) writes files both packages' loaders read."""
    out = str(tmp_path / "clf.msgpack")
    base = ["--batch", "4", "--n-ctx", "24", "--n-qry", "6", "--d-model", "32",
            "--device", "cpu", "--seed", "1"]
    cli.main(["--steps", "2", "--cat-input", "--aux-embed", "0.5", "--aux-qc", "0.5",
              "--save-dtype", "float16", "--out", out] + base)
    cfg_j, cfg_t = jicl.ICLConfig(d_model=32), ticl.ICLConfig(d_model=32)
    j = _leaves(jicl._load_params_file(cfg_j, out))
    t = _leaves(ticl._load_params_file(cfg_t, out))
    assert j.keys() == t.keys() and all(v.dtype == np.float32 for v in t.values())
    for k in j:
        np.testing.assert_array_equal(j[k], t[k])
    assert {str(v.dtype) for _, v in tree_leaves(read_state(out))} == {"float16"}
    out2 = str(tmp_path / "clf2.msgpack")
    cli.main(["--steps", "2", "--device-prior", "--chunk", "1", "--mix", "1,1,1,1,1",
              "--resume-from", out, "--out", out2] + base)
    assert "leaves matched" in capsys.readouterr().out
    jicl._load_params_file(cfg_j, out2)
    reg = str(tmp_path / "reg.msgpack")
    cli.main(["--regression", "--steps", "2", "--chunk", "1", "--out", reg] + base)
    rj = _leaves(jreg._load_reg_params_file(jreg.RegICLConfig(d_model=32), reg))
    rt = _leaves(treg._load_reg_params_file(treg.RegICLConfig(d_model=32), reg))
    for k in rj:
        np.testing.assert_array_equal(rj[k], rt[k])
    cli.main(["--regression", "--steps", "1", "--resume-from", reg, "--out", reg] + base)
    with pytest.raises(ValueError):
        cli.main(["--regression", "--steps", "1", "--resume-from", out, "--out", reg] + base)


def test_inverse_converters_round_trip():
    tree = ticl.init_icl_params(T_TINY, seed=5)
    back = icl_flax_from_state_dict(icl_state_dict_from_flax(tree, T_TINY), T_TINY)
    assert _leaves(back).keys() == _leaves(tree).keys()
    for k, v in _leaves(tree).items():
        np.testing.assert_array_equal(_leaves(back)[k], v)
    from multimodal_ad_tpu_torch.utils.torch_weights import reg_icl_flax_from_state_dict

    rt = treg.init_reg_icl_params(T_REG, seed=5)
    rb = reg_icl_flax_from_state_dict(reg_icl_state_dict_from_flax(rt, T_REG), T_REG)
    for k, v in _leaves(rt).items():
        np.testing.assert_array_equal(_leaves(rb)[k], v)


def test_estimators_meta_train_where_no_asset_applies():
    """ICLClassifier(cfg=TINY) and ICLRegressor with a tiny config and no
    params meta-train on their device (here the CPU) and predict, and the
    trained tree enters the process-wide cache under the asset key."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(60, 5)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(int)
    clf = ticl.ICLClassifier(cfg=T_TINY, pretrain_steps=40, preprocess=None,
                             n_estimators=2, device="cpu").fit(X[:40], y[:40])
    proba = clf.predict_proba(X[40:])
    assert proba.shape == (20, 2) and np.isfinite(proba).all()
    assert clf._asset_key() in ticl.ICLClassifier._param_cache
    assert clf._ensure_params() is ticl.ICLClassifier._param_cache[clf._asset_key()]
    reg = treg.RegICLConfig(max_context=64, **SMALL)
    from multimodal_ad_tpu_torch.tabular.regression import ICLRegressor

    r = ICLRegressor(cfg=reg, pretrain_steps=10, preprocess=None, n_estimators=2,
                     device="cpu").fit(X[:40], X[:40, 0])
    pred = r.predict(X[40:])
    assert pred.shape == (20,) and np.isfinite(pred).all()
