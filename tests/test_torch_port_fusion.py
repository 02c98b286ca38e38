"""Multimodal fusion of the port against the JAX package on the CPU, at
16^3 volumes (and 35x50x33, where SmallCNN3D's pooling floors leave 2x3x2
tokens a modality): `VolumeBatcher` with PET and a table (keys, shapes, order,
table rows, and one augmentation plan a row applied to both modalities,
against the JAX batcher's host transform); `MultimodalClassifier` in its
three modality sets and `DAFTResNet` on converted weights in fp32 (eval and
train-mode forwards within 1e-4 of the logits' spread, the BatchNorm
statistics of a train-mode forward, one train step against the JAX
package's `make_fusion_steps`; random weights of the flax structure); a
2-fold `train_fusion_cv` + `test_fusion_models` run and
`cli.train_fusion`; DAFT without a table raising as in the JAX package."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_ad_tpu.data import pipeline as jpipe
from multimodal_ad_tpu.data import transforms as jtf
from multimodal_ad_tpu.models.daft import DAFTResNet as JDAFT
from multimodal_ad_tpu.models.transformer import MultimodalClassifier as JMC
from multimodal_ad_tpu.train import fusion as jfusion
from multimodal_ad_tpu.train import loop as jloop
from multimodal_ad_tpu_torch.core.config import Config
from multimodal_ad_tpu_torch.data import pipeline as tpipe
from multimodal_ad_tpu_torch.data import transforms as ttf
from multimodal_ad_tpu_torch.data.adni import ADNIManifest
from multimodal_ad_tpu_torch.data.synthetic import make_adni_dir
from multimodal_ad_tpu_torch.data.tabular import write_table
from multimodal_ad_tpu_torch.models.daft import DAFTResNet
from multimodal_ad_tpu_torch.models.transformer import MultimodalClassifier
from multimodal_ad_tpu_torch.train import fusion as tfusion
from multimodal_ad_tpu_torch.train.cv import _device_batches
from multimodal_ad_tpu_torch.train.loop import create_train_state, make_epoch_schedule
from multimodal_ad_tpu_torch.utils.torch_weights import (daft_state_dict_from_flax,
                                                         multimodal_state_dict_from_flax)
from test_torch_port_support import cap_torch_threads, default_torch_threads  # noqa: F401

cap_torch_threads()

SHAPE = (16, 16, 16)
ODD = (35, 50, 33)  # 35->17->8->4->2, 50->25->12->6->3, 33->16->8->4->2: 12 tokens
SMALL = dict(dim=16, depth=2, heads=2, dim_head=8, mlp_dim=32)
SPREAD_TOL = 1e-4  # fp32 forwards, of the logits' spread
TABLE_DIM = 5


@pytest.fixture(scope="module")
def fusion_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fusion"))
    csv_path, mri_dir, pet_dir = make_adni_dir(root, n_per_class=6, classes=("AD", "CN"),
                                               shape=SHAPE, seed=5, pet=True)
    return {"root": root, "label_file": csv_path, "mri_dir": mri_dir, "pet_dir": pet_dir}


def _records(d):
    return ADNIManifest(d["label_file"], d["mri_dir"], "ADCN", pet_dir=d["pet_dir"],
                        verbose=False).data_dict


def _table_for(records):
    """The JAX tests' table: 6 features shifted by 1.5 x the label."""
    rng = np.random.default_rng(0)
    y = np.asarray([r["label"] for r in records])
    X = (rng.normal(size=(len(records), 6)) + 1.5 * y[:, None]).astype(np.float32)
    return X, y, [r["Subject"] for r in records]


def test_volume_batcher_pet_and_table_match_jax(fusion_dir):
    recs = _records(fusion_dir)
    table = {r["Subject"]: np.arange(4, dtype=np.float32) + r["label"] * 10 + i
             for i, r in enumerate(recs)}
    jb = jpipe.VolumeBatcher(recs, jtf.VolumeTransform(augment=True, seed=7), batch_size=5,
                             shuffle=True, seed=3, num_threads=2, image_keys=("MRI", "PET"),
                             table_lookup=table)
    tb = tpipe.VolumeBatcher(recs, batch_size=5, shuffle=True, seed=3, num_threads=2,
                             transform=ttf.VolumeTransform(augment=True, seed=7),
                             image_keys=("MRI", "PET"), table_lookup=table)
    for _ in range(2):  # two epochs: two orders, two sets of plans
        host = list(tb.__iter__())
        tb._epoch -= 1  # the same epoch again, through the device path
        dev = list(_device_batches(tb, "cpu", "scale_intensity", 2))
        for a, h, b in zip(jb, host, dev, strict=True):
            assert set(h) == set(a) | {"plan"} and set(b) == set(a)
            assert h["image"].shape == h["pet"].shape == (5, *SHAPE, 1)
            assert h["table"].shape == (5, 4) and h["table"].dtype == np.float32
            assert b["subject"] == a["subject"]
            assert len(h["plan"]) == 5
            for k in ("mask", "label", "table"):
                np.testing.assert_array_equal(b[k].numpy(), a[k])
            # one plan a row, applied to both modalities as JAX's transform
            for k in ("image", "pet"):
                np.testing.assert_allclose(b[k].numpy(), a[k], rtol=0, atol=1e-6)
    assert any(p != ttf.AugmentPlan() for p in host[0]["plan"] + host[1]["plan"])


def _random_variables(model, rng, *args, **kw):
    """Random flax variables of `model`'s structure (from jax.eval_shape, no
    init compile): kernels N(0, 1/fan_in), LayerNorm / BatchNorm scales near
    1, biases and running means near 0, running variances in [0.5, 3.5)."""
    shapes = jax.eval_shape(lambda k: model.init({"params": k}, *args, **kw),
                            jax.random.PRNGKey(0))

    def leaf(path, s):
        name = path[-1].key
        n = rng.normal(size=s.shape)
        if name == "kernel":
            n = n / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            n = 1 + 0.1 * n
        elif name == "var":
            n = 0.5 + 3 * rng.random(s.shape)
        else:
            n = 0.1 * n
        return n.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _inputs(rng, b=3, shape=SHAPE):
    return (rng.normal(size=(b, *shape, 1)).astype(np.float32) * 2 + 1,
            rng.normal(size=(b, *shape, 1)).astype(np.float32),
            rng.normal(size=(b, TABLE_DIM)).astype(np.float32))


def _spread_err(out, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(out) - ref).max()) / float(ref.max() - ref.min())


def _check_forwards(jm, variables, tm, args, t_args):
    for train in (False, True):
        if train:
            ref, upd = jm.apply(variables, *args["pos"], train=True, mutable=["batch_stats"],
                                **args["kw"])
        else:
            ref = jm.apply(variables, *args["pos"], train=False, **args["kw"])
        tm.train(train)
        with torch.no_grad():
            out = tm(*t_args["pos"], **t_args["kw"])
        assert out.dtype == torch.float32
        assert _spread_err(out.numpy(), ref) <= SPREAD_TOL, train
    return upd


MODALITY_SETS = {"mri": (False, False), "mri+table": (False, True),
                 "mri+pet+table": (True, True)}


@pytest.mark.usefixtures("default_torch_threads")
@pytest.mark.parametrize(
    "use_pet,use_table,shape",
    [(*m, SHAPE) for m in MODALITY_SETS.values()] + [(*m, ODD) for m in MODALITY_SETS.values()],
    ids=list(MODALITY_SETS) + [f"{k}-35x50x33" for k in MODALITY_SETS])
def test_multimodal_classifier_matches_jax(use_pet, use_table, shape):
    """Eval and train-mode forwards on converted random weights within
    1e-4 of the logits' spread, and the train-mode BatchNorm running
    statistics within 1e-5; dropout 0 (the two packages draw different
    masks). At 35x50x33 each modality gives 12 tokens, so the attention
    has several keys and the positional encoding several positions."""
    rng = np.random.default_rng(1)
    img, pet, tab = _inputs(rng, shape=shape)
    jm = JMC(use_pet=use_pet, use_table=use_table, dropout=0.0, dtype=jnp.float32, **SMALL)
    kw = {"pet": pet if use_pet else None, "table": tab if use_table else None}
    v = _random_variables(jm, rng, img, **kw)
    tm = MultimodalClassifier(use_pet=use_pet, use_table=use_table, table_dim=TABLE_DIM,
                              dropout=0.0, compute_dtype=torch.float32, **SMALL)
    tm.load_state_dict(multimodal_state_dict_from_flax(v, use_pet, use_table, SMALL["depth"]))
    t = {k: None if a is None else torch.from_numpy(a) for k, a in kw.items()}
    tm.eval()
    with torch.no_grad():
        n_tokens = tm._tokens(tm.mri_cnn, torch.from_numpy(img)).shape[1]
    assert n_tokens == (1 if shape == SHAPE else 12)
    upd = _check_forwards(jm, v, tm, {"pos": (img,), "kw": kw},
                          {"pos": (torch.from_numpy(img),), "kw": t})
    ref = multimodal_state_dict_from_flax({"params": v["params"], **upd}, use_pet, use_table,
                                          SMALL["depth"])
    sd = tm.state_dict()
    for k in ref:
        if "running" in k:
            torch.testing.assert_close(sd[k], ref[k], rtol=0, atol=1e-5)


def test_daft_matches_jax():
    _check_daft(SHAPE)


def test_daft_matches_jax_35x50x33():
    _check_daft(ODD)


def _check_daft(shape):
    rng = np.random.default_rng(2)
    img, _, tab = _inputs(rng, shape=shape)
    jm = JDAFT(dropout_rate=0.0, dtype=jnp.float32)
    v = _random_variables(jm, rng, img, tab)
    tm = DAFTResNet(table_dim=TABLE_DIM, dropout_rate=0.0, compute_dtype=torch.float32)
    tm.load_state_dict(daft_state_dict_from_flax(v))
    assert tm.daft.aux_hidden.out_features == max(4, (512 + TABLE_DIM) // 7)
    _check_forwards(jm, v, tm, {"pos": (img, tab), "kw": {}},
                    {"pos": (torch.from_numpy(img), torch.from_numpy(tab)), "kw": {}})


@pytest.mark.parametrize("arch", ["cross_transformer", "daft"])
def test_one_train_step_matches_jax(arch):
    """One train step of make_fusion_steps (class-weighted CE over a padded
    batch, clip 1.0, Adam with wd 1e-4 at the warmup's first rate) from the
    same weights: the loss within 1e-5 relative, the train-mode
    probabilities within 1e-5, the BatchNorm statistics within 1e-5.
    Adam's first update moves an element by lr u / (|u| + eps), with u the
    clipped gradient plus wd p: JAX's and the port's first moments / (1 -
    b1) are held within 1e-5 of u's global norm (measured 1.2e-7 / 7.9e-8).
    Where JAX's |u| exceeds ten times both the element's disagreement d_u
    and eps, both packages' u share a sign and their updates differ by at
    most lr eps d_u / (0.9 |u|)^2 < 0.0124 lr, so the parameter after the
    step is held within lr / 50 (measured 8.6e-8 / 4.5e-7 at lr 1e-4). The
    rest, whose update may take either sign, are held within 2 lr (Adam's
    step is at most lr); they are at most 10 % of the elements (measured: 7
    of 51,434 for the classifier, 1,023,042 of 14,470,136 = 7.1 % for DAFT,
    a 3-D ResNet whose u is mostly below 10 eps at 16^3)."""
    rng = np.random.default_rng(3)
    img, pet, tab = _inputs(rng, b=4)
    lr = 1e-3
    if arch == "daft":
        jm = JDAFT(dropout_rate=0.0, dtype=jnp.float32)
        v = _random_variables(jm, rng, img, tab)
        tm = DAFTResNet(table_dim=TABLE_DIM, dropout_rate=0.0, compute_dtype=torch.float32)
        tm.load_state_dict(daft_state_dict_from_flax(v))
        to_sd = daft_state_dict_from_flax
    else:
        jm = JMC(use_pet=True, use_table=True, dropout=0.0, dtype=jnp.float32, **SMALL)
        v = _random_variables(jm, rng, img, pet=pet, table=tab)
        tm = MultimodalClassifier(use_pet=True, use_table=True, table_dim=TABLE_DIM,
                                  dropout=0.0, compute_dtype=torch.float32, **SMALL)
        tm.load_state_dict(multimodal_state_dict_from_flax(v, True, True, SMALL["depth"]))

        def to_sd(variables):
            return multimodal_state_dict_from_flax(variables, True, True, SMALL["depth"])
    batch = {"image": img, "pet": pet, "table": tab,
             "label": np.array([0, 1, 1, 0], np.int32),
             "mask": np.array([1, 1, 1, 0], np.float32)}
    cw = np.array([0.5, 0.25], np.float32)
    schedule = jloop.make_epoch_schedule(lr, 10)
    tx = jloop.make_optimizer(schedule, 1e-4, 1.0, "adam")
    state = jloop.TrainState(params=v["params"], batch_stats=v["batch_stats"],
                             opt_state=tx.init(v["params"]), epoch=jnp.zeros((), jnp.int32),
                             tx=tx, apply_fn=jm.apply)
    train_step, _ = jfusion.make_fusion_steps(jm, arch)
    jstate, jloss, jprobs = train_step(state, {k: jnp.asarray(a) for k, a in batch.items()},
                                       jnp.asarray(cw), jax.random.PRNGKey(0))
    tstate = create_train_state(tm, make_epoch_schedule(lr, 10), 1e-4, 1.0, "adam")
    step, _ = tfusion.make_fusion_steps(arch, use_pet=arch != "daft", use_table=True)
    tloss, tprobs = step(tstate, {k: torch.from_numpy(a) for k, a in batch.items()},
                         torch.from_numpy(cw))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), rtol=0, atol=1e-5)
    after = to_sd({"params": jax.device_get(jstate.params),
                   "batch_stats": jax.device_get(jstate.batch_stats)})
    adam = [s for s in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    u = to_sd({"params": jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, adam.mu),
               "batch_stats": jax.device_get(jstate.batch_stats)})
    params = dict(tm.named_parameters())
    u_t = {k: tstate.optimizer.state[q]["exp_avg"] / 0.1 for k, q in params.items()}
    u_norm = float(torch.sqrt(sum((u[k].double() ** 2).sum() for k in params)))
    du = max(float((u_t[k] - u[k]).abs().max()) for k in params)
    assert du <= 1e-5 * u_norm, (du, u_norm)
    lr0 = schedule(0)
    sd = tm.state_dict()
    n_loose = n_all = 0
    for k, ref in after.items():
        if "num_batches" in k:
            continue
        d = (sd[k] - ref).abs()
        if k not in params:
            assert float(d.max()) <= 1e-5, k
            continue
        big = u[k].abs() > 10 * torch.clamp((u_t[k] - u[k]).abs(), min=1e-8)
        if big.any():
            assert float(d[big].max()) <= lr0 / 50, k
        if (~big).any():
            assert float(d[~big].max()) <= 2 * lr0, k
        n_loose += int((~big).sum())
        n_all += d.numel()
    assert n_loose <= 0.1 * n_all, (n_loose, n_all)


def _fusion_table_csv(path, records, seed=0):
    """A clinical CSV keyed by the manifest's subjects: Subject_ID, Group,
    12 filler columns, 6 label-shifted features (the features from column
    14, as cli.train_fusion reads them)."""
    rng = np.random.default_rng(seed)
    groups = {0: "AD", 1: "CN"}
    y = np.array([r["label"] for r in records])
    cols = {"Subject_ID": np.array([r["Subject"] for r in records], dtype=object),
            "Group": np.array([groups[v] for v in y], dtype=object)}
    for j in range(12):
        cols[f"meta{j}"] = rng.normal(size=len(y)).round(3)
    for j in range(6):
        cols[f"feat{j}"] = (rng.normal(size=len(y)) + 1.5 * y).astype(np.float32)
    return write_table(path, cols)


def test_fusion_cv_and_test_run(fusion_dir, tmp_path):
    """2 folds x 2 epochs of MRI + PET + table at 16^3 on the CPU (the
    embedder ICLClassifier on the bundled asset, one view): finite scores,
    fusion_results.csv with a row per fold and epoch, the fold checkpoints;
    test_fusion_models over the held-out split gives the seven metrics."""
    from multimodal_ad_tpu_torch.tabular import ICLClassifier
    from multimodal_ad_tpu_torch.data.splits import stratified_test_split

    recs = _records(fusion_dir)
    cfg = Config(label_file=fusion_dir["label_file"], mri_dir=fusion_dir["mri_dir"],
                 pet_dir=fusion_dir["pet_dir"], num_epochs=2, batch_size=4, lr=1e-3,
                 n_splits=2, checkpoint_dir=str(tmp_path / "ckpt"), compute_dtype="float32",
                 loader_threads=2, augment=True)
    emb = ICLClassifier(preprocess=None, n_estimators=1, device="cpu")
    kw = dict(use_pet=True, use_table=True, table_data=_table_for(recs),
              model_kw=dict(SMALL, depth=1), embedder=emb, device="cpu", verbose=False)
    best, ckpt_dir = tfusion.train_fusion_cv(cfg, records=recs, **kw)
    assert len(best) == 2 and all(np.isfinite(best))
    with open(os.path.join(ckpt_dir, "fusion_results.csv")) as f:
        assert len(f.read().strip().splitlines()) == 1 + 2 * 2
    for k in (1, 2):
        assert os.path.isfile(os.path.join(ckpt_dir, f"fusion_best_fold{k}", "model.pt"))
    tr_val, test_data = stratified_test_split(recs, cfg.split_ratio, cfg.seed)
    run_test = tfusion.test_fusion_models
    res = run_test(cfg, test_data, train_subjects=[r["Subject"] for r in tr_val], **kw)
    assert set(res["avg"]) == {"ACC", "PRE", "SEN", "SPE", "F1", "AUC", "MCC"}
    assert len(res["per_fold"]) == 2
    assert all(np.isfinite(v) for v in res["avg"].values())


def test_cli_train_fusion_and_daft_without_table(fusion_dir, tmp_path, capsys):
    """cli.train_fusion --arch daft --use-table on the CPU (a table CSV keyed
    by subject, read without pandas); --arch daft without a table raises
    as the JAX package's train_fusion_cv does."""
    from multimodal_ad_tpu_torch.cli import train_fusion as cli

    recs = _records(fusion_dir)
    table = _fusion_table_csv(str(tmp_path / "table.csv"), recs)
    X, y, subjects = cli.read_fusion_table(table)
    assert X.shape == (len(recs), 6) and subjects == [r["Subject"] for r in recs]
    args = [f"label_file={fusion_dir['label_file']}", f"mri_dir={fusion_dir['mri_dir']}",
            "num_epochs=1", "batch_size=4", "n_splits=2", "compute_dtype=float32",
            "loader_threads=2", f"checkpoint_dir={tmp_path / 'ckpt'}"]
    best = cli.main(["--arch", "daft", "--use-table", "--table", table, "--device", "cpu"]
                    + args)
    assert len(best) == 2 and all(np.isfinite(best))
    assert "best fold scores" in capsys.readouterr().out
    cfg = Config(label_file=fusion_dir["label_file"], mri_dir=fusion_dir["mri_dir"])
    for make in (jfusion.train_fusion_cv, tfusion.train_fusion_cv):
        with pytest.raises(ValueError, match="daft"):
            make(cfg, use_table=False, arch="daft")
    with pytest.raises(ValueError, match="daft"):
        tfusion.train_fusion_cv(cfg, use_table=True, use_pet=True, arch="daft")
