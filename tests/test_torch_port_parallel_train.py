"""The port's entry points under a data-parallel mesh on the CPU: ranks are
spawned gloo processes (`run_ranks`), or a `torch.distributed.run` launch.

- `train_cv` (resident corpus, augmentation drawn for the global batch,
  precise-BN; 2 folds x 1 epoch at 16x20x16, dropout 0) at W = 2 against
  one process: the CSV's metrics and losses, and every fold checkpoint
  held as train steps are held (`test_torch_port_parallel._assert_u_and_
  params`' element rule); rank 1 writes nothing;
- the U-Net classifier and autoencoder trainers and `train_fusion_cv`
  at W = 2 against one process;
- `EnsemblePredictor(mesh=)` bf16, fp32 and int8 probabilities, on every
  rank, against one process;
- `extract_unet_features` / `extract_encoder_features` at W = 2: the
  same rows in the same order, values within 1e-6;
- the divisibility ValueErrors;
- `cli.train_resnet3d` under ``python -m torch.distributed.run
  --nproc_per_node=2 --device cpu``: exit 0, the config printed once, the
  CSV and checkpoints; a batch the ranks cannot split makes it exit
  non-zero;
- `entry.dryrun_multichip(2)` on the CPU; `entry.entry()`'s forward;
- each example of `multimodal_ad_tpu_torch.examples` with
  ``device="cpu"``.
"""

import csv
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from multimodal_ad_tpu_torch.core.config import Config
from multimodal_ad_tpu_torch.data.adni import ADNIManifest
from multimodal_ad_tpu_torch.data.synthetic import make_adni_dir, make_atlas, make_volume
from multimodal_ad_tpu_torch.models.resnet3d import generate_model
from multimodal_ad_tpu_torch.models.unet3d import UNet3D, UNet3DClassifier
from multimodal_ad_tpu_torch.parallel import mesh as pmesh
from test_torch_port_support import cap_torch_threads, run_ranks

cap_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (16, 20, 16)
NARROW = dict(level_channels=(8, 16, 32), bottleneck_channel=64)


@pytest.fixture
def adni(tmp_path):
    csv_path, mri_dir = make_adni_dir(str(tmp_path / "adni"), n_per_class=8,
                                      shape=SHAPE, seed=3)
    return csv_path, mri_dir


def _cfg(adni, ckpt, **kw):
    base = dict(label_file=adni[0], mri_dir=adni[1], task="ADCN", num_epochs=1,
                batch_size=4, lr=1e-3, n_splits=2, model_depth=10,
                compute_dtype="float32", dropout_rate=0.0, loader_threads=2,
                checkpoint_dir=ckpt, hbm_cache=True, augment=True, precise_bn=True)
    base.update(kw)
    return Config(**base)


def _read_csv(path):
    with open(path) as f:
        return list(csv.reader(f))


def _checkpoints(ckpt):
    from multimodal_ad_tpu_torch.train import checkpoint as tck

    out = {}
    for name in sorted(os.listdir(ckpt)):
        if os.path.isfile(os.path.join(ckpt, name, "model.pt")):
            out[name] = tck.restore_state(os.path.join(ckpt, name))[0]
    return out


def _free(tmp_path):
    """Remove the test's files (fold checkpoints hold Adam's moments: ~170
    MB each at depth 10) once checked."""
    import shutil

    for p in tmp_path.iterdir():
        shutil.rmtree(p) if p.is_dir() else p.unlink()


def _count_writes():
    """Count this process's checkpoint saves and CV loggers opened."""
    from multimodal_ad_tpu_torch.train import checkpoint as tck
    from multimodal_ad_tpu_torch.utils import logging as tlog

    counts = {"saves": 0, "loggers": 0}
    save, init = tck.save_checkpoint, tlog.CVLogger.__init__

    def counted_save(*a, **k):
        counts["saves"] += 1
        return save(*a, **k)

    def counted_init(self, *a, **k):
        counts["loggers"] += 1
        return init(self, *a, **k)

    tck.save_checkpoint = counted_save
    tlog.CVLogger.__init__ = counted_init
    return counts


# ---- rank functions (module level: each spawned rank imports this file) ----

def _train_cv_rank(cfg_dict):
    from multimodal_ad_tpu_torch.train.cv import train_cv

    counts = _count_writes()
    results, _ = train_cv(Config.from_dict(cfg_dict), device="cpu", verbose=False)
    return {"counts": counts, "avg": results["avg"]}


def _single_split_rank(cfg_dict, which):
    from multimodal_ad_tpu_torch.train.autoencoder import train_unet_autoencoder
    from multimodal_ad_tpu_torch.train.single_split import train_unet_classifier

    cfg = Config.from_dict(cfg_dict)
    counts = _count_writes()
    if which == "classifier":
        model = UNet3DClassifier(base_ch=4, compute_dtype=torch.float32,
                                 generator=torch.Generator().manual_seed(3))
        best, _ = train_unet_classifier(cfg, model=model, device="cpu", verbose=False)
    else:
        model = UNet3D(generator=torch.Generator().manual_seed(0), **NARROW)
        best, _ = train_unet_autoencoder(cfg, model=model, device="cpu", verbose=False)
    return {"counts": counts, "best": best}


def _fusion_rank(cfg_dict, table_data):
    from multimodal_ad_tpu_torch.tabular import ICLClassifier
    from multimodal_ad_tpu_torch.train.fusion import train_fusion_cv

    best, _ = train_fusion_cv(
        Config.from_dict(cfg_dict), use_table=True, table_data=table_data,
        model_kw=dict(dim=16, depth=1, heads=2, dim_head=8, mlp_dim=32),
        embedder=ICLClassifier(preprocess=None, n_estimators=1, device="cpu"),
        device="cpu", verbose=False)
    return best


def _fold_state_dicts():
    return [generate_model(model_depth=10, compute_dtype=torch.float32,
                           generator=torch.Generator().manual_seed(s)).state_dict()
            for s in (1, 2)]


def _predict(vols, dtype, mesh=None):
    from multimodal_ad_tpu_torch.serve import EnsemblePredictor

    template = generate_model(model_depth=10, compute_dtype=dtype)
    pred = EnsemblePredictor(template, _fold_state_dicts(), batch_size=4, device="cpu",
                             mesh=mesh)
    out = {"probs": pred.predict_proba(vols)}
    if dtype == torch.bfloat16:
        out["int8"] = pred.quantize_int8(vols[:3]).predict_proba(vols)
    return out


def _predict_rank(vols):
    mesh = pmesh.make_mesh()
    return {str(dt): _predict(vols, dt, mesh) for dt in (torch.float32, torch.bfloat16)}


def _extract(records, out_dir, mesh=None):
    from multimodal_ad_tpu_torch.eval.features import (extract_encoder_features,
                                                       extract_unet_features)

    atlas = make_atlas(SHAPE, n_rois=5, seed=0)
    unet = UNet3D(generator=torch.Generator().manual_seed(0), **NARROW)
    extract_unet_features(records, atlas, [f"R{i}" for i in range(1, 6)],
                          os.path.join(out_dir, "unet"), model=unet, batch_size=4,
                          num_threads=2, device="cpu", mesh=mesh)
    extract_encoder_features(records, os.path.join(out_dir, "enc"), depth=10, batch_size=4,
                             num_threads=2, device="cpu", mesh=mesh)


def _extract_rank(records, out_dir):
    _extract(records, out_dir)  # the default mesh: every rank
    return torch.distributed.get_rank()


def _divisibility_rank(adni_csv, mri_dir, ckpt):
    from multimodal_ad_tpu_torch.data.device_cache import DeviceDataset, DeviceEpochIterator
    from multimodal_ad_tpu_torch.eval.features import extract_unet_features
    from multimodal_ad_tpu_torch.serve import EnsemblePredictor
    from multimodal_ad_tpu_torch.train.cv import train_cv

    mesh = pmesh.make_mesh()
    errors = []
    calls = [
        lambda: train_cv(_cfg((adni_csv, mri_dir), ckpt, batch_size=3), device="cpu"),
        lambda: EnsemblePredictor(generate_model(model_depth=10), _fold_state_dicts(),
                                  batch_size=3, device="cpu", mesh=mesh),
        lambda: DeviceEpochIterator(DeviceDataset(np.zeros((4, 2, 2, 2, 1), np.float32),
                                                  np.zeros(4), device="cpu", mesh=mesh),
                                    [0, 1, 2], 3),
        lambda: extract_unet_features([], np.zeros(SHAPE), ["R1"], ckpt, batch_size=5,
                                      device="cpu", mesh=mesh),
    ]
    for call in calls:
        try:
            call()
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    return errors


# ---- tests ------------------------------------------------------------------

def test_train_cv_two_ranks_match_one_process(adni, tmp_path):
    """`train_cv` (resident, augmented, precise-BN, 2 folds x 1 epoch) at
    W = 2 against one process on the same data: the CSV's metrics and
    losses within 1e-5; every checkpoint's parameters within 2 lr a step
    taken and 99 % of them within 1e-5 (Adam can step either way where a
    gradient is near zero, a difference of up to 2 lr that the next
    forward carries into the BatchNorm statistics: those within 1e-4,
    measured 1.2e-5), the test metrics equal; rank 1 saved no checkpoint
    and opened no log."""
    from multimodal_ad_tpu_torch.train.cv import train_cv

    one = _cfg(adni, str(tmp_path / "one"))
    results, _ = train_cv(one, device="cpu", verbose=False)
    two = _cfg(adni, str(tmp_path / "two"))
    res = run_ranks(_train_cv_rank, 2, tmp_path, two.to_dict())
    assert res[0]["counts"]["saves"] > 0 and res[0]["counts"]["loggers"] == 1
    assert res[1]["counts"] == {"saves": 0, "loggers": 0}
    for r in res:
        assert r["avg"] == pytest.approx(results["avg"], rel=1e-6, abs=1e-6)
    rows1, rows2 = (_read_csv(os.path.join(c, "cv_results.csv")) for c in (one.checkpoint_dir,
                                                                            two.checkpoint_dir))
    assert rows1[0] == rows2[0] and len(rows1) == len(rows2) == 3
    for a, b in zip(rows1[1:], rows2[1:]):
        for name, x, y in zip(rows1[0], a, b):
            assert float(x) == pytest.approx(float(y), abs=1e-5), name
    ck1, ck2 = _checkpoints(one.checkpoint_dir), _checkpoints(two.checkpoint_dir)
    assert sorted(ck1) == sorted(ck2) == ["best_fold1", "best_fold2", "model_fold1_final",
                                          "model_fold2_final"]
    steps = 2  # at most: 6 or 7 training subjects a fold, batches of 4
    for name in ck1:
        deltas = []
        for k, v in ck1[name].items():
            d = (ck2[name][k].double() - v.double()).abs()
            if ".running_" in k:
                assert float(d.max()) <= 1e-4, (name, k)
            elif v.is_floating_point():
                deltas.append(d.flatten())
        d = torch.cat(deltas)
        assert float(d.max()) <= 2 * one.lr * steps, name
        assert float((d <= 1e-5).double().mean()) >= 0.99, name
    _free(tmp_path)


@pytest.mark.parametrize("which", ["classifier", "autoencoder"])
def test_unet_trainers_two_ranks_match_one_process(adni, tmp_path, which):
    """The single-split U-Net trainers at W = 2 against one process (2
    epochs, 4 AdamW updates): the best validation AUC (classifier) or MSE
    (autoencoder, whose noise masks are drawn for the global batch) within
    rel 1e-5; rank 1 writes nothing. At lr 1e-5: Adam moves every element
    by up to lr whatever its gradient's size, so elements whose gradients
    differ only in the order of the sums can step apart by 2 lr an update;
    at lr 1e-3 the autoencoder's MSE then differs by 1.1e-3 relative after
    4 updates (3.2e-5 after 2), at lr 1e-5 by 3.8e-6 (measured on this
    data)."""
    kw = dict(num_epochs=2, batch_size=4, augment=False, lr=1e-5)
    cfg = _cfg(adni, str(tmp_path / "one"), **kw)
    ref = _single_split_rank(cfg.to_dict(), which)["best"]
    two = _cfg(adni, str(tmp_path / "two"), **kw)
    res = run_ranks(_single_split_rank, 2, tmp_path, two.to_dict(), which)
    assert res[1]["counts"] == {"saves": 0, "loggers": 0}
    assert res[0]["counts"]["saves"] > 0
    for r in res:
        assert r["best"] == pytest.approx(ref, rel=1e-5)


def test_fusion_cv_two_ranks_match_one_process(adni, tmp_path):
    """`train_fusion_cv` (image + table, cross transformer, dropout 0) at
    W = 2 against one process: each fold's best score within 1e-5."""
    from multimodal_ad_tpu_torch.cli.train_fusion import read_fusion_table
    from multimodal_ad_tpu_torch.data.tabular import write_table

    recs = ADNIManifest(adni[0], adni[1], verbose=False).data_dict
    rng = np.random.default_rng(0)
    y = np.array([r["label"] for r in recs])
    cols = {"Subject_ID": np.array([r["Subject"] for r in recs], dtype=object),
            "Group": np.array(["CN" if v else "AD" for v in y], dtype=object)}
    for j in range(12):
        cols[f"m{j}"] = rng.normal(size=len(y)).round(3)
    for j in range(6):
        cols[f"f{j}"] = (rng.normal(size=len(y)) + y).astype(np.float32)
    table = read_fusion_table(write_table(str(tmp_path / "t.csv"), cols))
    cfg = _cfg(adni, str(tmp_path / "one"), hbm_cache=False, augment=False)
    ref = _fusion_rank(cfg.to_dict(), table)
    two = _cfg(adni, str(tmp_path / "two"), hbm_cache=False, augment=False)
    for best in run_ranks(_fusion_rank, 2, tmp_path, two.to_dict(), table):
        np.testing.assert_allclose(best, ref, rtol=1e-5, atol=1e-5)
    def written(d):  # TensorBoard's event files carry host and time
        return sorted(n for n in os.listdir(d) if not n.startswith("events."))
    assert written(two.checkpoint_dir) == written(cfg.checkpoint_dir)


def test_predictor_two_ranks_match_one_process(tmp_path):
    """`EnsemblePredictor(mesh=)` over 2 ranks on 11 volumes (chunks 4 + 4 +
    3, the last padded): fp32 and bf16 probabilities within 1e-6 of one
    process's on every rank, int8 (calibrated on the whole set on every
    rank) within 1e-6."""
    rng = np.random.default_rng(0)
    vols = np.stack([make_volume(rng, SHAPE, label=i % 2) for i in range(11)])
    res = run_ranks(_predict_rank, 2, tmp_path, vols)
    for dt in (torch.float32, torch.bfloat16):
        ref = _predict(vols, dt)
        for r in res:
            for k, v in ref.items():
                assert r[str(dt)][k].shape == (11, 2)
                np.testing.assert_allclose(r[str(dt)][k], v, rtol=0, atol=1e-6,
                                           err_msg=f"{dt} {k}")


def test_extraction_two_ranks_match_one_process(adni, tmp_path):
    """U-Net ROI and encoder extraction at W = 2 (the default mesh of an
    initialized group): the same files, rows and order as one process's,
    values within 1e-6; the stage-tap shapes name the global batch."""
    records = ADNIManifest(adni[0], adni[1], verbose=False).data_dict[:10]
    _extract(records, str(tmp_path / "one"))
    run_ranks(_extract_rank, 2, tmp_path, records, str(tmp_path / "two"))
    for sub, name in (("unet", "features.csv"), ("unet", "roi_features.csv"),
                      ("enc", "adni_features.csv"), ("enc", "feature_map_shapes.csv")):
        a = _read_csv(tmp_path / "one" / sub / name)
        b = _read_csv(tmp_path / "two" / sub / name)
        assert len(a) == len(b) and a[0] == b[0], name
        for ra, rb in zip(a[1:], b[1:]):
            assert ra[0] == rb[0], name
            if name == "feature_map_shapes.csv":
                assert ra == rb
            else:
                np.testing.assert_allclose(np.float64(rb[1:]), np.float64(ra[1:]),
                                           rtol=0, atol=1e-6, err_msg=name)


def test_batch_that_does_not_split_raises(adni, tmp_path):
    """A batch size the data axis does not divide raises ValueError in
    train_cv, EnsemblePredictor, DeviceEpochIterator and the extractors."""
    res = run_ranks(_divisibility_rank, 2, tmp_path, adni[0], adni[1], str(tmp_path / "ck"))
    for errors in res:
        assert len(errors) == 4
        for e in errors:
            assert e is not None and "not divisible by the mesh data axis (2)" in e, errors


def _launch(args, tmp_path, timeout=300):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO, MAD_TEST_TPU="1")
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
         "-m", "multimodal_ad_tpu_torch.cli.train_resnet3d", "--device", "cpu"] + args,
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=timeout)


def test_cli_under_torch_distributed_run(adni, tmp_path):
    """`cli.train_resnet3d` launched over 2 gloo ranks: exit 0, the config
    printed once (rank 0), the 19-column CSV of 2 folds x 1 epoch and the
    fold checkpoints; with a batch of 3 every rank raises and the launch
    exits non-zero."""
    ckpt = tmp_path / "ckpt"
    args = [f"label_file={adni[0]}", f"mri_dir={adni[1]}", "model_depth=10",
            "batch_size=4", "num_epochs=1", "n_splits=2", "compute_dtype=float32",
            "loader_threads=2", f"checkpoint_dir={ckpt}"]
    res = _launch(args, tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.count("Configuration Parameters:") == 1
    assert "checkpoints:" in res.stdout
    rows = _read_csv(ckpt / "cv_results.csv")
    assert len(rows) == 3 and all(len(r) == 19 for r in rows)
    for k in (1, 2):
        assert (ckpt / f"best_fold{k}" / "model.pt").is_file()
    _free(tmp_path)
    bad = _launch(args[:-1] + ["batch_size=3", f"checkpoint_dir={tmp_path / 'bad'}"], tmp_path)
    assert bad.returncode != 0
    assert "not divisible by the mesh data axis (2)" in bad.stderr + bad.stdout


def test_dryrun_multichip_on_the_cpu(monkeypatch, capsys):
    """The port's dry run: one DP train step of ResNet-10 over 2 gloo ranks
    on the CPU; a finite loss and the line saying where it ran."""
    from multimodal_ad_tpu_torch.entry import dryrun_multichip

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    loss = dryrun_multichip(2, device="cpu")
    assert np.isfinite(loss)
    assert "dryrun_multichip(2): dp train step over 2 gloo processes on the CPU OK" in (
        capsys.readouterr().out)


def test_entry_forward_on_the_cpu():
    from multimodal_ad_tpu_torch.entry import FLAGSHIP_INPUT, entry

    forward, (model, x) = entry(device="cpu")
    assert tuple(x.shape) == FLAGSHIP_INPUT
    logits = forward(model, x[:1, :32, :32, :32])
    assert tuple(logits.shape) == (1, 2) and bool(torch.isfinite(logits).all())
    with pytest.raises(RuntimeError, match="CUDA"):
        if not torch.cuda.is_available():
            entry()


@pytest.mark.parametrize("name", ["train_tiny_cv", "roi_features", "serve_int8",
                                  "tabular_embeddings", "tabular_regression",
                                  "fusion_real_table"])
def test_example_runs(name, tmp_path, monkeypatch):
    import importlib
    import tempfile

    from multimodal_ad_tpu_torch import examples

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # the example's work dir

    assert name in examples.EXAMPLES
    mod = importlib.import_module(f"multimodal_ad_tpu_torch.examples.{name}")
    assert mod.main(device="cpu") is not None
    _free(tmp_path)
