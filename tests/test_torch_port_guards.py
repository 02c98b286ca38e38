"""Guards of the port: it imports without JAX or the JAX package, names
neither, never falls back to the CPU when CUDA is asked for, and its CUDA
kernels K1 and K2 agree with their plain versions on a card (those tests
carry the `cuda` marker and skip where there is none), as do three fp32
train steps and the training epoch iterator. This file imports no JAX, so
it also runs on the card's machine."""

import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import multimodal_ad_tpu_torch
from multimodal_ad_tpu_torch.data.synthetic import make_atlas
from multimodal_ad_tpu_torch.ops import fused_gather as tfg
from multimodal_ad_tpu_torch.ops import roi_pool as trp

PKG_DIR = os.path.dirname(multimodal_ad_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG_DIR], prefix="multimodal_ad_tpu_torch."))


def test_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax',"
        " 'multimodal_ad_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_sources_name_neither_jax_nor_the_jax_package():
    pat = re.compile(r"\bjax\b|\bmultimodal_ad_tpu\b", re.IGNORECASE)
    hits = []
    for root, _, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                path = os.path.join(root, f)
                with open(path) as fh:
                    for i, line in enumerate(fh, 1):
                        if pat.search(line):
                            hits.append(f"{path}:{i}: {line.strip()}")
    assert not hits, "\n".join(hits)


def test_extraction_runs_without_sklearn_pandas_or_matplotlib(tmp_path):
    """The card's machine has none of them: the extraction CLI runs end to
    end on the CPU with them (and JAX) blocked."""
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'multimodal_ad_tpu', 'sklearn', 'pandas',"
        " 'matplotlib'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np\n"
        "from multimodal_ad_tpu_torch.cli.extract_features import main\n"
        "from multimodal_ad_tpu_torch.data.synthetic import make_adni_dir, make_atlas\n"
        "from multimodal_ad_tpu_torch.utils import nifti\n"
        f"root = {str(tmp_path)!r}\n"
        "csv_path, mri = make_adni_dir(root, n_per_class=5, shape=(8, 8, 8))\n"
        "nifti.save(root + '/atlas.nii', make_atlas((8, 8, 8), 3).astype(np.int16))\n"
        "main(['--atlas', root + '/atlas.nii', '--out', root + '/out', '--device',"
        " 'cpu', 'label_file=' + csv_path, 'mri_dir=' + mri, 'loader_threads=2'])\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
    assert os.path.isfile(tmp_path / "out" / "roi_features.csv")


def test_training_runs_without_sklearn_pandas_matplotlib_or_tensorboard(tmp_path):
    """The card's machine has none of them: the training CLI (resident,
    augmented, precise-BN) and cli.evaluate run end to end on the CPU with
    them (and JAX) blocked; the ROC plot is skipped with a warning."""
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'optax', 'multimodal_ad_tpu', 'sklearn',"
        " 'pandas', 'matplotlib', 'tensorboard'):\n"
        "    sys.modules[name] = None\n"
        "from multimodal_ad_tpu_torch.cli.evaluate import main as evaluate\n"
        "from multimodal_ad_tpu_torch.cli.train_resnet3d import main as train\n"
        "from multimodal_ad_tpu_torch.data.synthetic import make_adni_dir\n"
        f"root = {str(tmp_path)!r}\n"
        "csv_path, mri = make_adni_dir(root, n_per_class=5, shape=(12, 12, 12))\n"
        "args = ['--device', 'cpu', 'label_file=' + csv_path, 'mri_dir=' + mri,"
        " 'num_epochs=1', 'batch_size=4', 'n_splits=2', 'model_depth=10',"
        " 'compute_dtype=float32', 'loader_threads=2', 'checkpoint_dir=' + root + '/ckpt']\n"
        "train(args + ['hbm_cache=true', 'augment=true', 'precise_bn=true'])\n"
        "evaluate(args)\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
    assert res.stdout.count("[warn] ROC plot skipped") == 2
    assert os.path.isfile(tmp_path / "ckpt" / "cv_results.csv")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_a_card(no_cuda, tmp_path):
    from multimodal_ad_tpu_torch.cli.extract_features import main as extract_main
    from multimodal_ad_tpu_torch.cli.predict import main
    from multimodal_ad_tpu_torch.core.device import resolve_device
    from multimodal_ad_tpu_torch.data.device_cache import (
        DeviceDataset, build_device_dataset)
    from multimodal_ad_tpu_torch.eval.features import extract_unet_features
    from multimodal_ad_tpu_torch.models.resnet3d import generate_model
    from multimodal_ad_tpu_torch.serve import EnsemblePredictor
    from multimodal_ad_tpu_torch.utils import nifti

    model = generate_model(model_depth=10)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        EnsemblePredictor(model, [model.state_dict()])
    with pytest.raises(RuntimeError, match="CUDA"):
        EnsemblePredictor.from_checkpoint_dir(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceDataset(np.zeros((2, 3, 3, 3, 1), np.int16), np.zeros(2))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_device_dataset([])
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--ckpt-dir", str(tmp_path), "--volumes", "a.nii"])
    with pytest.raises(RuntimeError, match="CUDA"):
        extract_unet_features([], np.ones((4, 4, 4), np.int32), ["A"], str(tmp_path))
    labels = str(tmp_path / "labels.csv")
    with open(labels, "w") as f:
        f.write("Subject_ID,Group\n" + "".join(f"S{i},{'AD' if i % 2 else 'CN'}\n"
                                               for i in range(10)))
    atlas = str(tmp_path / "atlas.nii")
    nifti.save(atlas, np.ones((4, 4, 4), np.int16))
    with pytest.raises(RuntimeError, match="CUDA"):
        extract_main(["--atlas", atlas, "--out", str(tmp_path / "out"),
                      f"label_file={labels}", f"mri_dir={tmp_path}"])
    from multimodal_ad_tpu_torch.cli.evaluate import main as evaluate_main
    from multimodal_ad_tpu_torch.cli.train_resnet3d import main as train_main
    from multimodal_ad_tpu_torch.core.config import Config
    from multimodal_ad_tpu_torch.train.cv import test_models, train_cv

    cfg_args = [f"label_file={labels}", f"mri_dir={tmp_path}",
                f"checkpoint_dir={tmp_path / 'ckpt'}"]
    with pytest.raises(RuntimeError, match="CUDA"):
        train_main(cfg_args)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_main(cfg_args)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cv(Config(label_file=labels, mri_dir=str(tmp_path)))
    with pytest.raises(RuntimeError, match="CUDA"):
        test_models(Config(), [])
    assert not os.path.exists(tmp_path / "ckpt")  # nothing ran on the host
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_build_needs_nvcc(monkeypatch):
    """Without nvcc the kernel build raises (no silent fallback); the
    library name follows the source's content."""
    from multimodal_ad_tpu_torch.ops import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR / "no-such-dir")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(["fused_gather"])
    assert re.fullmatch(r"libfused_gather-[0-9a-f]{16}\.so",
                        _build.library_path("fused_gather").name)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("src_dtype", [torch.uint8, torch.int16, torch.float32])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_kernel_matches_plain(cuda, src_dtype, out_dtype, idx_dtype):
    g = torch.Generator().manual_seed(0)
    if src_dtype == torch.float32:
        src = torch.randn((5, 37, 41, 29, 1), generator=g) * 100
    else:
        lo = 0 if src_dtype == torch.uint8 else -300
        hi = 256 if src_dtype == torch.uint8 else 3000
        src = torch.randint(lo, hi, (5, 37, 41, 29, 1), generator=g)
    src = src.to(src_dtype)
    src[3] = 7  # constant volume
    src = src.to(cuda)
    idx = torch.tensor([4, 0, 3, 4, 1], dtype=idx_dtype, device=cuda)
    before = tfg.gather_normalize.launches
    out = tfg.gather_normalize(src, idx, out_dtype)
    torch.cuda.synchronize()
    assert tfg.gather_normalize.launches == before + 1
    ref = tfg.gather_normalize_plain(src, idx, out_dtype)
    tol = 1e-6 if out_dtype == torch.float32 else 2.0 ** -8
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol)
    assert (out[2] == 0).all()


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    with pytest.raises(TypeError):
        tfg.gather_normalize(torch.zeros((2, 8), dtype=torch.float64, device=cuda),
                             np.array([0]))
    with pytest.raises(TypeError):
        tfg.gather_normalize(torch.zeros((2, 8), device=cuda), np.array([0]),
                             torch.float16)
    with pytest.raises(ValueError):
        tfg.gather_normalize(torch.zeros((8, 2), device=cuda).t(), np.array([0]))


def _check_k2(feats, labels, r):
    """K2 against its plain version in float64 (rtol 1e-5, atol 1e-6: f32
    sums of a few hundred values per lane) and bit-identical launches."""
    before = trp.roi_pool.launches
    a = trp.roi_pool(feats, labels, r)
    b = trp.roi_pool(feats, labels, r)
    torch.cuda.synchronize()
    assert trp.roi_pool.launches == before + 2
    ref = trp.roi_pool_plain(feats.double(), labels, r)
    torch.testing.assert_close(a.double(), ref, rtol=1e-5, atol=1e-6)
    assert torch.equal(a, b)  # deterministic: bit-identical launches
    return a


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["5d", "3d", "strided"])
def test_k2_matches_plain(cuda, dtype, layout):
    g = torch.Generator().manual_seed(0)
    labels = torch.from_numpy(make_atlas((12, 14, 12), n_rois=6, seed=1))
    labels[labels == 3] = 0  # ROI 3 empty; ROI 7 has no id at all
    if layout == "strided":  # a crop of a channels-last map, C = 80
        big = torch.randn((2, 16, 18, 16, 100), generator=g)
        feats = big.to(cuda, dtype)[:, 1:13, 2:16, 3:15, 10:90]
    else:
        feats = torch.randn((2, 12, 14, 12, 8), generator=g).to(cuda, dtype)
        if layout == "3d":
            feats = feats.reshape(2, -1, 8)
    out = _check_k2(feats, labels.to(cuda), 7)
    assert (out[:, 2] == 0).all() and (out[:, 6] == 0).all()


@pytest.mark.cuda
def test_k2_600_rois(cuda):
    g = torch.Generator().manual_seed(1)
    labels = torch.randint(0, 601, (20, 22, 18), generator=g, dtype=torch.int32)
    feats = torch.randn((1, 20, 22, 18, 64), generator=g).to(cuda)
    atlas = trp.RoiAtlas.build(labels, 600, cuda)
    _check_k2(feats, atlas, 600)


@pytest.mark.cuda
def test_k2_rejects_what_it_does_not_take(cuda):
    labels = torch.ones((2, 2, 2), dtype=torch.int32)
    with pytest.raises(TypeError):
        trp.roi_pool(torch.zeros((1, 2, 2, 2, 4), dtype=torch.float64, device=cuda),
                     labels, 1)
    with pytest.raises(ValueError):  # 4-D features
        trp.roi_pool(torch.zeros((1, 8, 4), device=cuda)[None], labels, 1)
    with pytest.raises(ValueError):  # voxel count differs from the atlas
        trp.roi_pool(torch.zeros((1, 3, 2, 2, 4), device=cuda), labels, 1)
    with pytest.raises(ValueError):  # label 2 > num_rois
        trp.roi_pool(torch.zeros((1, 2, 2, 2, 4), device=cuda), labels * 2, 1)
    atlas = trp.RoiAtlas.build(labels, 1)  # on the host
    with pytest.raises(ValueError):
        trp.roi_pool(torch.zeros((1, 2, 2, 2, 4), device=cuda), atlas, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("path", trp.PATHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_one_voxel_long_and_empty_rois(cuda, path, dtype):
    """On both variants (the SIMT one through a channel crop): a one-voxel
    ROI, an ROI of 1,920 voxels over 30 tiles of 64, an empty ROI and an id
    without voxels."""
    g = torch.Generator().manual_seed(2)
    labels = torch.randint(3, 6, (10, 12, 40), generator=g, dtype=torch.int32)
    labels[2:6] = 2
    labels[0, 0, 0] = 1
    labels[labels == 4] = 0
    atlas = trp.RoiAtlas.build(labels, 6, cuda, tile_size=64)
    assert int(atlas.roi_tiles[2] - atlas.roi_tiles[1]) == 30
    width = 64 if path == "bulk" else 66
    feats = torch.randn((3, 10, 12, 40, width), generator=g).to(cuda, dtype)[..., :64]
    assert trp.k2_path(feats, atlas) == path
    before = trp.roi_pool.path_launches[path]
    out = _check_k2(feats, atlas, 6)
    assert trp.roi_pool.path_launches[path] == before + 2
    assert torch.equal(out[:, 0], feats[:, 0, 0, 0].float())  # one value, divided by 1
    assert (out[:, 3] == 0).all() and (out[:, 5] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tap crop", "unaligned crop"])
def test_k2_padded_crops(cuda, case):
    """A crop of a padded channels-last map, as the U-Net's tap (the bulk
    path), and a crop whose rows are not 16-byte aligned (the SIMT path)."""
    g = torch.Generator().manual_seed(3)
    labels = torch.from_numpy(make_atlas((12, 14, 40), n_rois=9, seed=4))
    atlas = trp.RoiAtlas.build(labels, 9, cuda, tile_size=32)
    if case == "tap crop":
        feats = torch.randn((2, 16, 16, 48, 64), generator=g).to(cuda)[:, :12, :14, :40]
    else:  # voxel stride 66 and a 4-byte offset
        feats = torch.randn((2, 13, 16, 43, 66), generator=g).to(cuda)[:, 1:, 2:, 3:, 1:65]
    expect = "bulk" if case == "tap crop" else "simt"
    assert trp.k2_path(feats, atlas) == expect
    before = trp.roi_pool.path_launches[expect]
    _check_k2(feats, atlas, 9)
    assert trp.roi_pool.path_launches[expect] == before + 2


def _check_k1_exact(src, idx, constant):
    """K1 against its plain version: bit-exact in f32, 1 ulp in bf16; the
    constant volume maps to 0."""
    for out_dtype in (torch.float32, torch.bfloat16):
        out = tfg.gather_normalize(src, idx, out_dtype)
        ref = tfg.gather_normalize_plain(src, idx, out_dtype)
        torch.cuda.synchronize()
        if out_dtype == torch.float32:
            assert torch.equal(out, ref)
        else:
            diff = (out.view(torch.int16).int() - ref.view(torch.int16).int()).abs()
            assert int(diff.max()) <= 1
        assert (out[idx == constant] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 33, 300])
def test_k1_batches(cuda, batch):
    """Cluster mode: B = 1, 33 and 300 over volumes of 37x41x29 = 43,993
    voxels (a multiple neither of 16 nor of a block's slice, so volumes
    start unaligned), int64 indices."""
    g = torch.Generator().manual_seed(batch)
    src = (torch.randn((4, 37, 41, 29), generator=g) * 50).to(cuda)
    src[2] = -3.0
    idx = torch.randint(0, 4, (batch,), generator=g).to(cuda)
    _check_k1_exact(src, idx, 2)
    assert tfg.gather_normalize.mode == "cluster"
    assert tfg.gather_normalize.blocks_per_volume == 16


@pytest.mark.cuda
@pytest.mark.parametrize("shape,batch", [((91, 109, 91), 8), ((91, 109, 91), 12),
                                         ((160, 160, 164), 3), ((80, 80, 80), 600)])
def test_k1_grid_mode(cuda, shape, batch):
    """Grid mode (float32 volumes too large for a cluster): slices that fit
    shared memory (8 full-size volumes), slices that do not and read the
    rest from global memory twice (12 of them; 3 of 4.2 M voxels), and 600
    volumes, more than the grid holds at once (rounds)."""
    g = torch.Generator().manual_seed(5)
    src = (torch.randn((3, *shape), generator=g) * 100).to(cuda)
    src[1] = 5.0
    idx = (torch.arange(batch, dtype=torch.int32) % 3).to(cuda)
    _check_k1_exact(src, idx, 1)
    assert tfg.gather_normalize.mode == "grid"
    per_vol, smem = tfg.gather_normalize.blocks_per_volume, tfg.gather_normalize.smem_bytes
    assert (per_vol * smem >= 4 * src[0].numel()) == (shape == (91, 109, 91) and batch == 8)


@pytest.mark.cuda
def test_k1_out_of_range_device_index_gives_a_nan_row(cuda):
    """Device indices are not read back; one out of range writes NaN."""
    g = torch.Generator().manual_seed(6)
    src = torch.randint(0, 256, (3, 9, 10, 11), generator=g, dtype=torch.uint8).to(cuda)
    idx = torch.tensor([2, 3, -1, 0], dtype=torch.int64, device=cuda)
    out = tfg.gather_normalize(src, idx, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.isnan(out[1].float()).all() and torch.isnan(out[2].float()).all()
    ref = tfg.gather_normalize_plain(src, idx[[0, 3]], torch.bfloat16)
    assert torch.equal(out[[0, 3]], ref)


def _train_three_steps(device):
    """Three fp32 train steps of a seeded ResNet-10 at 16x20x16, B = 4 (one
    padded row), dropout 0; returns the losses and the state_dict."""
    from multimodal_ad_tpu_torch.models.resnet3d import generate_model
    from multimodal_ad_tpu_torch.train import loop

    model = generate_model(model_depth=10, dropout_rate=0.0, compute_dtype=torch.float32,
                           generator=torch.Generator().manual_seed(0)).to(device)
    state = loop.create_train_state(model, loop.make_epoch_schedule(1e-3, 20))
    g = torch.Generator().manual_seed(1)
    cw = torch.tensor([0.3, 0.7], device=device)
    losses = []
    for _ in range(3):
        batch = {"image": (torch.randn((4, 16, 20, 16, 1), generator=g) * 2 + 1).to(device),
                 "label": torch.tensor([0, 1, 1, 0], device=device),
                 "mask": torch.tensor([1.0, 1.0, 1.0, 0.0], device=device)}
        loss, _ = loop.train_step(state, batch, cw)
        losses.append(float(loss))
    return losses, {k: v.cpu() for k, v in model.state_dict().items()}


@pytest.mark.cuda
def test_train_steps_on_the_card_match_the_host(cuda):
    """fp32 with TF32 off (resolve_device): card and host agree within 1e-3
    in the losses and the BN statistics; parameters within 6 lr, and 99.9 %
    of them within 1e-3 (Adam moves a parameter by about lr whatever its
    gradient's size, so where a gradient is near zero the two can step in
    opposite directions)."""
    from multimodal_ad_tpu_torch.core.device import resolve_device

    resolve_device("cuda")
    card_losses, card = _train_three_steps(cuda)
    host_losses, host = _train_three_steps(torch.device("cpu"))
    np.testing.assert_allclose(card_losses, host_losses, rtol=1e-3, atol=1e-3)
    deltas = []
    for name, v in host.items():
        if ".running_" in name:
            torch.testing.assert_close(card[name], v, rtol=1e-3, atol=1e-3, msg=name)
        elif v.is_floating_point():
            deltas.append((card[name] - v).abs().flatten())
    d = torch.cat(deltas)
    assert float(d.max()) <= 6e-3
    assert float((d <= 1e-3).float().mean()) >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("augment", [False, True])
def test_epoch_iterator_on_the_card_launches_k1(cuda, augment):
    """DeviceEpochIterator on the card gathers and normalizes with K1 (one
    launch a batch) and equals its host batches within 1e-6, augmented or
    not (the augmentation draws come from a host generator)."""
    from multimodal_ad_tpu_torch.data.device_cache import (DeviceDataset,
                                                           DeviceEpochIterator)

    g = torch.Generator().manual_seed(2)
    vols = (torch.randn((9, 20, 22, 18, 1), generator=g) * 50 + 100).numpy()
    labels = np.arange(9) % 2
    runs = {}
    for dev in ("cpu", "cuda"):
        ds = DeviceDataset(vols, labels, device=dev, store_dtype=np.float32)
        it = DeviceEpochIterator(ds, [8, 1, 2, 5, 0, 7, 3], 3, shuffle=True, seed=5,
                                 augment=augment, flip_prob=0.5, rotate_prob=0.5,
                                 zoom_prob=0.5)
        before = tfg.gather_normalize.launches
        runs[dev] = [b for _ in range(2) for b in it]
        torch.cuda.synchronize()
        runs[dev + "_launches"] = tfg.gather_normalize.launches - before
    assert runs["cuda_launches"] == len(runs["cuda"]) == 6
    assert runs["cpu_launches"] == 0
    for a, b in zip(runs["cpu"], runs["cuda"]):
        assert b["image"].device.type == "cuda"
        torch.testing.assert_close(b["image"].cpu(), a["image"], rtol=0, atol=1e-6)
        assert torch.equal(b["mask"].cpu(), a["mask"])
        assert torch.equal(b["label"].cpu(), a["label"])
        assert b["subject"] == a["subject"]
