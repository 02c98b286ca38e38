"""Guards of the port: it imports without JAX or the JAX package, names
neither, never falls back to the CPU when CUDA is asked for, and its CUDA
kernels K1, K2 and K3 agree with their plain versions on a card (those
tests carry the `cuda` marker and skip where there is none; K3 in all its
epilogues, the block output's included, on grids where whole tiles skip
taps and at odd channel counts), as do three fp32 train steps of the
ResNet and of the U-Net classifier, the training epoch iterator, the
host-planned augmentation, the int8 ensemble and depth-34 and depth-50
int8 folds, and the DenseNet train steps, encoder features, the seg head,
MSHyper and the native NIfTI decoder on the card's machine. This file
imports no JAX, so it also runs on the card's machine."""

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
from multimodal_ad_tpu_torch.ops import int8_conv as tk3
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


def test_unet_training_runs_without_sklearn_pandas_matplotlib_or_tensorboard(tmp_path):
    """The U-Net classifier CLI (host-planned augmentation) and the
    autoencoder -> trained extraction path run end to end on the CPU with
    JAX, sklearn, pandas, matplotlib and tensorboard blocked."""
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'optax', 'multimodal_ad_tpu', 'sklearn',"
        " 'pandas', 'matplotlib', 'tensorboard'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np\n"
        "from multimodal_ad_tpu_torch.cli.train_unet3d import main\n"
        "from multimodal_ad_tpu_torch.core.config import Config\n"
        "from multimodal_ad_tpu_torch.data.synthetic import make_adni_dir, make_atlas\n"
        "from multimodal_ad_tpu_torch.eval.features import extract_unet_features\n"
        "from multimodal_ad_tpu_torch.models.unet3d import UNet3D\n"
        "from multimodal_ad_tpu_torch.train.autoencoder import (load_autoencoder,"
        " train_unet_autoencoder)\n"
        f"root = {str(tmp_path)!r}\n"
        "csv_path, mri = make_adni_dir(root, n_per_class=5, shape=(16, 16, 16))\n"
        "args = ['label_file=' + csv_path, 'mri_dir=' + mri, 'num_epochs=1',"
        " 'batch_size=4', 'compute_dtype=float32', 'loader_threads=2']\n"
        "main(['--device', 'cpu', 'augment=true', 'checkpoint_dir=' + root + '/u'] + args)\n"
        "cfg = Config(label_file=csv_path, mri_dir=mri, num_epochs=1, batch_size=4,"
        " compute_dtype='float32', loader_threads=2, checkpoint_dir=root + '/ae')\n"
        "narrow = dict(level_channels=(4, 8, 16), bottleneck_channel=32)\n"
        "_, path = train_unet_autoencoder(cfg, model=UNet3D(**narrow), device='cpu')\n"
        "model = load_autoencoder(path, cfg, model=UNet3D(**narrow), device='cpu')\n"
        "recs = [{'MRI': mri + '/AD_000.nii', 'label': 1, 'Subject': 'AD_000'}]\n"
        "extract_unet_features(recs, make_atlas((16, 16, 16), 3), ['A', 'B', 'C'],"
        " root + '/out', model=model, device='cpu')\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
    assert os.path.isfile(tmp_path / "u" / "unet_results.csv")
    assert os.path.isfile(tmp_path / "out" / "roi_features.csv")


def test_int8_serving_runs_without_sklearn(tmp_path):
    """Serving, quantize_int8 and evaluate_records run end to end on the
    CPU with JAX and sklearn blocked; evaluate_records gives the int8
    ensemble's AUC and ACC."""
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'multimodal_ad_tpu', 'sklearn'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np, torch\n"
        "from multimodal_ad_tpu_torch.data.adni import ADNIManifest\n"
        "from multimodal_ad_tpu_torch.data.pipeline import load_volume\n"
        "from multimodal_ad_tpu_torch.data.synthetic import make_adni_dir\n"
        "from multimodal_ad_tpu_torch.models.resnet3d import generate_model\n"
        "from multimodal_ad_tpu_torch.serve import EnsemblePredictor, evaluate_records\n"
        f"root = {str(tmp_path)!r}\n"
        "csv_path, mri = make_adni_dir(root, n_per_class=3, shape=(12, 14, 12))\n"
        "recs = ADNIManifest(csv_path, mri, verbose=False).data_dict\n"
        "model = generate_model(model_depth=10, generator=torch.Generator().manual_seed(0))\n"
        "pred = EnsemblePredictor(model, [model.state_dict()] * 2, batch_size=4, device='cpu')\n"
        "fp = evaluate_records(pred, recs)\n"
        "pred.quantize_int8(np.stack([load_volume(r['MRI']) for r in recs[:3]]))\n"
        "q8 = evaluate_records(pred, recs)\n"
        "assert len(pred.int8_folds) == 2 and set(q8) == {'AUC', 'ACC'}, q8\n"
        "assert all(0.0 <= v <= 1.0 for v in (*fp.values(), *q8.values())), (fp, q8)\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_image_side_tools_run_without_sklearn_pandas_matplotlib_or_tensorboard(tmp_path):
    """cli.train_densenet, extract_encoder_features, cli.pvalue and
    cli.roi_visualize (queries and the HTML viewer, no --mri) run end to
    end on the CPU with JAX, sklearn, pandas, matplotlib and tensorboard
    blocked, as on the card's machine. scipy takes a 'jax' entry of
    sys.modules for the module, so for cli.pvalue that one entry goes and
    the run then checks that nothing imported JAX."""
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'optax', 'multimodal_ad_tpu', 'sklearn',"
        " 'pandas', 'matplotlib', 'tensorboard'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np\n"
        "from multimodal_ad_tpu_torch.cli import pvalue, roi_visualize, train_densenet\n"
        "from multimodal_ad_tpu_torch.data.adni import ADNIManifest\n"
        "from multimodal_ad_tpu_torch.data.synthetic import make_adni_dir, make_atlas\n"
        "from multimodal_ad_tpu_torch.eval.features import extract_encoder_features\n"
        "from multimodal_ad_tpu_torch.utils import nifti\n"
        f"root = {str(tmp_path)!r}\n"
        "csv_path, mri = make_adni_dir(root, n_per_class=5, shape=(12, 12, 12))\n"
        "train_densenet.main(['label_file=' + csv_path, 'mri_dir=' + mri, 'num_epochs=1',"
        " 'batch_size=4', 'n_splits=2', 'compute_dtype=float32', 'loader_threads=2',"
        " 'checkpoint_dir=' + root + '/ckpt', '--device', 'cpu', '--growth', '4',"
        " '--blocks', '2', '2'])\n"
        "recs = ADNIManifest(csv_path, mri, verbose=False).data_dict[:3]\n"
        "extract_encoder_features(recs, root + '/enc', depth=10, batch_size=2,"
        " num_threads=2, device='cpu')\n"
        "del sys.modules['jax']\n"
        "pvalue.main(['--a', '0.9', '0.8', '0.85', '--b', '0.95', '0.9', '0.93'])\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules)\n"
        "nifti.save(root + '/atlas.nii', make_atlas((12, 12, 12), 3).astype(np.int16))\n"
        "roi_visualize.main(['--atlas', root + '/atlas.nii', '--query-voxel', '6', '6', '6',"
        " '--query-world', '1', '2', '3', '--html', root + '/atlas.html'])\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
    assert "paired t-test:" in res.stdout and "voxel (6, 6, 6) ->" in res.stdout
    for path in ("ckpt/cv_results.csv", "enc/adni_features.csv",
                 "enc/feature_map_shapes.csv", "atlas.html"):
        assert os.path.isfile(tmp_path / path), path


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


def test_unet_entry_points_raise_without_a_card(no_cuda, tmp_path):
    from multimodal_ad_tpu_torch.cli.train_unet3d import main
    from multimodal_ad_tpu_torch.core.config import Config
    from multimodal_ad_tpu_torch.train.autoencoder import (load_autoencoder,
                                                           train_unet_autoencoder)
    from multimodal_ad_tpu_torch.train.single_split import train_unet_classifier

    cfg = Config(label_file=str(tmp_path / "labels.csv"), mri_dir=str(tmp_path),
                 checkpoint_dir=str(tmp_path / "ckpt"))
    with pytest.raises(RuntimeError, match="CUDA"):
        main([f"label_file={cfg.label_file}", f"mri_dir={tmp_path}",
              f"checkpoint_dir={cfg.checkpoint_dir}"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_unet_classifier(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_unet_autoencoder(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_autoencoder(str(tmp_path / "ckpt"), cfg)
    assert not os.path.exists(tmp_path / "ckpt")  # nothing ran on the host


def test_int8_serving_raises_without_a_card(no_cuda, tmp_path):
    """quantize_int8 is reached through a predictor on the card: without
    one the predictor raises before any export or calibration."""
    from multimodal_ad_tpu_torch.core.config import Config
    from multimodal_ad_tpu_torch.models.resnet3d import generate_model
    from multimodal_ad_tpu_torch.serve import EnsemblePredictor
    from multimodal_ad_tpu_torch.train import checkpoint as ckpt

    model = generate_model(model_depth=10)
    vols = np.zeros((2, 8, 8, 8), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        EnsemblePredictor(model, [model.state_dict()], device="cuda").quantize_int8(vols)
    ckpt.save_checkpoint(str(tmp_path / "best_fold1"), model.state_dict(),
                         config=Config(model_depth=10).to_dict())
    with pytest.raises(RuntimeError, match="CUDA"):
        EnsemblePredictor.from_checkpoint_dir(str(tmp_path)).quantize_int8(vols)


def test_image_side_entry_points_raise_without_a_card(no_cuda, tmp_path):
    from multimodal_ad_tpu_torch.cli.train_densenet import main
    from multimodal_ad_tpu_torch.eval.features import extract_encoder_features

    labels = str(tmp_path / "labels.csv")
    with open(labels, "w") as f:
        f.write("Subject_ID,Group\n" + "".join(f"S{i},{'AD' if i % 2 else 'CN'}\n"
                                               for i in range(10)))
    with pytest.raises(RuntimeError, match="CUDA"):
        main([f"label_file={labels}", f"mri_dir={tmp_path}",
              f"checkpoint_dir={tmp_path / 'ckpt'}"])
    with pytest.raises(RuntimeError, match="CUDA"):
        extract_encoder_features([], str(tmp_path / "enc"))
    assert not os.path.exists(tmp_path / "ckpt")
    assert not os.path.exists(tmp_path / "enc")


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


@pytest.mark.cuda
def test_augmentation_on_the_card_equals_the_host(cuda):
    """apply_plans on the card and on the host CPU, for the same plans
    (flips, rotations, zooms and identities over 12 rows): bit-equal (the
    weights are planned on the host; every device operation rounds once,
    in the host's order)."""
    from multimodal_ad_tpu_torch.data.transforms import VolumeTransform, apply_plans

    tf = VolumeTransform(augment=True, seed=7)
    plans = [tf.plan(i, 0) for i in range(12)]
    assert {(p.flip, p.angle is not None, p.zoom is not None) for p in plans} >= {
        (False, False, False), (True, True, True), (False, True, False)}
    x = torch.rand((12, 23, 27, 21, 1), generator=torch.Generator().manual_seed(0))
    host = apply_plans(x, plans)
    card = apply_plans(x.to(cuda), plans)
    torch.cuda.synchronize()
    assert torch.equal(card.cpu(), host)


@pytest.mark.cuda
def test_unet_classifier_steps_on_the_card_match_the_host(cuda):
    """Three fp32 AdamW steps (no clip, the per-update cosine, TF32 off) of
    a base-4 UNet3DClassifier at 24^3, B = 4 with a padded row, the card
    starting each step from the host's state: losses and BN statistics
    within 1e-3, parameters within 2 lr (Adam moves a parameter by about lr
    whatever its gradient's size, so where a gradient is rounding noise,
    as a conv bias before a BatchNorm's is, the two step apart)."""
    from multimodal_ad_tpu_torch.core.device import resolve_device
    from multimodal_ad_tpu_torch.models.unet3d import UNet3DClassifier
    from multimodal_ad_tpu_torch.train import loop

    resolve_device("cuda")

    def state(device):
        m = UNet3DClassifier(base_ch=4, compute_dtype=torch.float32,
                             generator=torch.Generator().manual_seed(0)).to(device)
        return loop.create_train_state(m, loop.cosine_decay_schedule(1e-3, 4), 1e-4,
                                       grad_clip_norm=0.0, optimizer="adamw")

    host, card = state(torch.device("cpu")), state(cuda)
    g = torch.Generator().manual_seed(1)
    for _ in range(3):
        card.model.load_state_dict(host.model.state_dict())
        if host.step:
            card.optimizer.load_state_dict(host.optimizer.state_dict())
        card.step = host.step
        batch = {"image": torch.rand((4, 24, 24, 24, 1), generator=g),
                 "label": torch.tensor([0, 1, 1, 0]), "mask": torch.tensor([1.0, 1, 1, 0])}
        ones = torch.ones(2)
        l_host = float(loop.train_step(host, batch, ones)[0])
        l_card = float(loop.train_step(card, {k: v.to(cuda) for k, v in batch.items()},
                                       ones.to(cuda))[0])
        assert l_card == pytest.approx(l_host, rel=1e-3, abs=1e-3)
        h = host.model.state_dict()
        c = {k: v.cpu() for k, v in card.model.state_dict().items()}
        for k, v in h.items():
            if ".running_" in k:
                torch.testing.assert_close(c[k], v, rtol=1e-3, atol=1e-3, msg=k)
            elif v.is_floating_point():
                assert float((c[k] - v).abs().max()) <= 2e-3, k


def _k3_inputs(shape, c_out, ksize, seed):
    """Full-range int8 activations and (C_out, k, k, k, C_in) weights, and
    epilogue vectors of the magnitudes calibration gives."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (c_out, ksize, ksize, ksize, shape[-1]), generator=g,
                      dtype=torch.int8)
    x[0, :4, :4, :4] = 127  # a saturated corner: channel 0 adds 127**2 per product there
    w[0] = 127
    k = torch.rand(c_out, generator=g) * 1e-5 + 1e-6
    b = torch.randn(c_out, generator=g) * 0.5
    return x, w, k, b


@pytest.mark.cuda
@pytest.mark.parametrize("ksize,stride,dil", [(3, 1, 1), (3, 2, 1), (3, 1, 2), (3, 1, 4),
                                              (1, 1, 1), (1, 2, 1)])
@pytest.mark.parametrize("shape,c_out", [((2, 7, 9, 5, 32), 24), ((1, 12, 14, 12, 64), 136)])
def test_k3_matches_plain(cuda, ksize, stride, dil, shape, c_out):
    """K3 against conv_i8_plain and the plain epilogues on the card:
    bit-equal in all three epilogues (odd grids; a tile's rows and channels
    partly past M and N)."""
    x, w, k, b = _k3_inputs(shape, c_out, ksize, seed=ksize + 10 * stride + 100 * dil)
    x, w, k, b = x.to(cuda), w.to(cuda), k.to(cuda), b.to(cuda)
    acc = tk3.conv_i8_plain(x, w, stride, dil)
    for epilogue in ("int32", "int8", "float32"):
        before = tk3.conv_i8.launches
        out = tk3.conv_i8(x, w, stride, dil, epilogue, k, b, 0.05)
        torch.cuda.synchronize()
        assert tk3.conv_i8.launches == before + 1
        ref = tk3.epilogue_plain(acc, epilogue, k, b, 0.05)
        assert out.dtype == ref.dtype and torch.equal(out, ref), epilogue
    assert int(acc.abs().max()) >= 127 ** 2 * shape[-1]  # the saturated corner's sums


@pytest.mark.cuda
def test_k3_rejects_what_it_does_not_take(cuda):
    x = torch.zeros((1, 4, 4, 4, 32), dtype=torch.int8, device=cuda)
    w = torch.zeros((8, 3, 3, 3, 32), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):  # C_in % 32
        tk3.conv_i8(x[..., :16].contiguous(), w[..., :16].contiguous())
    with pytest.raises(ValueError):  # C_out % 8
        tk3.conv_i8(x, w[:4].contiguous())
    with pytest.raises(TypeError):
        tk3.conv_i8(x.float(), w)
    with pytest.raises(ValueError):  # a strided view
        tk3.conv_i8(torch.zeros((1, 4, 4, 4, 64), dtype=torch.int8, device=cuda)[..., ::2], w)
    with pytest.raises(ValueError):  # weights on the host
        tk3.conv_i8(x, w.cpu())
    before = tk3.conv_i8.launches
    assert tk3.conv_i8(x, w).shape == (1, 4, 4, 4, 8)
    assert tk3.conv_i8.launches == before + 1


def _check_k3_all_epilogues(x, w, k, b, stride, dil):
    """K3 on the card against its plain version in every epilogue, the
    block output with a bf16 and a float32 residual, with and without the
    next quant point: bit-equal, one launch a call."""
    acc = tk3.conv_i8_plain(x, w, stride, dil)
    for epilogue in ("int32", "int8", "float32"):
        out = tk3.conv_i8(x, w, stride, dil, epilogue, k, b, 0.05)
        assert torch.equal(out, tk3.epilogue_plain(acc, epilogue, k, b, 0.05)), epilogue
    g = torch.Generator(device=x.device).manual_seed(acc.numel())
    r = torch.randn(acc.shape, generator=g, device=x.device) * 2
    for res in (r.to(torch.bfloat16), r):
        for s_next in (0.05, None):
            before = tk3.conv_i8.launches
            h, hq = tk3.conv_i8(x, w, stride, dil, "block_out", k, b, s_next, res)
            torch.cuda.synchronize()
            assert tk3.conv_i8.launches == before + 1
            ref_h, ref_q = tk3.epilogue_plain(acc, "block_out", k, b, s_next, res)
            assert h.dtype == torch.bfloat16 and torch.equal(h, ref_h), (res.dtype, s_next)
            assert (hq is None) == (s_next is None)
            if s_next is not None:
                assert hq.dtype == torch.int8 and torch.equal(hq, ref_q), res.dtype
    return acc


@pytest.mark.cuda
@pytest.mark.parametrize("shape,c_out,ksize,stride,dil", [
    ((2, 7, 9, 5, 32), 24, 3, 1, 1), ((1, 12, 14, 12, 64), 136, 3, 1, 4),
    ((2, 7, 9, 5, 64), 136, 1, 2, 1)])
def test_k3_block_out_matches_plain(cuda, shape, c_out, ksize, stride, dil):
    x, w, k, b = (t.to(cuda) for t in _k3_inputs(shape, c_out, ksize, seed=sum(shape)))
    _check_k3_all_epilogues(x, w, k, b, stride, dil)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,c_out,dil", [
    ((2, 2, 3, 2, 64), 64, 4),      # one box: 1 of the 27 taps lands inside
    ((2, 5, 14, 3, 128), 256, 4),   # boxes at the faces lose whole taps
    ((2, 12, 14, 12, 64), 128, 4),  # boxes three d-planes deep
])
def test_k3_tiles_that_lose_taps(cuda, shape, c_out, dil):
    """Grids where whole tiles skip taps (some tile of the plan needs fewer
    than the 27) and where a tile's rows straddle d-planes."""
    plan = tk3.tile_plan(shape, (c_out, 3, 3, 3, shape[-1]), 1, dil)
    fewest = 1
    for n, t in zip(shape[1:4], plan.box):
        live = tk3._live_taps(n, 3, 1, dil)
        fewest *= min(int(live[s:s + t].any(0).sum()) for s in range(0, live.shape[0], t))
    assert fewest < 27
    if shape[1] == 12:
        assert plan.box[0] >= 2
    x, w, k, b = (t.to(cuda) for t in _k3_inputs(shape, c_out, 3, seed=dil + shape[2]))
    _check_k3_all_epilogues(x, w, k, b, 1, dil)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,c_out,ksize,stride", [
    ((2, 6, 7, 6, 32), 40, 3, 1), ((3, 5, 7, 4, 96), 24, 3, 2), ((2, 6, 7, 6, 96), 136, 3, 1),
    ((2, 6, 7, 6, 2048), 24, 1, 1), ((1, 3, 4, 3, 2048), 64, 3, 1),
    ((2, 6, 7, 6, 64), 2048, 1, 1), ((2, 6, 7, 6, 512), 2048, 1, 2)])
def test_k3_channel_counts(cuda, shape, c_out, ksize, stride):
    """C_in 32, 96 and 2048 (chunks of a tap that straddle a stage), C_out
    24, 40, 136 and 2048 (tiles of 64 or 256 channels, partly past N)."""
    x, w, k, b = (t.to(cuda) for t in _k3_inputs(shape, c_out, ksize, seed=c_out + ksize))
    _check_k3_all_epilogues(x, w, k, b, stride, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [34, 50])
def test_int8_fold_on_the_card_matches_the_host(cuda, depth):
    """One depth-34 (BasicBlock) or depth-50 (Bottleneck) int8 fold, the
    same export and scales on the card and the host: from one stem output
    every quant point and the blocks' output bit-equal (K3 with every
    epilogue it runs on the path, the block output's included), one K3
    launch per block conv, and the logits of whole forwards within 1e-2
    of their spread (the bf16 stem accumulates in another order)."""
    from multimodal_ad_tpu_torch.core.device import resolve_device
    from multimodal_ad_tpu_torch.models import resnet3d_int8 as tq8
    from multimodal_ad_tpu_torch.models.resnet3d import generate_model

    resolve_device("cuda")
    model = generate_model(model_depth=depth, generator=torch.Generator().manual_seed(depth))
    qp = tq8.export_int8(model.state_dict(), depth=depth, shortcut_type="B")
    rng = np.random.default_rng(depth)
    cal = torch.from_numpy(rng.normal(0, 1, (2, 20, 24, 20, 1)).astype(np.float32))
    scales = tq8.calibrate_int8(qp, [cal])
    net_h = tq8.ResNet3DInt8(tq8.strip_fp(qp), scales)
    net_c = tq8.ResNet3DInt8(tq8.strip_fp(qp), scales).to(cuda)
    x = torch.from_numpy(rng.normal(0, 1, (2, 20, 24, 20, 1)).astype(np.float32))
    n_convs = sum(len(blk["convs"]) for blk in net_c.blocks)
    with torch.inference_mode():
        h = net_c.stem(x.to(cuda, torch.bfloat16))
        taps_c, taps_h = [], []
        before = tk3.conv_i8.launches
        out_c, _ = net_c.blocks_forward(h, taps=taps_c)
        torch.cuda.synchronize()
        assert tk3.conv_i8.launches - before == n_convs
        out_h, _ = net_h.blocks_forward(h.cpu(), taps=taps_h)
        card, host = net_c(x.to(cuda)).cpu(), net_h(x)
    assert len(taps_c) == len(taps_h) == len(net_c.scale_keys)
    for key, a, b in zip(net_c.scale_keys, taps_c, taps_h):
        assert torch.equal(a.cpu(), b), key
    assert torch.equal(out_c.cpu(), out_h)
    spread = float(host.abs().max())
    assert float((card - host).abs().max()) <= 1e-2 * max(spread, 1e-6)


@pytest.mark.cuda
def test_int8_ensemble_on_the_card_matches_the_host(cuda):
    """Two depth-10 folds quantized on the card and on the host from the
    same weights and calibration volumes: K3 launched once per block conv,
    fold and chunk; the ensembles' probabilities agree within 1e-2 (the
    bf16 stem accumulates in another order in cuDNN); each side's scales
    are its observed maxima / 127 + 1e-12 in float32 with a true division,
    bit for bit, as the TPU package computes them; the blocks fed one stem
    output give bit-equal quant points and outputs."""
    from multimodal_ad_tpu_torch.core.device import resolve_device
    from multimodal_ad_tpu_torch.models import resnet3d_int8 as tq8
    from multimodal_ad_tpu_torch.models.resnet3d import generate_model
    from multimodal_ad_tpu_torch.serve import EnsemblePredictor

    resolve_device("cuda")
    model = generate_model(model_depth=10, generator=torch.Generator().manual_seed(3))
    sds = [model.state_dict()]
    for bn in (m for m in model.modules() if isinstance(m, torch.nn.BatchNorm3d)):
        bn.weight.data.mul_(0.9)
    sds.append(model.state_dict())
    rng = np.random.default_rng(4)
    cal = rng.normal(100, 30, size=(3, 20, 24, 20)).astype(np.float32)
    vols = rng.normal(100, 30, size=(5, 20, 24, 20)).astype(np.float32)
    preds = {dev: EnsemblePredictor(model, sds, batch_size=4, device=dev).quantize_int8(cal)
             for dev in ("cpu", "cuda")}
    before = tk3.conv_i8.launches
    card = preds["cuda"].predict_proba(vols)
    torch.cuda.synchronize()
    n_convs = sum(len(b["convs"]) for b in preds["cuda"].int8_folds[0].blocks)
    assert tk3.conv_i8.launches - before == 2 * 2 * n_convs  # 2 chunks x 2 folds
    host = preds["cpu"].predict_proba(vols)
    np.testing.assert_allclose(card, host, rtol=0, atol=1e-2)
    for dev, pred in preds.items():
        qp = tq8.export_int8(pred.folds[0].state_dict(), depth=10, shortcut_type="B")
        xc = pred._prep(torch.from_numpy(cal).to(dev), True)
        maxes = tq8.observe_maxes(qp, xc).cpu().numpy()
        want = maxes / np.float32(127.0) + np.float32(1e-12)
        got = pred.int8_folds[0].act_scales.cpu().numpy()
        assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want), dev
    net_c, net_h = preds["cuda"].int8_folds[0], preds["cpu"].int8_folds[0]
    net_h.set_scales(net_c.act_scales.cpu())
    x = torch.from_numpy(vols[:2, ..., None] / 200.0)
    with torch.inference_mode():
        h = net_c.stem(x.to(cuda))
        taps_c, taps_h = [], []
        out_c, _ = net_c.blocks_forward(h, taps=taps_c)
        out_h, _ = net_h.blocks_forward(h.cpu(), taps=taps_h)
    for a, b in zip(taps_c, taps_h):
        assert torch.equal(a.cpu(), b)
    assert torch.equal(out_c.cpu(), out_h)


def _densenet_three_steps(device):
    """Three fp32 train steps of a seeded narrow DenseNet-3D at 24x28x24,
    B = 4 (one padded row), dropout 0; returns the losses and the
    state_dict."""
    from multimodal_ad_tpu_torch.models.densenet import DilatedDenseNet
    from multimodal_ad_tpu_torch.train import loop

    model = DilatedDenseNet(growth=8, block_config=(2, 3, 2), dilations=(1, 2, 4),
                            init_features=16, dropout_rate=0.0,
                            compute_dtype=torch.float32,
                            generator=torch.Generator().manual_seed(0)).to(device)
    state = loop.create_train_state(model, loop.make_epoch_schedule(1e-3, 20))
    g = torch.Generator().manual_seed(1)
    cw = torch.tensor([0.3, 0.7], device=device)
    losses = []
    for _ in range(3):
        batch = {"image": (torch.randn((4, 24, 28, 24, 1), generator=g) * 2 + 1).to(device),
                 "label": torch.tensor([0, 1, 1, 0], device=device),
                 "mask": torch.tensor([1.0, 1.0, 1.0, 0.0], device=device)}
        loss, _ = loop.train_step(state, batch, cw)
        losses.append(float(loss))
    return losses, {k: v.cpu() for k, v in model.state_dict().items()}


@pytest.mark.cuda
def test_densenet_train_steps_on_the_card_match_the_host(cuda):
    """As the ResNet's: fp32, TF32 off; losses and BN statistics within
    1e-3, parameters within 6 lr and 99.9 % of them within 1e-3."""
    from multimodal_ad_tpu_torch.core.device import resolve_device

    resolve_device("cuda")
    card_losses, card = _densenet_three_steps(cuda)
    host_losses, host = _densenet_three_steps(torch.device("cpu"))
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
@pytest.mark.parametrize("head", ["none", "pool"])
def test_encoder_features_on_the_card_match_the_host(cuda, tmp_path, head):
    """extract_encoder_features of a seeded ResNet-10 on the card (K1
    launched once a batch) against the host: equal headers, subjects,
    labels and shape files, values within rtol = atol = 1e-3."""
    import csv

    from multimodal_ad_tpu_torch.data.adni import ADNIManifest
    from multimodal_ad_tpu_torch.data.synthetic import make_adni_dir
    from multimodal_ad_tpu_torch.eval.features import extract_encoder_features

    csv_path, mri = make_adni_dir(str(tmp_path), n_per_class=3, shape=(20, 24, 20))
    recs = ADNIManifest(csv_path, mri, verbose=False).data_dict
    out = {}
    before = tfg.gather_normalize.launches
    for dev in ("cuda", "cpu"):
        f, s = extract_encoder_features(recs, str(tmp_path / dev), depth=10,
                                        global_pool=head == "pool", batch_size=4,
                                        num_threads=2, device=dev)
        with open(f) as fh, open(s) as sh:
            out[dev] = (list(csv.reader(fh)), sh.read())
        if dev == "cuda":
            assert tfg.gather_normalize.launches - before == 2  # batches 4 + 2
    (card, card_s), (host, host_s) = out["cuda"], out["cpu"]
    assert card_s == host_s
    assert card[0] == host[0] and [r[0] for r in card] == [r[0] for r in host]
    assert [r[-1] for r in card] == [r[-1] for r in host]
    np.testing.assert_allclose(np.asarray([r[1:-1] for r in card[1:]], float),
                               np.asarray([r[1:-1] for r in host[1:]], float),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_seg_head_on_the_card_matches_the_host(cuda, dtype):
    """A ResNet-18 with head 'seg' (3 classes) at 40x48x40, B = 2: float32
    within rtol = atol = 1e-3 and the same taps; bf16 within 3e-2 of the
    output's largest magnitude (cuDNN and the host round bf16 at other
    points)."""
    from multimodal_ad_tpu_torch.core.device import resolve_device
    from multimodal_ad_tpu_torch.models.resnet3d import ResNet3D

    resolve_device("cuda")
    model = ResNet3D(depth=18, head="seg", num_seg_classes=3, compute_dtype=dtype,
                     generator=torch.Generator().manual_seed(2)).eval()
    x = torch.randn((2, 40, 48, 40, 1), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        host, host_taps = model(x, return_taps=True)
        card, card_taps = model.to(cuda)(x.to(cuda), return_taps=True)
    assert card.shape == host.shape == (2, 10, 12, 10, 3) and card.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(card.cpu(), host, rtol=1e-3, atol=1e-3)
        for a, b in zip(card_taps, host_taps):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-3)
    else:
        scale = float(host.float().abs().max())
        assert float((card.cpu().float() - host.float()).abs().max()) <= 3e-2 * scale


@pytest.mark.cuda
def test_mshyper_on_the_card_matches_the_host(cuda):
    """MSHyper at the JAX defaults (d_model 64, windows (4, 4), inner 3,
    attention) on (32, 96, 7) -> (32, 24, 7): forward and the gradients of
    one backward, card against host, fp32 (TF32 off): the output within
    1e-4 of its largest magnitude, the gradients within 1e-4 of the largest
    gradient (the attention key's bias has a gradient that is 0 in exact
    arithmetic, ~1e-10 in float32, so it is no scale of its own)."""
    from multimodal_ad_tpu_torch.core.device import resolve_device
    from multimodal_ad_tpu_torch.models.hypergraph import MSHyperModel

    resolve_device("cuda")
    torch.manual_seed(0)
    host = MSHyperModel(96, 24, 7)
    card = MSHyperModel(96, 24, 7).to(cuda)
    card.load_state_dict(host.state_dict())
    g = torch.Generator().manual_seed(1)
    x = torch.cumsum(torch.randn((32, 120, 7), generator=g), dim=1)
    inp, target = x[:, :96], x[:, 96:]
    grads = {}
    for name, m, dev in (("host", host, "cpu"), ("card", card, cuda)):
        y = m(inp.to(dev))
        ((y - target.to(dev)) ** 2).mean().backward()
        grads[name] = (y.detach().cpu(), [p.grad.cpu() for p in m.parameters()])
    (c_out, c_grads), (h_out, h_grads) = grads["card"], grads["host"]
    assert float((c_out - h_out).abs().max()) <= 1e-4 * float(h_out.abs().max())
    scale = max(float(g.abs().max()) for g in h_grads)
    for a, b in zip(c_grads, h_grads):
        assert float((a - b).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_native_decoder_on_the_cards_machine(cuda, tmp_path):
    """On the card's machine the native decoder builds, and its volumes,
    per file and in batches, are bit-equal to the Python reader's."""
    from multimodal_ad_tpu_torch.data.pipeline import read_volume
    from multimodal_ad_tpu_torch.data.synthetic import make_adni_dir
    from multimodal_ad_tpu_torch.utils import native_loader, nifti

    assert native_loader.available(), native_loader.build_error()
    _, mri = make_adni_dir(str(tmp_path), n_per_class=2, shape=(91, 109, 91))
    paths = sorted(os.path.join(mri, f) for f in os.listdir(mri))
    batch = native_loader.NativeBatchDecoder((91, 109, 91), n_threads=4).decode(paths)
    for p, b in zip(paths, batch):
        vol, reader = read_volume(p)
        ref = nifti.load(p)
        assert reader == "native"
        assert np.array_equal(vol.view(np.uint32), ref.view(np.uint32))
        assert np.array_equal(b.view(np.uint32), ref.view(np.uint32))


TABULAR_BLOCKED = ("jax", "jaxlib", "flax", "optax", "msgpack", "multimodal_ad_tpu",
                   "sklearn", "pandas")


def test_tabular_modules_import_with_jax_flax_msgpack_sklearn_and_pandas_blocked():
    mods = [m for m in _port_modules()
            if ".tabular" in m or m.endswith(("data.tabular", "cli.tabular_embed"))]
    assert len(mods) >= 9, mods
    code = (
        "import sys\n"
        f"for name in {TABULAR_BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_tabular_path_runs_without_jax_flax_msgpack_sklearn_or_pandas(tmp_path):
    """ICLClassifier fit/predict, ICLRegressor and tabel_encoder_multi with
    the ensemble embedder run on the CPU with the card machine's absences;
    cli.tabular_embed writes its CSVs, then raises ImportError naming the
    host-only quick eval."""
    code = (
        "import sys\n"
        f"for name in {TABULAR_BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import os\n"
        "import numpy as np\n"
        "import torch\n"
        "torch.set_num_threads(2)  # the suite runs several workers at once\n"
        "from multimodal_ad_tpu_torch.cli import tabular_embed\n"
        "from multimodal_ad_tpu_torch.data.synthetic import make_table\n"
        "from multimodal_ad_tpu_torch.tabular import ICLClassifier, ICLRegressor\n"
        "from multimodal_ad_tpu_torch.tabular.pipeline import tabel_encoder_multi\n"
        f"root = {str(tmp_path)!r}\n"
        "rng = np.random.default_rng(0)\n"
        "X = rng.normal(size=(50, 6)).astype(np.float32)\n"
        "y = (X[:, 0] > 0).astype(int)\n"
        "clf = ICLClassifier(preprocess='quantile', n_estimators=2, device='cpu').fit(X, y)\n"
        "assert clf.predict_proba(X[:5]).shape == (5, 2)\n"
        "reg = ICLRegressor(preprocess='pairs', n_estimators=2, device='cpu')\n"
        "assert reg.fit(X, X[:, 1]).predict(X[:5]).shape == (5,)\n"
        "table = make_table(n=40, classes=('CN', 'SMCI', 'PMCI', 'AD'), seed=1,"
        " path=root + '/t.csv')\n"
        "tabel_encoder_multi(table, label_col='Group', classes=['CN', 'SMCI', 'PMCI', 'AD'],"
        " n_fold=2, train_out=root + '/tr.csv', test_out=root + '/te.csv', device='cpu')\n"
        "try:\n"
        "    tabular_embed.main(['--table', table, '--label-col', 'Group', '--n-fold', '2',"
        " '--train-out', root + '/c_tr.csv', '--test-out', root + '/c_te.csv',"
        " '--device', 'cpu'])\n"
        "except ImportError as e:\n"
        "    assert 'quick eval' in str(e) and os.path.isfile(root + '/c_te.csv'), e\n"
        "    print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
    with open(tmp_path / "tr.csv") as f:
        assert len(f.readline().split(",")) == 1 + 6 * 296


def test_tabular_entry_points_raise_without_a_card(no_cuda, tmp_path):
    from multimodal_ad_tpu_torch.cli.tabular_embed import main
    from multimodal_ad_tpu_torch.data.synthetic import make_table
    from multimodal_ad_tpu_torch.tabular import (EnsembleICLEmbedder, ICLClassifier,
                                                 ICLRegressor)
    from multimodal_ad_tpu_torch.tabular.pipeline import tabel_encoder_multi

    X = np.random.default_rng(0).normal(size=(30, 4)).astype(np.float32)
    y = np.arange(30) % 2
    with pytest.raises(RuntimeError, match="CUDA"):
        ICLClassifier().fit(X, y)
    with pytest.raises(RuntimeError, match="CUDA"):
        ICLRegressor().fit(X, X[:, 0])
    with pytest.raises(RuntimeError, match="CUDA"):
        EnsembleICLEmbedder().fit(X, y)
    table = make_table(n=40, seed=0, path=str(tmp_path / "t.csv"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tabel_encoder_multi(table, label_col="Group", n_fold=2,
                            train_out=str(tmp_path / "tr.csv"),
                            test_out=str(tmp_path / "te.csv"))
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--table", table, "--label-col", "Group", "--train-out",
              str(tmp_path / "c_tr.csv"), "--test-out", str(tmp_path / "c_te.csv")])
    assert not os.path.exists(tmp_path / "tr.csv")
    assert not os.path.exists(tmp_path / "c_tr.csv")  # nothing ran on the host


@pytest.mark.cuda
def test_icl_forward_on_the_card_matches_the_host(cuda):
    """The full-width classifier asset's forward (4 views, a 512-row bucket
    with 464 valid rows, 100 queries, the categorical mask): every output
    within 1e-4 of its spread."""
    from multimodal_ad_tpu_torch.core.device import resolve_device
    from multimodal_ad_tpu_torch.tabular.flax_msgpack import read_state
    from multimodal_ad_tpu_torch.tabular.icl import (ICLConfig, ICLTransformer,
                                                     _zscore_by_ctx, default_asset_path)
    from multimodal_ad_tpu_torch.utils.torch_weights import icl_state_dict_from_flax

    resolve_device("cuda")
    cfg = ICLConfig()
    sd = icl_state_dict_from_flax(read_state(default_asset_path()), cfg)
    rng = np.random.default_rng(0)
    x_ctx = rng.normal(size=(4, 512, 192)).astype(np.float32)
    x_ctx[:, 464:] = 0
    mask = np.zeros((4, 512), np.float32)
    mask[:, :464] = 1
    inputs = [torch.from_numpy(a) for a in (
        x_ctx, rng.integers(0, 4, (4, 512)), mask,
        rng.normal(size=(4, 100, 192)).astype(np.float32),
        (rng.random((4, 192)) < 0.05).astype(np.float32))]
    outs = {}
    for dev in ("cpu", cuda):
        net = ICLTransformer(cfg).eval()
        net.load_state_dict(sd)
        net = net.to(dev)
        xc, yc, m, xq, cat = (t.to(dev) for t in inputs)
        with torch.inference_mode():
            xc, xq = _zscore_by_ctx(xc, xq, m)
            outs[str(dev)] = [t.cpu() for t in net(xc, yc, m, xq, cat, return_penult=True)]
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.cuda
def test_icl_classifier_fit_on_the_card_matches_the_host(cuda):
    """ICLClassifier() with every default (the auto preprocess search) and
    ICLRegressor(): the same choices on the card and the host, probabilities
    within 1e-4 and predictions within 1e-4 of the target's spread."""
    from multimodal_ad_tpu_torch.tabular import ICLClassifier, ICLRegressor

    rng = np.random.default_rng(1)
    X = rng.normal(size=(150, 20)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(int) + (X[:, 3] > 1)
    X[:, 4] = rng.integers(0, 3, 150)
    X[rng.random(X.shape) < 0.05] = np.nan
    card = ICLClassifier().fit(X[:120], y[:120])
    host = ICLClassifier(device="cpu").fit(X[:120], y[:120])
    assert card.preprocess_ == host.preprocess_
    p, q = card.predict_proba(X[120:]), host.predict_proba(X[120:])
    assert float(np.abs(p - q).max()) <= 1e-4
    target = np.nan_to_num(X[:, 0]).astype(np.float64) * 3 + np.nan_to_num(X[:, 5])
    reg = ICLRegressor().fit(X[:120], target[:120])
    href = ICLRegressor(device="cpu").fit(X[:120], target[:120])
    assert reg.preprocess_ == href.preprocess_
    spread = float(target.max() - target.min())
    for kind in ("mean", "median"):
        d = np.abs(reg.predict(X[120:], kind) - href.predict(X[120:], kind)).max()
        assert float(d) <= 1e-4 * spread
