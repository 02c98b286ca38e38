"""Guards of the port: it imports without JAX or the JAX package, names
neither, never falls back to the CPU when CUDA is asked for, and its CUDA
kernels K1 and K2 agree with their plain versions on a card (those tests
carry the `cuda` marker and skip where there is none). This file imports
no JAX, so it also runs on the card's machine."""

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
