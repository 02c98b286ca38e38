"""Guards of the port: it imports without JAX or the JAX package, names
neither, never falls back to the CPU when CUDA is asked for, and its CUDA
kernel agrees with its plain version on a card (those tests carry the
`cuda` marker and skip where there is none)."""

import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import multimodal_ad_tpu_torch
from multimodal_ad_tpu_torch.ops import fused_gather as tfg

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


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_a_card(no_cuda, tmp_path):
    from multimodal_ad_tpu_torch.cli.predict import main
    from multimodal_ad_tpu_torch.core.device import resolve_device
    from multimodal_ad_tpu_torch.data.device_cache import (
        DeviceDataset, build_device_dataset)
    from multimodal_ad_tpu_torch.models.resnet3d import generate_model
    from multimodal_ad_tpu_torch.serve import EnsemblePredictor

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
