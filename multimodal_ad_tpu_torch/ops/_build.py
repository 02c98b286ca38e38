"""Build and load the port's CUDA kernels.

Each source `csrc/<name>.cu` exposes a plain C interface and is compiled by
nvcc for Hopper into its own shared library, which is loaded with ctypes
(no PyTorch headers, so a build takes seconds, not minutes). Libraries are
cached under `build/` beside this package's `csrc/`, keyed by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one
is loaded as it is. Nothing is built when a module is imported: the first
launch, or an explicit `build(...)`, does it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                           "the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    """Path of the shared library for `csrc/<name>.cu` (content-hashed)."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) of the
    last build of `name`, or '' if it was not built here."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def build(names) -> None:
    """Compile every named source that has no library yet. All nvcc
    processes start together and are waited for; raises with the
    compiler's output if any fails."""
    todo = [name for name in names if not library_path(name).is_file()]
    if not todo:
        return
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in todo:
        lib = library_path(name)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        log = lib.with_suffix(".log")
        with open(log, "w") as f:
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=f, stderr=subprocess.STDOUT)
        jobs.append((name, lib, tmp, log, proc))
    failed = []
    for name, lib, tmp, log, proc in jobs:
        if proc.wait() != 0:
            failed.append(f"--- {name} ---\n{log.read_text()}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """Build `csrc/<name>.cu` if needed and return the loaded library."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
