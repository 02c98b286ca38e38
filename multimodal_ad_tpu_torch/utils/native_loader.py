"""ctypes bindings for the native NIfTI decoder (port of the TPU package's
utils/native_loader.py).

Builds `native/nifti_reader.cpp` with g++ at first use into the gitignored
`build/` directory beside this package's `native/`, as a library whose
name carries a hash of the source and the flags (an edited source or flag
set is rebuilt, an unchanged one loaded as it is), written under a
temporary name and moved into place with `os.replace`, so processes that
build at once never load a partial file. The TPU package's prebuilt
library is never loaded. Exposes:

- `load_volume_native(path, normalize=False)`: one volume;
- `NativeBatchDecoder(shape, ...)`: a batch of same-shaped volumes decoded
  on a pthread pool into one float32 buffer;
- `make_native_loader(normalize=False)`: a `loader` for `VolumeBatcher`;
- `available()` / `build_error()`.

A failed build is remembered for the process and warned about once;
`data.pipeline.load_volume` then decodes with the Python reader. ctypes
releases the interpreter lock for the length of each call, so the
`VolumeBatcher` thread pool decodes volumes in parallel. Volumes come back
bit-equal to `utils/nifti.py`'s reader.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SRC = _PKG / "native" / "nifti_reader.cpp"
BUILD_DIR = _PKG / "build"
# no -march=native: the library must not fuse the reader's multiply and
# add (FMA), and -ffp-contract=off says so explicitly
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")
LIBS = ("-lz", "-lpthread")
# mad_read_nifti's codes for encodings the decoder does not cover (ndim !=
# 3, an unknown datatype); every other failure is a broken file
UNSUPPORTED_CODES = (-3, -6)

_lock = threading.Lock()
_lib = None
_build_error: str | None = None


class UnsupportedEncoding(ValueError):
    """The file is valid NIfTI in an encoding the native decoder does not
    cover; the Python reader may read it."""


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS + LIBS).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"libmad_nifti-{digest}.so"


def _build(lib: Path) -> str | None:
    """Compile the library if it is missing; returns an error or None."""
    if lib.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"compiler unavailable: {e}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"build failed: {proc.stderr[-500:]}"
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    return None


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        lib_path = library_path()
        _build_error = _build(lib_path)
        if _build_error is not None:
            warnings.warn(f"native NIfTI decoder unavailable ({_build_error}); "
                          "decoding with the Python reader", RuntimeWarning, stacklevel=3)
            return None
        lib = ctypes.CDLL(str(lib_path))
        lib.mad_read_nifti.restype = ctypes.c_int
        lib.mad_read_nifti.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
        lib.mad_read_batch.restype = ctypes.c_int
        lib.mad_read_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    _load()
    return _build_error


def _f32_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def load_volume_native(path: str, normalize: bool = False) -> np.ndarray:
    """Decode one volume as float32 [x, y, z] (C order; the decoder
    transposes the file's Fortran order). The buffer is sized from the
    header, which `utils/nifti.py` reads (it raises on a file that is not
    NIfTI-1). Raises `UnsupportedEncoding` for a file the decoder does not
    cover, ValueError for a broken one."""
    from . import nifti

    lib = _load()
    if lib is None:
        raise RuntimeError(f"native decoder unavailable: {_build_error}")
    n = int(np.prod(nifti.read_header(path).shape))
    out = np.empty(n, np.float32)
    shape = np.zeros(3, np.int32)
    rc = lib.mad_read_nifti(
        os.fsencode(path), _f32_ptr(out), n,
        shape.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), 1 if normalize else 0)
    if rc in UNSUPPORTED_CODES:
        raise UnsupportedEncoding(f"native NIfTI decode does not cover ({rc}): {path}")
    if rc != 0:
        raise ValueError(f"native NIfTI decode failed ({rc}): {path}")
    return out.reshape(tuple(int(s) for s in shape))


class NativeBatchDecoder:
    """Parallel decode of same-shaped volumes into one packed buffer."""

    def __init__(self, shape: tuple, normalize: bool = False, n_threads: int = 0):
        self.shape = tuple(int(s) for s in shape)
        self.vol_elems = int(np.prod(self.shape))
        self.normalize = normalize
        self.n_threads = n_threads or (os.cpu_count() or 1)
        if _load() is None:
            raise RuntimeError(f"native decoder unavailable: {_build_error}")

    def decode(self, paths: list[str]) -> np.ndarray:
        """(n, X, Y, Z) float32 of `paths` (C order); raises ValueError
        naming every file that failed, or on a shape other than `shape`."""
        lib = _load()
        n = len(paths)
        out = np.empty((n, *self.shape), np.float32)
        shapes = np.zeros((n, 3), np.int32)
        status = np.zeros(n, np.int32)
        c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
        failures = lib.mad_read_batch(
            c_paths, n, _f32_ptr(out), self.vol_elems,
            shapes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            1 if self.normalize else 0, self.n_threads)
        if failures:
            bad = [(paths[i], int(status[i])) for i in range(n) if status[i]]
            raise ValueError(f"native batch decode failures: {bad}")
        if not (shapes == np.asarray(self.shape, np.int32)).all():
            raise ValueError(
                f"volume shape mismatch: expected {self.shape}, got "
                f"{[tuple(s) for s in shapes if tuple(s) != self.shape][:3]}")
        return out


def make_native_loader(normalize: bool = False):
    """A `loader` for VolumeBatcher / build_device_dataset that always
    decodes natively (accepts the path with or without '.gz')."""
    from . import nifti

    def load(path: str) -> np.ndarray:
        return load_volume_native(nifti.exists_with_ext(path) or path, normalize=normalize)

    return load
