"""Minimal pure-NumPy NIfTI-1 reader/writer (own copy of the TPU package's
utils/nifti.py; the port imports nothing of that package).

All the serving path needs from the format is the header geometry, the
raw data block, and scl_slope/scl_inter scaling, for single-file ``.nii``
and ``.nii.gz`` images.

Returned arrays are indexed ``[x, y, z]`` (Fortran data order re-expressed
as a normal C-contiguous ndarray), matching ``nibabel.load(...).get_fdata()``,
so an MNI 2 mm volume comes back as shape (91, 109, 91).
"""

from __future__ import annotations

import gzip
import os
import struct
from dataclasses import dataclass, field

import numpy as np

# NIfTI-1 datatype codes -> numpy dtypes (the subset that occurs in practice)
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

HDR_SIZE = 348


@dataclass
class NiftiHeader:
    shape: tuple
    dtype: np.dtype
    scl_slope: float = 1.0
    scl_inter: float = 0.0
    pixdim: tuple = (1.0, 1.0, 1.0)
    vox_offset: int = 352
    byteorder: str = "<"
    affine: np.ndarray = field(default_factory=lambda: np.eye(4))


def _open(path):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_header(path) -> NiftiHeader:
    with _open(path) as f:
        raw = f.read(HDR_SIZE)
    if len(raw) < HDR_SIZE:
        raise ValueError(f"{path}: truncated NIfTI header ({len(raw)} bytes)")

    # sizeof_hdr tells us the byte order
    (sizeof_hdr,) = struct.unpack("<i", raw[:4])
    bo = "<"
    if sizeof_hdr != 348:
        (sizeof_hdr,) = struct.unpack(">i", raw[:4])
        if sizeof_hdr != 348:
            raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")
        bo = ">"

    magic = raw[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    dim = struct.unpack(bo + "8h", raw[40:56])
    ndim = dim[0]
    if not 1 <= ndim <= 7:
        raise ValueError(f"{path}: bad ndim {ndim}")
    shape = tuple(int(d) for d in dim[1 : 1 + ndim])

    (datatype,) = struct.unpack(bo + "h", raw[70:72])
    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype code {datatype}")
    dtype = np.dtype(_DTYPES[datatype]).newbyteorder(bo)

    pixdim = struct.unpack(bo + "8f", raw[76:108])
    (vox_offset,) = struct.unpack(bo + "f", raw[108:112])
    scl_slope, scl_inter = struct.unpack(bo + "2f", raw[112:120])

    # affine from srow if sform_code > 0, else diag(pixdim)
    (sform_code,) = struct.unpack(bo + "h", raw[254:256])
    affine = np.eye(4)
    if sform_code > 0:
        srow = np.array(struct.unpack(bo + "12f", raw[280:328])).reshape(3, 4)
        affine[:3, :] = srow
    else:
        affine[0, 0], affine[1, 1], affine[2, 2] = pixdim[1], pixdim[2], pixdim[3]

    return NiftiHeader(
        shape=shape,
        dtype=dtype,
        scl_slope=float(scl_slope),
        scl_inter=float(scl_inter),
        pixdim=tuple(float(p) for p in pixdim[1:4]),
        vox_offset=int(vox_offset),
        byteorder=bo,
        affine=affine,
    )


def load(path, dtype=np.float32) -> np.ndarray:
    """Load a NIfTI volume as a C-contiguous array indexed [x, y, z, ...]."""
    hdr = read_header(path)
    n = int(np.prod(hdr.shape))
    with _open(path) as f:
        f.seek(hdr.vox_offset)
        buf = f.read(n * hdr.dtype.itemsize)
    if len(buf) < n * hdr.dtype.itemsize:
        raise ValueError(f"{path}: truncated data block")
    arr = np.frombuffer(buf, dtype=hdr.dtype, count=n)
    # NIfTI stores Fortran order: fastest-varying index first.
    arr = arr.reshape(hdr.shape[::-1]).transpose(range(len(hdr.shape))[::-1])
    out = np.ascontiguousarray(arr, dtype=dtype)
    slope = hdr.scl_slope if hdr.scl_slope not in (0.0,) and not np.isnan(hdr.scl_slope) else 1.0
    inter = hdr.scl_inter if not np.isnan(hdr.scl_inter) else 0.0
    if slope != 1.0 or inter != 0.0:
        out = out * dtype(slope) + dtype(inter)
    return out


def save(path, data: np.ndarray, pixdim=(2.0, 2.0, 2.0)):
    """Write a minimal single-file NIfTI-1 (.nii or .nii.gz)."""
    data = np.asarray(data)
    if data.dtype not in _DTYPE_CODES:
        data = data.astype(np.float32)
    code = _DTYPE_CODES[np.dtype(data.dtype)]
    ndim = data.ndim
    dim = [ndim] + list(data.shape) + [1] * (7 - ndim)
    pd = [1.0] + list(pixdim) + [1.0] * (7 - len(pixdim))

    hdr = bytearray(352)  # 348-byte header + 4-byte extension flag
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)  # bitpix
    struct.pack_into("<8f", hdr, 76, *pd)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl_slope, scl_inter
    struct.pack_into("<h", hdr, 254, 1)  # sform_code
    srow = np.zeros((3, 4), np.float32)
    srow[0, 0], srow[1, 1], srow[2, 2] = pd[1], pd[2], pd[3]
    struct.pack_into("<12f", hdr, 280, *srow.ravel().tolist())
    hdr[344:348] = b"n+1\x00"

    # Fortran-order data block
    blob = np.asfortranarray(data).tobytes(order="F")
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(blob)


def exists_with_ext(base_path: str) -> str | None:
    """Return base_path, base_path+'.gz', or None — first that exists."""
    for p in (base_path, base_path + ".gz"):
        if os.path.isfile(p):
            return p
    return None
