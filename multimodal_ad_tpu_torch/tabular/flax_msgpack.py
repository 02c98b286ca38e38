"""A reader of flax's msgpack state files, in pure Python.

The bundled in-context-learning weights (`assets/*.msgpack`) are flax
state dicts serialized with `flax.serialization.to_bytes`: msgpack maps
with string keys whose leaves are arrays. flax packs each array as the
msgpack extension type 1, whose payload is itself msgpack: the tuple
``(shape, dtype name, raw C-order bytes)``. Extension type 3 holds a numpy
scalar in the same form, type 2 a Python complex as ``(real, imag)``.

The card's machine has neither flax nor the ``msgpack`` package, so this
module decodes the msgpack subset those files use and returns nested dicts
of numpy arrays in their stored dtype. It raises on anything it does not
know (an unused type byte, another extension type, a chunked array leaf,
a dtype numpy has no name for) rather than guess.

`to_bytes` / `write_state` are the inverse: for a tree of dicts (string
keys, in their iteration order) with numpy array leaves they write the
bytes ``flax.serialization.to_bytes`` writes, choosing msgpack's smallest
encoding of every length and integer as the ``msgpack`` package does.
Arrays over 2**30 bytes (which flax would chunk) are refused.
"""

from __future__ import annotations

import struct

import numpy as np

#: flax's marker of an array leaf split into chunks (arrays over 2**30
#: bytes); none of the bundled assets has one
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw  # strings as bytes (flax reads array payloads so)

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"msgpack data ends at byte {len(self.buf)}, "
                             f"{n} more wanted at {self.pos}")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def string(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}  # bin 8/16/32
        if b in sized:
            return bytes(self.take(self.unpack(sized[b])))
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}  # ext 8/16/32
        if b in ext:
            n = self.unpack(ext[b])
            return self.ext(self.unpack(">b"), n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(self.unpack(">b"), fixext[b])
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return self.string(self.unpack(strs[b]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack type byte 0x{b:02x} at {self.pos - 1} is not "
                         "one this reader knows")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            if isinstance(k, list):
                raise ValueError("msgpack map key is an array")
            out[k] = self.value()
        if _CHUNKED in out:
            raise ValueError("chunked array leaves (arrays over 2**30 bytes) are "
                             "not supported by this reader")
        return out

    def ext(self, code: int, n: int):
        payload = bytes(self.take(n))
        if code in (1, 3):  # ndarray, numpy scalar
            arr = _ndarray(payload)
            return arr if code == 1 else arr[()]
        if code == 2:  # native complex
            re, im = _Reader(payload).value()
            return complex(re, im)
        raise ValueError(f"msgpack extension type {code} is not one flax writes")


def _ndarray(payload: bytes) -> np.ndarray:
    r = _Reader(payload, raw=True)
    fields = r.value()
    if not (isinstance(fields, list) and len(fields) == 3):
        raise ValueError("an array payload is not (shape, dtype, bytes)")
    shape, dtype_name, buffer = fields
    name = dtype_name.decode("ascii") if isinstance(dtype_name, bytes) else dtype_name
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise ValueError(f"array dtype {name!r} has no numpy counterpart") from e
    if dtype.hasobject or dtype.type.__module__ != "numpy":
        # e.g. bfloat16, which numpy names only where a plug-in registered it
        raise ValueError(f"array dtype {name!r} is not one of numpy's own")
    if not isinstance(buffer, bytes) or len(buffer) != dtype.itemsize * int(np.prod(shape)):
        raise ValueError(f"array of shape {tuple(shape)} and dtype {name} does not "
                         "match its byte count")
    return np.frombuffer(buffer, dtype=dtype).reshape(tuple(shape)).copy()


def unpackb(data: bytes):
    """Decode one msgpack object (with flax's array extensions)."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes left after the msgpack object")
    return out


def read_state(path: str):
    """flax's ``msgpack_restore`` of the file at `path`: nested dicts of
    numpy arrays in their stored dtype."""
    with open(path, "rb") as f:
        return unpackb(f.read())


def tree_leaves(tree, prefix=()):
    """[(path tuple, leaf)] of a nested dict, in key order."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out.extend(tree_leaves(v, prefix + (k,)))
        return out
    return [(prefix, tree)]


# ----------------------------------------------------------------------
# writing
# ----------------------------------------------------------------------

def _pack_uint(out: bytearray, n: int, small_max: int, small_tag: int, tags: tuple):
    """A length or count: `small_tag | n` up to `small_max`, else the first
    of `tags` (8/16/32-bit, big-endian) that holds it."""
    if n <= small_max:
        out.append(small_tag | n)
        return
    for tag, fmt in tags:
        if n < 1 << (8 * struct.calcsize(fmt)):
            out.append(tag)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack length {n} too large")


def _pack_int(out: bytearray, v: int):
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
    elif v >= 0:
        for tag, fmt in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")):
            if v < 1 << (8 * struct.calcsize(fmt)):
                out.append(tag)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"integer {v} too large for msgpack")
    else:
        for tag, fmt in ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q")):
            if v >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                out.append(tag)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"integer {v} too small for msgpack")


def _pack_bytes(out: bytearray, b: bytes):
    n = len(b)
    for tag, fmt in ((0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I")):
        if n < 1 << (8 * struct.calcsize(fmt)):
            out.append(tag)
            out += struct.pack(fmt, n)
            out += b
            return
    raise ValueError("bytes too long for msgpack")


def _pack_ext(out: bytearray, code: int, payload: bytes):
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        for tag, fmt in ((0xC7, ">B"), (0xC8, ">H"), (0xC9, ">I")):
            if n < 1 << (8 * struct.calcsize(fmt)):
                out.append(tag)
                out += struct.pack(fmt, n)
                break
        else:
            raise ValueError("extension payload too long for msgpack")
    out += struct.pack(">b", code)
    out += payload


def _array_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serializable")
    if arr.nbytes > 1 << 30:
        raise ValueError("arrays over 2**30 bytes (flax chunks them) are not supported")
    return packb((arr.shape, arr.dtype.name, arr.tobytes("C")))


def _pack(out: bytearray, v):
    if v is None:
        out.append(0xC0)
    elif v is True or v is False:
        out.append(0xC3 if v else 0xC2)
    elif isinstance(v, np.ndarray):
        _pack_ext(out, 1, _array_payload(v))
    elif isinstance(v, np.generic):
        _pack_ext(out, 3, _array_payload(np.asarray(v)))
    elif isinstance(v, int):
        _pack_int(out, v)
    elif isinstance(v, float):
        out.append(0xCB)
        out += struct.pack(">d", v)
    elif isinstance(v, str):
        b = v.encode("utf-8")
        _pack_uint(out, len(b), 31, 0xA0, ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I")))
        out += b
    elif isinstance(v, (bytes, bytearray)):
        _pack_bytes(out, bytes(v))
    elif isinstance(v, (list, tuple)):
        _pack_uint(out, len(v), 15, 0x90, ((0xDC, ">H"), (0xDD, ">I")))
        for item in v:
            _pack(out, item)
    elif isinstance(v, dict):
        _pack_uint(out, len(v), 15, 0x80, ((0xDE, ">H"), (0xDF, ">I")))
        for k, item in v.items():
            _pack(out, k)
            _pack(out, item)
    else:
        raise TypeError(f"cannot serialize {type(v).__name__}")


def packb(obj) -> bytes:
    """msgpack encoding of `obj` (dicts, lists, tuples, str, bytes, int,
    float, bool, None; numpy arrays and scalars as flax's extension types 1
    and 3)."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


def to_bytes(tree) -> bytes:
    """``flax.serialization.to_bytes`` of a nested dict of numpy arrays:
    keys become strings, in the dict's order."""
    def state(t):
        if isinstance(t, dict):
            keys = [str(k) for k in t]
            if len(set(keys)) != len(keys):
                raise ValueError("dict keys have no unique string form")
            return {str(k): state(v) for k, v in t.items()}
        return t
    return packb(state(tree))


def write_state(path: str, tree) -> int:
    """Write `tree` to `path` as flax's msgpack state; returns the byte
    count."""
    blob = to_bytes(tree)
    with open(path, "wb") as f:
        f.write(blob)
    return len(blob)
