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
