"""A decoder of the JAX package's ``.msgpack`` checkpoints, in Python and numpy.

The JAX package writes its checkpoints with ``flax.serialization``
(``msgpack_serialize`` of the payload's state dict); the machine the
port runs on has neither flax nor the ``msgpack`` package, so this module
reads the format itself. It returns what ``flax.serialization.msgpack_restore``
returns:

- msgpack maps → ``dict`` (string keys), arrays → ``list``, str → ``str``,
  bin → ``bytes``, ints, floats, bool and nil → their Python values;
- ext type 1 (an ndarray: a msgpack ``[shape, dtype name, raw bytes]``
  triple) → a read-only numpy array; bfloat16, which numpy lacks, comes
  back as the float32 array of the same values (exact);
- ext type 2 (a native complex: ``[real, imag]``) → ``complex``;
- ext type 3 (a numpy scalar, packed as an ndarray) → the numpy scalar;
- flax's chunked arrays (``{"__msgpack_chunked_array__": True, "shape":
  {...}, "chunks": {...}}``, what it writes for a leaf over 2³⁰ bytes) →
  the joined array.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw  # str values as bytes (flax reads its ndarray triples so)

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def string(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, code: int, n: int):
        data = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_COMPLEX:
            real, imag = unpackb(data)
            return complex(real, imag)
        if code == _EXT_NPSCALAR:
            return _ndarray(data)[()]
        raise ValueError(f"unknown msgpack ext type {code}")

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.mapping(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return bytes(self.take(self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(self.unpack(">b"), n)
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        if b in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):  # fixext 1/2/4/8/16
            code = self.unpack(">b")
            return self.ext(code, {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}[b])
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return self.string(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b]))
        if b in (0xDC, 0xDD):  # array 16/32
            return [self.value() for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):  # map 16/32
            return self.mapping(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"invalid msgpack type byte 0x{b:02x}")

    def mapping(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def unpackb(data: bytes, raw: bool = False) -> Any:
    """One msgpack object from ``data`` (all of it must be consumed)."""
    reader = _Reader(data, raw)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes of trailing data after the msgpack object")
    return out


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = unpackb(data, raw=True)
    shape: Tuple[int, ...] = tuple(shape)
    if dtype_name == b"bfloat16":  # the upper half of each float32
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape, order="C")


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes) -> Any:
    """The tree ``flax.serialization.msgpack_restore`` gives for ``data``."""
    return _unchunk(unpackb(data))


def load(path: str) -> Any:
    """The tree of a ``.msgpack`` file."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())
