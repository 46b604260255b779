"""A msgpack reader for the JAX package's checkpoints, in pure Python.

The JAX package writes a checkpoint with ``flax.serialization.
msgpack_serialize`` (core/checkpoint.py:41-60 of the JAX package). This
module reads the subset that function writes: nil, bool, ints, floats,
str, bin, arrays, maps, and flax's two ext types for numpy data:

  * ext 1 (``ndarray``): a msgpack ``(shape, dtype name, bytes)``, C order;
  * ext 3 (``npscalar``): the same encoding of a 0-d array, read as a numpy
    scalar.

bfloat16 arrays (a dtype numpy lacks) are widened to float32, which is
exact. Anything else raises ``MsgpackError`` rather than being dropped:
ext 2 (flax's Python ``complex``), any other ext code, flax's chunked
arrays (an array over 2^30 bytes is stored as a map marked
``__msgpack_chunked_array__``), map keys that are not strings, a truncated
buffer and trailing bytes."""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED_MARK = "__msgpack_chunked_array__"


class MsgpackError(ValueError):
    """A buffer this reader cannot parse, or will not parse in part."""


class _Reader:

    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise MsgpackError(
                f"truncated msgpack data: {n} bytes wanted at offset "
                f"{self.pos}, {len(self.buf) - self.pos} left")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b in _FIXED:
            return _FIXED[b]
        if b in _SCALARS:
            return self.unpack(_SCALARS[b])
        if b in _BIN:
            return bytes(self.take(self.unpack(_BIN[b])))
        if b in _STR:
            return self.str(self.unpack(_STR[b]))
        if b in _ARRAY:
            return self.array(self.unpack(_ARRAY[b]))
        if b in _MAP:
            return self.map(self.unpack(_MAP[b]))
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b in _EXT:
            return self.ext(self.unpack(_EXT[b]))
        raise MsgpackError(f"byte 0x{b:02x} at offset {self.pos - 1} is not "
                           "a msgpack type")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            if not isinstance(k, str):
                raise MsgpackError(f"map key {k!r} is not a string")
            out[k] = self.value()
        if CHUNKED_MARK in out:
            raise MsgpackError(
                "a chunked array (flax stores arrays over 2^30 bytes as "
                "chunks) is not read by this reader")
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray(data)
        if code == EXT_NPSCALAR:
            return _ndarray(data)[()]
        if code == EXT_COMPLEX:
            raise MsgpackError("ext type 2 (a Python complex) is not read")
        raise MsgpackError(f"unknown msgpack ext type {code}")


_FIXED = {0xC0: None, 0xC2: False, 0xC3: True}
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_BIN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
_STR = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_ARRAY = {0xDC: ">H", 0xDD: ">I"}
_MAP = {0xDE: ">H", 0xDF: ">I"}
_EXT = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _ndarray(data: bytes) -> np.ndarray:
    """flax's ``_ndarray_from_bytes``: (shape, dtype name, C-order bytes),
    copied out of the buffer."""
    tpl = unpackb(data)
    if not (isinstance(tpl, list) and len(tpl) == 3):
        raise MsgpackError("an ndarray ext is not (shape, dtype, bytes)")
    shape, name, raw = tpl
    if isinstance(name, bytes):
        name = name.decode("ascii")
    if not isinstance(raw, bytes) or not all(
            isinstance(s, int) and s >= 0 for s in shape):
        raise MsgpackError("an ndarray ext is not (shape, dtype, bytes)")
    shape: Tuple[int, ...] = tuple(shape)
    if name == "bfloat16":
        bits = np.frombuffer(raw, np.uint16).astype(np.uint32) << 16
        arr = bits.view(np.float32)
    else:
        try:
            dtype = np.dtype(name)
        except TypeError as e:
            raise MsgpackError(f"unknown ndarray dtype {name!r}") from e
        if len(raw) % dtype.itemsize:
            raise MsgpackError("an ndarray's bytes are not whole elements")
        arr = np.frombuffer(raw, dtype).copy()
    if arr.size != int(np.prod(shape, dtype=np.int64)):
        raise MsgpackError(f"an ndarray of shape {shape} holds {arr.size} "
                           "elements")
    return arr.reshape(shape)


def unpackb(data: bytes) -> Any:
    """The one msgpack object that is the whole of `data`."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.buf):
        raise MsgpackError(f"{len(r.buf) - r.pos} bytes after the msgpack "
                           "object")
    return out
