"""Reader for flax msgpack checkpoints, in pure Python with numpy.

The JAX package writes checkpoints with ``flax.serialization.msgpack_serialize``
(``twoforone_tpu/utils/checkpoint.py``): a msgpack map tree whose array leaves
are msgpack extension objects. This module decodes that format without
``flax`` or the ``msgpack`` package, neither of which the GPU host has.

Wire format handled (msgpack spec, plus flax's extension types):

- nil, booleans, ints, floats, strings, binary, arrays and maps;
- ext type 1 (ndarray): the payload is itself a msgpack array
  ``(shape, dtype name, C-order bytes)``;
- ext type 2 (complex scalar): payload ``(real, imag)``;
- ext type 3 (numpy scalar): an ndarray payload unpacked to a scalar;
- flax's chunked form for arrays over 1 GiB
  (``{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}``).
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def read(self, raw_str: bool = False):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F, raw_str)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F, raw_str)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F, raw_str)
        simple = {
            0xC0: None, 0xC2: False, 0xC3: True,
        }
        if b in simple:
            return simple[b]
        ints = {
            0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
            0xCA: ">f", 0xCB: ">d",
        }
        if b in ints:
            return self.unpack(ints[b])
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            n = self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
            return bytes(self.take(n))
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            n = self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
            return self._str(n, raw_str)
        if b in (0xDC, 0xDD):  # array 16/32
            return self._array(self.unpack(">H" if b == 0xDC else ">I"), raw_str)
        if b in (0xDE, 0xDF):  # map 16/32
            return self._map(self.unpack(">H" if b == 0xDE else ">I"), raw_str)
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            n = 1 << (b - 0xD4)
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(n)))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(n)))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def _str(self, n: int, raw: bool):
        s = bytes(self.take(n))
        return s if raw else s.decode("utf-8")

    def _array(self, n: int, raw_str: bool):
        return [self.read(raw_str) for _ in range(n)]

    def _map(self, n: int, raw_str: bool):
        out = {}
        for _ in range(n):
            k = self.read(raw_str)
            out[k] = self.read(raw_str)
        return out


def _ndarray(payload: bytes) -> np.ndarray:
    r = _Reader(payload)
    shape, dtype_name, buf = r.read(raw_str=True)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode("ascii")
    if dtype_name == "bfloat16":
        raise ValueError("bfloat16 arrays need ml_dtypes, which the port does not use")
    arr = np.frombuffer(buf, dtype=np.dtype(dtype_name))
    return arr.reshape(tuple(shape), order="C")


def _ext(code: int, payload: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray(payload)
    if code == _EXT_NPSCALAR:
        return _ndarray(payload)[()]
    if code == _EXT_COMPLEX:
        real, imag = _Reader(payload).read()
        return complex(real, imag)
    raise ValueError(f"unknown msgpack extension type {code}")


def _unchunk(tree):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes):
    """Decode flax msgpack bytes into nested dicts of numpy arrays/scalars."""
    r = _Reader(data)
    tree = r.read()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after msgpack object")
    return _unchunk(tree)


def load_checkpoint(path: str):
    """Read a ``model-*.msgpack`` checkpoint file into a nested dict."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())
