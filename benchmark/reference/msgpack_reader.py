"""Frozen reader of flax msgpack checkpoints, pure Python and numpy.

A copy of the decoder half of ``twoforone_torch/utils/checkpoint.py``, kept
here so that the benchmark reads the staged weights without importing the
program or JAX. Wire format: msgpack (nil, booleans, ints, floats, strings,
binary, arrays, maps) plus flax's extension types 1 (ndarray: a msgpack
array ``(shape, dtype name, C-order bytes)``), 2 (complex scalar) and 3
(numpy scalar), and flax's chunked form for arrays over 1 GiB.
"""

from __future__ import annotations

import struct

import numpy as np

_INTS = {
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
    0xCA: ">f", 0xCB: ">d",
}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self, raw_str: bool = False):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F, raw_str)
        if 0x90 <= b <= 0x9F:
            return [self.read(raw_str) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F, raw_str)
        if b in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[b]
        if b in _INTS:
            return self.unpack(_INTS[b])
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return bytes(self.take(self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])))
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return self._str(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b]), raw_str)
        if b in (0xDC, 0xDD):  # array 16/32
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.read(raw_str) for _ in range(n)]
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

    def _map(self, n: int, raw_str: bool):
        out = {}
        for _ in range(n):
            k = self.read(raw_str)
            out[k] = self.read(raw_str)
        return out


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype_name, buf = _Reader(payload).read(raw_str=True)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode("ascii")
    return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(tuple(shape))


def _ext(code: int, payload: bytes):
    if code == 1:
        return _ndarray(payload)
    if code == 3:
        return _ndarray(payload)[()]
    if code == 2:
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


def read_checkpoint(path: str) -> dict:
    """A ``model-*.msgpack`` file as nested dicts of numpy arrays and scalars."""
    with open(path, "rb") as f:
        r = _Reader(f.read())
    tree = r.read()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after msgpack object")
    return _unchunk(tree)
