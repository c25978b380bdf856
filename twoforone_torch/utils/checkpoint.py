"""Reader and writer for flax msgpack checkpoints, in pure Python with numpy.

The JAX package writes checkpoints with ``flax.serialization.msgpack_serialize``
(``twoforone_tpu/utils/checkpoint.py``): a msgpack map tree whose array leaves
are msgpack extension objects. This module decodes and encodes that format
without ``flax`` or the ``msgpack`` package, neither of which the GPU host
has, so a checkpoint written by either package loads in the other.

:func:`save_checkpoint`, :func:`load_checkpoint` and :func:`checkpoint_exists`
keep the JAX package's names and paths (``<results_folder>/model-<name>.msgpack``,
written through a ``.tmp`` file and ``os.replace``); the tree is the state
dict flax writes: nested dicts with string keys (a tuple becomes a dict
keyed ``"0"``, ``"1"``, ...), numpy arrays and Python scalars.

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

import os
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


def read_checkpoint(path: str):
    """Read a ``model-*.msgpack`` checkpoint file into a nested dict."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


class _Writer:
    """msgpack encoder with the choices of the ``msgpack`` package as flax
    calls it: the shortest integer form, floats as float64, strings as str,
    bytes as bin; dict keys in sorted order, as JAX's tree utilities leave
    them; numpy arrays as extension type 1 and numpy scalars as type 3."""

    def __init__(self):
        self.out = bytearray()

    def _head(self, n, fix_base, fix_max, codes):
        if fix_base is not None and n < fix_max:
            self.out.append(fix_base | n)
            return
        for (limit, code, fmt) in codes:
            if n < limit:
                self.out += bytes([code]) + struct.pack(fmt, n)
                return
        raise ValueError(f"msgpack object too large ({n})")

    def _int(self, x: int):
        if 0 <= x < 0x80 or -32 <= x < 0:
            self.out += struct.pack(">b" if x < 0 else ">B", x)
        elif x >= 0:
            self._head(x, None, 0, ((1 << 8, 0xCC, ">B"), (1 << 16, 0xCD, ">H"),
                                    (1 << 32, 0xCE, ">I"), (1 << 64, 0xCF, ">Q")))
        else:
            for bits, code, fmt in ((8, 0xD0, ">b"), (16, 0xD1, ">h"), (32, 0xD2, ">i"),
                                    (64, 0xD3, ">q")):
                if x >= -(1 << (bits - 1)):
                    self.out += bytes([code]) + struct.pack(fmt, x)
                    return
            raise ValueError(f"integer {x} does not fit msgpack")

    def _ext(self, code: int, payload: bytes):
        n = len(payload)
        if n in (1, 2, 4, 8, 16):
            self.out.append(0xD4 + n.bit_length() - 1)
        else:
            self._head(n, None, 0, ((1 << 8, 0xC7, ">B"), (1 << 16, 0xC8, ">H"),
                                    (1 << 32, 0xC9, ">I")))
        self.out += struct.pack(">b", code) + payload

    def pack(self, x):
        if x is None:
            self.out.append(0xC0)
        elif isinstance(x, np.ndarray):
            self._ext(_EXT_NDARRAY, _ndarray_bytes(x))
        elif isinstance(x, np.generic):
            self._ext(_EXT_NPSCALAR, _ndarray_bytes(np.asarray(x)))
        elif isinstance(x, bool):
            self.out.append(0xC3 if x else 0xC2)
        elif isinstance(x, int):
            self._int(x)
        elif isinstance(x, float):
            self.out += b"\xcb" + struct.pack(">d", x)
        elif isinstance(x, str):
            raw = x.encode("utf-8")
            self._head(len(raw), 0xA0, 32, ((1 << 8, 0xD9, ">B"), (1 << 16, 0xDA, ">H"),
                                            (1 << 32, 0xDB, ">I")))
            self.out += raw
        elif isinstance(x, (bytes, bytearray)):
            self._head(len(x), None, 0, ((1 << 8, 0xC4, ">B"), (1 << 16, 0xC5, ">H"),
                                         (1 << 32, 0xC6, ">I")))
            self.out += x
        elif isinstance(x, (list, tuple)):
            self._head(len(x), 0x90, 16, ((1 << 16, 0xDC, ">H"), (1 << 32, 0xDD, ">I")))
            for v in x:
                self.pack(v)
        elif isinstance(x, dict):
            self._head(len(x), 0x80, 16, ((1 << 16, 0xDE, ">H"), (1 << 32, 0xDF, ">I")))
            for k in sorted(x):
                self.pack(k)
                self.pack(x[k])
        else:
            raise TypeError(f"cannot encode {type(x).__name__} as msgpack")


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """flax's payload of an array: the msgpack array (shape, dtype name, C-order bytes)."""
    if arr.dtype.hasobject:
        raise ValueError("object arrays cannot be serialized")
    w = _Writer()
    w.pack([list(arr.shape), arr.dtype.name, np.ascontiguousarray(arr).tobytes()])
    return bytes(w.out)


def msgpack_serialize(tree) -> bytes:
    """Encode nested dicts of numpy arrays and Python scalars as flax does
    (``flax.serialization.msgpack_serialize`` of that state dict)."""
    w = _Writer()
    w.pack(tree)
    return bytes(w.out)


def checkpoint_path(results_folder: str, name: str) -> str:
    return os.path.join(results_folder, f"model-{name}.msgpack")


def save_checkpoint(results_folder: str, name: str, state: dict) -> str:
    """Write ``state`` to ``<results_folder>/model-<name>.msgpack`` through a
    ``.tmp`` file of this process and an atomic rename, so that the ranks of
    a data-parallel run may all write to one folder; returns the path."""
    os.makedirs(results_folder, exist_ok=True)
    path = checkpoint_path(results_folder, name)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack_serialize(state))
    os.replace(tmp, path)
    return path


def load_checkpoint(results_folder: str, name: str = "last") -> dict:
    """Read ``<results_folder>/model-<name>.msgpack`` into a nested dict."""
    return read_checkpoint(checkpoint_path(results_folder, name))


def checkpoint_exists(results_folder: str, name: str = "last") -> bool:
    return os.path.exists(checkpoint_path(results_folder, name))
