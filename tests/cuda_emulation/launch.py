"""Runs one emulated kernel launch in a process of its own, so that the test
that started it can hold it to a time limit (a fault in a barrier would
otherwise hang the test run).

    python launch.py <library.so> <launch function> <in.npz> <out.npy>

``in.npz`` holds ``x``, ``w``, ``t``, the launch's integer arguments
``ints`` (batch, chains per tile, row blocks, thread blocks, for K1 the
blocks of a cluster, scratch floats of a tile, bytes of shared memory, then
the model's dimensions), their C types ``kinds`` (``i`` int, ``q`` long
long) and the length of the scratch, ``scratch``. Scratch and output start
as NaN.
"""

import ctypes
import sys

import numpy as np


def main(so, fn_name, src, dst):
    data = np.load(src)
    x, w, t, ints = data["x"], data["w"], float(data["t"]), [int(v) for v in data["ints"]]
    fn = getattr(ctypes.CDLL(so), fn_name)
    types = {"i": ctypes.c_int, "q": ctypes.c_longlong}
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_float] + [types[k] for k in str(data["kinds"])]
                   + [ctypes.c_void_p])
    out = np.full_like(x, np.nan)
    scratch = np.full(int(data["scratch"]), np.nan, np.float32)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    rc = fn(ptr(x), ptr(out), ptr(w), ptr(scratch), t, *ints, None)
    if rc != 0:
        return rc
    np.save(dst, out)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:5]))
