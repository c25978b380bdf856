"""Runs one emulated launch of the attention core in a process of its own,
so that the test that started it can hold it to a time limit (a fault in a
barrier would otherwise hang the test run).

    python launch_core.py <library.so> fwd|bwd <in.npz> <out.npz>

``in.npz`` holds the wrapper's inputs in the kernels' layout (``q``, ``k``,
``v``, ``x``, ``qb``, ``qkd``, and for the backward ``dout``, ``dfd``; the
kernels themselves take no ``qb``). The persistent grid follows the emulated
card, which ``EMU_SM_COUNT`` and ``EMU_BLOCKS_PER_SM`` set
(``cuda_runtime.h``). Outputs start as NaN; the out file holds ``out``,
``fdiff`` or ``dq``, ``dk``, ``dv``, ``dx``, ``dqb``, ``dqkd``.
"""

import ctypes
import sys

import numpy as np

INPUTS = {"fwd": ("q", "k", "v", "x", "qkd"),
          "bwd": ("q", "k", "v", "x", "qkd", "dout", "dfd")}
OUTPUTS = {"fwd": (("out", "q"), ("fdiff", "qkd")),
           "bwd": (("dq", "q"), ("dk", "q"), ("dv", "q"), ("dqb", "qb"), ("dqkd", "qkd"),
                   ("dx", "x"))}


def main(so, which, src, dst):
    data = np.load(src)
    ins = [np.ascontiguousarray(data[name], np.float32) for name in INPUTS[which]]
    outs = {name: np.full_like(data[like], np.nan, np.float32) for name, like in OUTPUTS[which]}
    fn = getattr(ctypes.CDLL(so), f"cl_attention_{which}_launch")
    ptrs = [*ins, *outs.values()]
    fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    bsz, n, heads, dh = ins[0].shape
    rc = fn(*(a.ctypes.data_as(ctypes.c_void_p) for a in ptrs), bsz, n, heads, dh, None)
    if rc != 0:
        return rc
    np.savez(dst, **outs)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:5]))
