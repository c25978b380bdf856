"""The port's benchmark: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It measures ``twoforone_torch`` on one CUDA
device, checks what the timed path produced against the plain reference in
``benchmark/reference/``, and prints one JSON line last on standard output.
"""

import time

T0 = time.time()  # set-up is measured from here

import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
# Kernel builds and compile caches stay in fixed directories of the checkout,
# so that only a cell's first run there builds.
os.environ["TFO_KERNEL_CACHE"] = os.path.join(BENCH, ".cache", "kernels")
os.environ["TRITON_CACHE_DIR"] = os.path.join(BENCH, ".cache", "triton")
sys.path.insert(0, os.path.dirname(BENCH))

from benchmark.harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
