"""Times the attention-core kernels (K2 forward, K3 backward) of one checkout
of the repository, so that two commits can be compared on one card.

    python3 scripts/torch_core_bench.py [CHECKOUT]

CHECKOUT is the root of a checkout (default: this one); its
``twoforone_torch`` is imported and its kernels built there. At trp-cage
width (N=20, 8 x 64 heads) and at each chain count of ``chip_smoke.py``'s
``CORE_TIMED_CHAINS`` it prints one JSON line a kernel with ``chip_smoke.py``'s
``ms`` and ``device_ms`` (``core_times``) beside the byte bound, and the card's
name and power limit. Timing helpers and inputs are this repository's
``chip_smoke.py``, so both checkouts are timed alike; run parent, change,
change, parent in one call.
"""

import importlib.util
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(root=HERE):
    if not torch.cuda.is_available():
        print("torch_core_bench: CUDA is not available", file=sys.stderr)
        return 2
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from twoforone_torch.ops import attention_cl_core as acc

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print("gpu:", smi, flush=True)
    dev, n = torch.device("cuda"), smoke.TRP_CAGE["n"]
    for chains in smoke.CORE_TIMED_CHAINS:
        times = smoke.core_times(acc, *smoke.core_inputs(n, chains, dev))
        for (which, tm), (flops, nbytes) in zip(times.items(),
                                                smoke.core_work(chains, n, smoke.HEADS, smoke.DH)):
            bound_ms, bound_by = smoke.bound(flops, nbytes)
            print(json.dumps({"checkout": root, "package": os.path.dirname(acc.__file__),
                              "kernel": f"cl_attention_{which}", "N": n, "chains": chains, **tm,
                              "bound_ms": bound_ms, "bound_by": bound_by}), flush=True)
    print("gpu:", smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:2]))
