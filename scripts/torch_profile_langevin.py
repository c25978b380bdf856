"""Where a Langevin step of the PyTorch/CUDA port spends its time on the GPU.

    python3 scripts/torch_profile_langevin.py [trp_cage|bba|chignolin] [chains] [steps]

Runs the port's ``LangevinDiffusion`` (``fused="auto"``, bench.py's settings, the
staged trained weights) for ``steps`` steps under ``torch.profiler`` after a
warm-up, and prints one JSON line: wall time per step, device-busy time per
step (sum of kernel durations), the idle share, and the device time per step
of the ten largest kernels by name. Needs a CUDA device. Set-up (models,
starts, settings) is ``chip_smoke.py``'s.
"""

import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("torch_profile_langevin: CUDA is not available", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from twoforone_torch.utils.artifacts import load_ema_params

    torch.backends.cuda.matmul.allow_tf32 = False
    spec = {"trp_cage": cs.TRP_CAGE, "bba": cs.BBA, "chignolin": cs.CHIGNOLIN}[
        sys.argv[1] if len(sys.argv) > 1 else "trp_cage"]
    chains = int(sys.argv[2]) if len(sys.argv) > 2 else 1000
    steps = int(sys.argv[3]) if len(sys.argv) > 3 else 50
    dev = torch.device("cuda")
    gd = cs.make_gd(spec)
    ld = cs.make_sim(gd, load_ema_params(spec["name"]), spec, chains, "auto", 10_000_000,
                     steps, dev)
    ld.sim.simulate(sub_interval=steps)  # warm-up: builds the kernels, fills the allocator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ld.sim.simulate(sub_interval=steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.name] = kernels.get(ev.name, 0.0) + ev.device_time / 1e3  # us -> ms
    busy_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({
        "gpu": smi, "protein": spec["name"], "mode": ld.force_fn.mode, "chains": chains,
        "steps": steps, "wall_ms_per_step_profiled": wall_ms / steps,
        "device_busy_ms_per_step": busy_ms / steps,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "kernel_launches_per_step": sum(
            1 for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA) / steps,
        "top_kernels_ms_per_step": {name[:80]: ms / steps for name, ms in top},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
