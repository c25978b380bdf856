"""One run of one cell: set-up, the measured window, the optional traced
units, the check against the reference, and the result line.

The window runs whole timed units (a Langevin call, a sampling batch, a
training chunk), each ending in a synchronisation, until ``--seconds`` have
passed; the window ends with the unit that crosses it. Every rate is the
window's work over the window's time; the result line also lists each
unit's seconds (``unit_s``), which show a run that changed pace inside
its window. Set-up is the process's time up to the
first timed unit. With ``--trace 1`` the same window runs untraced, then
one more unit runs under the profiler for the per-layer metrics.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
import traceback

from . import files, yardstick
from .cell import Cell

FORBIDDEN = ("jax", "jaxlib", "flax", "twoforone_tpu")


class Run:
    """What the metric readers read."""

    def __init__(self, cell, driver, setup_s, window_s, units, trace):
        self.cell, self.driver = cell, driver
        self.setup_s, self.window_s, self.units, self.trace = setup_s, window_s, units, trace

    def rate(self, work: str):
        """``work`` done per second over the window, or None where the
        driver does no such work."""
        per = self.driver.work.get(work)
        return None if per is None else per * self.units / self.window_s

    def mfu(self, kind: str):
        """Percent of the FP32 peak that the window's products reached, for
        a driver of ``kind`` on the card."""
        if self.cell.traffic["driver"] != kind or self.cell.device.type != "cuda":
            return None
        return 100.0 * self.driver.flops_per_unit * self.units / self.window_s \
            / yardstick.PEAK_FP32_FLOPS

    def traced_per(self, work: str):
        """``work`` done in the traced unit, or None."""
        return None if self.trace is None else self.driver.work.get(work)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, taken whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_label():
    """``(name, power limit)`` from ``nvidia-smi``, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def run(cell_name: str, seed: int, seconds: float, trace: bool, device, t0: float,
        spec: dict = None, bench: str = files.BENCH) -> dict:
    """Run one cell on ``device`` and return the result line (a dict); the
    process started at ``t0`` (``time.time()``)."""
    import torch

    from . import trace as tracing

    spec = spec or files.benchmark_json()
    entry = next(w for w in spec["workloads"] if w["name"] == cell_name)
    cell = Cell.load(cell_name, seed, device, bench)
    wl = files.workload(cell_name, bench)
    if (wl["config"], wl["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"workloads/{cell_name}.json names another config or traffic "
                         "than BENCHMARK.json")
    card = device.type == "cuda"
    sync = torch.cuda.synchronize if card else (lambda: None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cell.mark("imports")
    driver = files.driver(cell.traffic["driver"], bench)(cell)
    sync()
    cell.mark("warm-up")
    setup_s = time.time() - t0
    start = time.perf_counter()
    ends = [start]  # each unit's end on the same clock
    while True:
        driver.unit()
        ends.append(time.perf_counter())
        if ends[-1] - start >= seconds:
            break
    units, window_s = len(ends) - 1, ends[-1] - start
    driver.window_units = units
    failed = driver.failed_units()
    peak = torch.cuda.max_memory_allocated(device) if card else 0
    traced = tracing.traced(driver.unit) if trace else None
    label = card_label() if card else None

    driver.release()
    if card:
        torch.cuda.empty_cache()
    check_start = time.perf_counter()
    checks = driver.check()
    check_s = time.perf_counter() - check_start
    correct = failed == 0 and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                                  for c in checks)

    record = Run(cell, driver, setup_s, window_s, units, traced)
    metrics = {}
    for m in files.cell_metrics(spec, cell_name, trace):
        value = files.metric(m["name"], bench)(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if card else device.type,
           "kind": torch.cuda.get_device_name(device) if card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": units, "failed": failed,
              "metrics": metrics, "device": dev}
    if traced is not None:
        dev.update(busy_s=traced.busy_s, window_s=traced.window_s)
        result["breakdown"] = traced.breakdown()
    result["card"] = label
    marks = [t0] + [t for _, t in cell.marks]
    result["setup_parts_s"] = {p: marks[i + 1] - marks[i] for i, (p, _) in enumerate(cell.marks)}
    result["check_s"] = check_s
    result["unit_s"] = [b - a for a, b in zip(ends, ends[1:])]
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return result


def parse(argv):
    p = argparse.ArgumentParser(description="Run one cell of the port's benchmark.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse(argv)
    try:
        import torch

        spec = files.benchmark_json()
        entry = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
        if entry is None:
            print(f"unknown workload {args.workload!r}", file=sys.stderr)
            return 2
        if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
            print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0), t0, spec)
    except Exception:  # the run's boundary: report and exit without a result
        traceback.print_exc()
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
