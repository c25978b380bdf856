"""Where the benchmark finds what belongs to one configuration, traffic mix,
cell, driver kind or metric: a file of its own, named after it.

- ``configs/<config>.json``: the configuration as it is run;
- ``traffic/<traffic>.json``: the traffic mix's parameters and the driver
  kind (``"driver"``) that reads them;
- ``workloads/<cell>.json``: the cell's config and traffic, and the limits
  of its correctness check;
- ``drivers/<kind>.py``: a class ``Driver`` (set-up, one timed unit, the
  check against the reference);
- ``metrics/<metric>.py``: a function ``read(run)`` that returns the
  metric's value, or None where it finds nothing to read.

Adding any of them is adding a file and its entry in ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def _json(kind: str, name: str, bench: str = BENCH) -> dict:
    path = os.path.join(bench, kind, f"{name}.json")
    with open(path) as f:
        return json.load(f)


def config(name: str, bench: str = BENCH) -> dict:
    return _json("configs", name, bench)


def traffic(name: str, bench: str = BENCH) -> dict:
    return _json("traffic", name, bench)


def workload(name: str, bench: str = BENCH) -> dict:
    return _json("workloads", name, bench)


def _module(kind: str, name: str, bench: str):
    path = os.path.join(bench, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    module_name = f"benchmark_{kind}_{name.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(kind: str, bench: str = BENCH):
    return _module("drivers", kind, bench).Driver


def metric(name: str, bench: str = BENCH):
    return _module("metrics", name, bench).read


def benchmark_json(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_metrics(spec: dict, cell: str, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer metrics. An end-to-end metric without a
    ``workloads`` list is every cell's; a per-layer metric without one
    belongs to every cell that reports the end-to-end metric it moves."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names else [])]
