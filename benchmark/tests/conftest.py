"""Shared fixtures of the benchmark's tests: a copy of the benchmark's
folder whose traffic is cut to sizes the CPU runs in seconds."""

from __future__ import annotations

import json
import os
import shutil

import pytest
import torch

from benchmark.harness import files

TINY = {
    "langevin.1000": dict(chains=4, steps_per_call=10, save_interval=10),
    "langevin.100": dict(chains=4, steps_per_call=10, save_interval=10),
    "iid.ddim100.4096": dict(batch=8, sample_steps=5),
    "iid.ancestral1000.256": dict(batch=8),
    "train.512": dict(batch_size=16, frames=400, steps_per_chunk=10, warmup_steps=103),
}


@pytest.fixture(autouse=True)
def few_threads():
    """Workers of a parallel run share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def tiny_bench(tmp_path):
    """A copy of ``benchmark/`` with its traffic cut to tiny sizes."""
    bench = tmp_path / "benchmark"
    shutil.copytree(files.BENCH, bench, ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    for name, over in TINY.items():
        path = bench / "traffic" / f"{name}.json"
        spec = json.loads(path.read_text())
        spec.update(over)
        path.write_text(json.dumps(spec))
    return str(bench)


def cells() -> list:
    return [w["name"] for w in files.benchmark_json()["workloads"]]


def kind(cell: str) -> str:
    return files.traffic(files.workload(cell)["traffic"])["driver"]


def card_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


os.environ.setdefault("TFO_KERNEL_CACHE", os.path.join(files.BENCH, ".cache", "kernels"))
