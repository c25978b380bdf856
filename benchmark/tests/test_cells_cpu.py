"""Each cell's run end to end on the CPU at a tiny size, against the
reference: the contract's result line, and the exits without a card."""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import pytest
import torch

from benchmark.harness import files, runner

from .conftest import cells, kind

SEED = 2**31 + 977  # over 32 signed bits, as the checks' seeds are


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", cells())
def test_cell_runs_and_is_correct(cell, trace, tiny_bench):
    result = runner.run(cell, SEED, 0.2, bool(trace), torch.device("cpu"), time.time(),
                        bench=tiny_bench)
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert line["device"]["kind"] == "cpu" and line["device"]["platform"] == "cpu"
    spec = files.benchmark_json()
    wanted = {m["name"] for m in files.cell_metrics(spec, cell, bool(trace))}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line
        # The CPU has no device: the readers of device numbers give nothing.
        assert wanted and line["metrics"] == {}
    else:
        assert set(line["metrics"]) == wanted
        assert "setup_s" in wanted and len(wanted) >= 2
    for name, check in line["checks"].items():
        assert math.isfinite(check["value"]) and check["value"] <= check["limit"], name


def test_each_cell_reports_an_end_to_end_and_a_per_layer_metric():
    spec = files.benchmark_json()
    for cell in cells():
        e2e = {m["name"] for m in files.cell_metrics(spec, cell, False)}
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert files.cell_metrics(spec, cell, True), cell
        assert kind(cell) in ("langevin", "iid", "train")


def test_without_a_card_the_run_exits_nonzero_and_prints_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cells()[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=files.ROOT, capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    monkeypatch.setitem(sys.modules, "twoforone_tpu_extra", object())
    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "flax.linen", object())
    assert runner.forbidden_modules() == ["flax"]
