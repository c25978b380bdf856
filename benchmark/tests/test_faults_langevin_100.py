"""The faults of ``test_faults.py`` in the paper-scale Langevin cell
(``chignolin.langevin.100``), its traffic cut to the CPU's tiny size and
held to the cell's own limits. At 100 chains K1 runs one chain a tile, so
``chains_off`` is what fails a fault confined to a few chains."""

from __future__ import annotations

import json
import os

import pytest

from benchmark.harness import files

from .conftest import TINY
from .test_faults import langevin_faults, run

CELL = "chignolin.langevin.100"


def cut(bench: str, **over) -> None:
    path = os.path.join(bench, "traffic", f"{files.workload(CELL)['traffic']}.json")
    with open(path) as f:
        spec = json.load(f)
    with open(path, "w") as f:
        json.dump({**spec, **TINY["langevin.1000"], **over}, f)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_fault_makes_the_run_not_correct(fault, tiny_bench, monkeypatch):
    cut(tiny_bench)
    assert run(CELL, tiny_bench)["correct"]
    langevin_faults(monkeypatch, fault)
    result = run(CELL, tiny_bench)
    assert result["correct"] is False, result["checks"]


def test_a_fault_in_a_few_chains_makes_the_run_not_correct(tiny_bench, monkeypatch):
    from twoforone_torch.dynamics import integrators

    few = int(files.workload(CELL)["limits"]["chains_off"]) + 1
    cut(tiny_bench, chains=8 * few)
    simulate = integrators.LangevinSimulation.simulate

    def altered(self, *args, **kwargs):
        frames = simulate(self, *args, **kwargs)
        frames[:few, -1, 0, 0] += 0.01 * abs(frames).max()
        return frames

    monkeypatch.setattr(integrators.LangevinSimulation, "simulate", altered)
    result = run(CELL, tiny_bench)
    checks = result["checks"]
    assert checks["x_gap_q3"]["value"] <= checks["x_gap_q3"]["limit"], checks
    assert checks["chains_off"]["value"] > checks["chains_off"]["limit"], checks
    assert result["correct"] is False
