"""The faults of ``test_faults.py`` in the villin cell
(``villin.langevin.100``), its traffic cut in this file to the CPU's tiny
size and held to the cell's own limits.

Villin's noise level (t=5) makes its dynamics chaotic: over a 500-step call
on the card the float32 rounding of the program and of the reference grows
to a few percent of the coordinates in a quarter of the chains, so the
cell's ``x_gap_q3`` limit lies there (``PERF.md``), above the 1% change of
``test_faults.py``'s answer. The changed answers here are therefore sized by
the cell's limit: twice it, in every chain (which ``x_gap_q3`` fails) or in
one chain more than ``chains_off`` allows (which ``chains_off`` fails). A
state left unchanged, in all chains or in half, moves the answer by what a
call's steps move the chains: 0.7% over the tiny traffic's 10 steps on the
CPU, 15% over 50 and 40% over 100, so those faults run 100 steps a call."""

from __future__ import annotations

import json
import os

import pytest

from benchmark.harness import files

from .conftest import TINY
from .test_faults import langevin_faults, run

CELL = "villin.langevin.100"
LIMITS = files.workload(CELL)["limits"]
STEPS = 100  # steps a call for the faults that leave the state unchanged


def cut(bench: str, **over) -> None:
    path = os.path.join(bench, "traffic", f"{files.workload(CELL)['traffic']}.json")
    with open(path) as f:
        spec = json.load(f)
    with open(path, "w") as f:
        json.dump({**spec, **TINY["langevin.1000"], **over}, f)


def alter(monkeypatch, chains) -> None:
    """Move the x coordinate of the first bead of ``chains`` chains' answer
    by twice the ``x_gap_q3`` limit of the widest coordinate."""
    from twoforone_torch.dynamics import integrators

    simulate = integrators.LangevinSimulation.simulate

    def altered(self, *args, **kwargs):
        frames = simulate(self, *args, **kwargs)
        frames[:chains, -1, 0, 0] += 2 * LIMITS["x_gap_q3"] * abs(frames).max()
        return frames

    monkeypatch.setattr(integrators.LangevinSimulation, "simulate", altered)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_fault_makes_the_run_not_correct(fault, tiny_bench, monkeypatch):
    cut(tiny_bench, steps_per_call=STEPS, save_interval=STEPS)
    assert run(CELL, tiny_bench)["correct"]
    if fault == "altered":
        alter(monkeypatch, None)  # every chain
    else:
        langevin_faults(monkeypatch, fault)
    result = run(CELL, tiny_bench)
    assert result["correct"] is False, result["checks"]


def test_a_fault_in_a_few_chains_makes_the_run_not_correct(tiny_bench, monkeypatch):
    few = int(LIMITS["chains_off"]) + 1
    cut(tiny_bench, chains=8 * few)
    alter(monkeypatch, few)
    result = run(CELL, tiny_bench)
    checks = result["checks"]
    assert checks["x_gap_q3"]["value"] <= checks["x_gap_q3"]["limit"], checks
    assert checks["chains_off"]["value"] > checks["chains_off"]["limit"], checks
    assert result["correct"] is False
