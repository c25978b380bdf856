"""The full ancestral chain (``chignolin.iid.ancestral1000.256``), its
traffic cut to the CPU's tiny size: the reference follows the program's
chain to float32 rounding, and a run whose chain is broken underneath comes
out not correct under the cell's own limits.

The faults, each planted in the program's ``p_sample``: a step that returns
its state unchanged; half of the batch left out of every step; a few
samples altered where the last step produces them (one more than
``samples_off`` allows, each by ten times the quartile's limit of the
widest coordinate); one step's noise left out (t = T/2); and the last
step's variance kept at t=0. The program's posterior log variance at t=0 is
clipped to log(1e-20), so leaving the t=0 mask out alone would add noise of
~1e-10 and change nothing; the fault planted is the other common convention,
the variance of t=1 used at t=0 with no mask."""

from __future__ import annotations

import json
import os

import pytest
import torch

from benchmark.harness import files

from .test_faults import run

CELL = "chignolin.iid.ancestral1000.256"
LIMITS = files.workload(CELL)["limits"]
FEW = int(LIMITS["samples_off"]) + 1


def plant(monkeypatch, fault):
    from twoforone_torch.core import diffusion
    from twoforone_torch.ops.geometry import center_zero

    p_sample = diffusion.p_sample

    def faulty(buf, score_fn, x, t, noise, objective="pred_noise", t_scalar=None):
        T = buf.num_timesteps
        if fault == "noise_left_out" and t_scalar == T // 2:
            noise = torch.zeros_like(noise)
        out = p_sample(buf, score_fn, x, t, noise, objective, t_scalar)
        if fault == "unchanged":
            return x
        if fault == "half":
            h = x.shape[0] // 2
            return torch.cat([out[:h], x[h:]])
        if fault == "altered" and t_scalar == 0:
            out = out.clone()
            out[:FEW, 0, 0] += 10 * LIMITS["sample_gap_q3"] * out.abs().max()
        if fault == "variance_at_0" and t_scalar == 0:
            out = out + torch.exp(0.5 * buf.posterior_log_variance_clipped[1]) * center_zero(noise)
        return out

    monkeypatch.setattr(diffusion, "p_sample", faulty)


def test_the_reference_follows_the_program(tiny_bench):
    """The program in float32 on the CPU (the plain network there) against
    the float64 reference: the samples agree to rounding, far inside the
    cell's limits."""
    checks = run(CELL, tiny_bench)["checks"]
    assert checks["sample_gap_q3"]["value"] <= checks["sample_gap_q3"]["limit"] / 10, checks
    assert checks["samples_off"]["value"] == 0, checks


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "noise_left_out",
                                   "variance_at_0"])
def test_a_fault_makes_the_run_not_correct(fault, tiny_bench, monkeypatch):
    if fault == "altered":  # a batch whose quartile a few samples do not reach
        path = os.path.join(tiny_bench, "traffic", "iid.ancestral1000.256.json")
        with open(path) as f:
            spec = json.load(f)
        with open(path, "w") as f:
            json.dump(dict(spec, batch=5 * FEW), f)
    plant(monkeypatch, fault)
    result = run(CELL, tiny_bench)
    assert result["correct"] is False, result["checks"]
    if fault == "altered":
        checks = result["checks"]
        assert checks["sample_gap_q3"]["value"] <= checks["sample_gap_q3"]["limit"], checks
