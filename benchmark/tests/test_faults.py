"""A run whose timed path is broken underneath comes out not correct: for
each fault a cell can have, the rest of the run driven on the CPU at a tiny
size with the cell's own limits. (One card: no exchange between chips to
leave out.)"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import pytest
import torch

from benchmark.harness import files, runner

SEED = 3_000_000_019


def run(cell, bench):
    return runner.run(cell, SEED, 0.2, False, torch.device("cpu"), time.time(), bench=bench)


def langevin_faults(monkeypatch, fault):
    from twoforone_torch.dynamics import integrators

    advance = integrators.LangevinSimulation._advance
    simulate = integrators.LangevinSimulation.simulate

    def unchanged(self, x, v, coef, noise):
        _, _, potential, forces = advance(self, x, v, coef, noise)
        return x, v, potential, forces

    def half(self, x, v, coef, noise):
        x_new, v_new, potential, forces = advance(self, x, v, coef, noise)
        h = x.shape[0] // 2
        return torch.cat([x_new[:h], x[h:]]), torch.cat([v_new[:h], v[h:]]), potential, forces

    def altered(self, *args, **kwargs):
        frames = simulate(self, *args, **kwargs)  # every chain's answer
        frames[:, -1, 0, 0] += 0.01 * abs(frames).max()
        return frames

    patch = {"unchanged": ("_advance", unchanged), "half": ("_advance", half),
             "altered": ("simulate", altered)}[fault]
    monkeypatch.setattr(integrators.LangevinSimulation, *patch)


def iid_faults(monkeypatch, fault):
    from twoforone_torch.core import diffusion

    update = diffusion._ddim_update

    def unchanged(buf, score_fn, x, *args, **kwargs):
        update(buf, score_fn, x, *args, **kwargs)
        return x

    def half(buf, score_fn, x, *args, **kwargs):
        out = update(buf, score_fn, x, *args, **kwargs)
        h = x.shape[0] // 2
        return torch.cat([out[:h], x[h:]])

    def altered(buf, score_fn, x, t, t_prev, *args, **kwargs):
        out = update(buf, score_fn, x, t, t_prev, *args, **kwargs)
        if t_prev is None:  # the sample as the last step produces it
            out = out.clone()
            out[0, 0, 0] += 0.1 * out.abs().max()
        return out

    monkeypatch.setattr(diffusion, "_ddim_update",
                        {"unchanged": unchanged, "half": half, "altered": altered}[fault])


def train_faults(monkeypatch, fault):
    from twoforone_torch.core.diffusion import GaussianDiffusion
    from twoforone_torch.train import trainer

    if fault == "unchanged":
        monkeypatch.setattr(trainer.AdamW, "apply", lambda self: None)
        monkeypatch.setattr(trainer.AdamW, "step", lambda self, closure=None: None)
    elif fault == "half":
        net_loss = GaussianDiffusion.net_loss

        def half(self, net, mol, generator=None, t=None, noise=None, create_graph=True):
            h = mol.shape[0] // 2
            return net_loss(self, net, mol[:h], generator, t[:h], noise[:h], create_graph)

        monkeypatch.setattr(GaussianDiffusion, "net_loss", half)
    else:
        gradients = trainer.Trainer._gradients

        def altered(self, grads, *args):
            gradients(self, grads, *args)
            grads[0].mul_(1.05)

        monkeypatch.setattr(trainer.Trainer, "_gradients", altered)


PLANT = {"langevin": langevin_faults, "iid": iid_faults, "train": train_faults}
CELLS = {"langevin": ["chignolin.langevin.1000", "trpcage.langevin.1000"],
         "iid": ["chignolin.iid.ddim100.4096"], "train": ["chignolin.train.512"]}


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", [c for cells in CELLS.values() for c in cells])
def test_a_fault_makes_the_run_not_correct(cell, fault, tiny_bench, monkeypatch):
    kind = next(k for k, cells in CELLS.items() if cell in cells)
    assert run(cell, tiny_bench)["correct"]
    PLANT[kind](monkeypatch, fault)
    result = run(cell, tiny_bench)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", CELLS["langevin"])
def test_a_fault_in_a_few_chains_makes_the_run_not_correct(cell, tiny_bench, monkeypatch):
    """A fault confined to fewer chains than a quartile (as one wrong tile of
    a kernel would be) passes ``x_gap_q3`` and fails ``chains_off``."""
    from twoforone_torch.dynamics import integrators

    few = int(files.workload(cell)["limits"]["chains_off"]) + 1
    path = os.path.join(tiny_bench, "traffic", "langevin.1000.json")
    with open(path) as f:
        spec = json.load(f)
    with open(path, "w") as f:
        json.dump(dict(spec, chains=8 * few), f)
    simulate = integrators.LangevinSimulation.simulate

    def altered(self, *args, **kwargs):
        frames = simulate(self, *args, **kwargs)
        frames[:few, -1, 0, 0] += 0.01 * abs(frames).max()
        return frames

    monkeypatch.setattr(integrators.LangevinSimulation, "simulate", altered)
    checks = run(cell, tiny_bench)["checks"]
    assert checks["x_gap_q3"]["value"] <= checks["x_gap_q3"]["limit"], checks
    assert checks["chains_off"]["value"] > checks["chains_off"]["limit"], checks


def test_an_ema_off_its_decay_ramp_makes_the_training_run_not_correct(tiny_bench, monkeypatch):
    """An EMA that stays in its copy phase past it: the followed first steps
    are in that phase and cannot see it; the followed window chunk does."""
    from twoforone_torch.train import ema

    monkeypatch.setattr(ema, "current_decay", lambda step, cfg: np.float32(0.0))
    result = run("chignolin.train.512", tiny_bench)
    assert result["correct"] is False
    assert result["checks"]["window_ema_gap"]["value"] > result["checks"]["window_ema_gap"]["limit"]
