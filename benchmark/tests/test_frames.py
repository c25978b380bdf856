"""The training driver's frames at the configuration's bead count: the
10-bead system as before, bit for bit, and at any other length the system
of the program's 56-bead synthetic data, run end to end on the CPU at 56
beads (the shape of protein G's training at a CPU's widths)."""

from __future__ import annotations

import hashlib
import json
import os
import time

import numpy as np
import pytest
import torch

from benchmark.drivers.train import training_frames
from benchmark.harness import files, runner, synthetic
from benchmark.harness.cell import Cell

SEED = 2**31 + 977
# sha256 of chignolin.train.512's frames at SEED, as the driver drew them
# when it knew the 10-bead system alone (CHAIN10_TORSION_COMPONENTS always).
CHIGNOLIN_FRAMES_SHA256 = "18548875b22bb7f6240dd914cadc62a6c31f12d99b6b4aa5438c4bbf387623c3"


def test_ten_beads_are_the_chain10_system():
    assert synthetic.chain_components(10) is synthetic.CHAIN10_TORSION_COMPONENTS


def test_chignolin_training_frames_are_unchanged():
    cell = Cell.load("chignolin.train.512", SEED, torch.device("cpu"))
    frames = training_frames(cell)
    assert hashlib.sha256(frames.tobytes()).hexdigest() == CHIGNOLIN_FRAMES_SHA256
    before = synthetic.chain_dataset(cell.traffic["frames"], synthetic.CHAIN10_TORSION_COMPONENTS,
                                     seed=cell.seed_for("frames"))
    np.testing.assert_array_equal(frames, before)


@pytest.mark.parametrize("beads", [20, 35, 56])
def test_another_bead_count_gives_the_programs_chain_of_that_length(beads):
    from twoforone_torch.data.synthetic import make_chain_components

    got = synthetic.chain_components(beads)
    assert got == make_chain_components(beads - 3, n_slow=5, seed=13) and len(got) == beads - 3
    frames = synthetic.chain_dataset(64, got, seed=3)
    assert frames.shape == (64, beads, 3) and frames.dtype == np.float32


def test_a_training_cell_at_56_beads_runs_and_is_correct(tiny_bench):
    """A configuration added as a data file: chignolin's training settings
    at 56 beads, narrowed to a CPU's widths (nf 16, one layer), under
    chignolin.train.512's tiny traffic and limits."""
    config = files.config("chignolin", tiny_bench)
    config.update(name="proteing_cpu", mol="protein_g", n_beads=56, hidden_nf=16, n_layers=1)
    with open(os.path.join(tiny_bench, "configs", "proteing_cpu.json"), "w") as f:
        json.dump(config, f)
    limits = files.workload("chignolin.train.512", tiny_bench)["limits"]
    with open(os.path.join(tiny_bench, "workloads", "proteing_cpu.train.512.json"), "w") as f:
        json.dump({"config": "proteing_cpu", "traffic": "train.512", "limits": limits}, f)
    spec = files.benchmark_json()
    spec["workloads"].append({"name": "proteing_cpu.train.512", "config": "proteing_cpu",
                              "traffic": "train.512", "chips": 1, "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] == "train_steps_per_s":
            m["workloads"].append("proteing_cpu.train.512")
    result = runner.run("proteing_cpu.train.512", SEED, 0.2, False, torch.device("cpu"),
                        time.time(), spec=spec, bench=tiny_bench)
    assert result["correct"] is True, result["checks"]
    assert {"train_steps_per_s", "setup_s"} == set(result["metrics"])
