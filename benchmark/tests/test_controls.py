"""The controls that each cell's check must fail, on the card at the cell's
own size: the reference put in the program's place and computed in TF32
(the nearest precision below the configuration's float32 with TF32 off;
against the float64 reference where the driver's runs in float64),
and for training the reference with half of each batch left out. The
program's own reading comes from the same set-up, so one process gives
both readings of a seed.

On the card: ``python -m pytest benchmark/tests/test_controls.py -m cuda``
(minutes: the reference follows the cells at full size). ``python -m
benchmark.tests.test_controls CELL SEED...`` prints the readings.
"""

from __future__ import annotations

import contextlib
import json
import sys

import pytest
import torch

from benchmark.harness import files
from benchmark.harness.cell import Cell
from benchmark.harness.compare import widest

from .conftest import card_or_skip, cells, kind

SEEDS = (2_147_483_659, 2_147_483_693, 3_000_000_037)


@contextlib.contextmanager
def tf32():
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def readings(cell_name: str, seed: int, device) -> dict:
    """``{"program": {number: value}, "control": {...}[, "half_batch": {...}]}``
    for one seed: the program's set-up and one timed unit, then the
    reference at float32, in TF32, and (training) on half of each batch."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cell = Cell.load(cell_name, seed, device)
    driver = files.driver(cell.traffic["driver"])(cell)
    driver.unit()
    driver.window_units = 1
    driver.release()
    if kind(cell_name) == "train":
        got, ref = driver.answer(), driver.reference()
        with tf32():
            control = driver.reference()
        half = driver.reference(keep=slice(0, driver.batch // 2))
        return {"program": driver.readings(got, ref), "control": driver.readings(control, ref),
                "half_batch": driver.readings(half, ref)}
    ks = driver.compared()
    refs = driver.references(ks)
    with tf32():
        lows = driver.references(ks, torch.float32)
    program = [driver.numbers(driver.answer(k), ref) for k, ref in zip(ks, refs)]
    control = [driver.numbers(low, ref) for low, ref in zip(lows, refs)]
    return {"program": worst(program), "control": worst(control)}


def worst(values: list) -> dict:
    return {k: widest(v[k] for v in values) for k in values[0]}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", cells())
def test_the_control_fails_the_check(cell):
    device = card_or_skip()
    limits = files.workload(cell)["limits"]
    for seed in SEEDS:
        r = readings(cell, seed, device)
        assert all(v <= limits[k] for k, v in r["program"].items()), (seed, r)
        for control in [v for k, v in r.items() if k != "program"]:
            assert any(v > limits[k] for k, v in control.items()), (seed, r)


if __name__ == "__main__":
    dev = torch.device("cuda", 0)
    for s in sys.argv[2:]:
        r = readings(sys.argv[1], int(s), dev)
        print(json.dumps({"cell": sys.argv[1], "seed": int(s), **r}), flush=True)
