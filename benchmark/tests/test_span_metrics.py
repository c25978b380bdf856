"""The per-layer metrics that read the program's spans and capture counter
(``harness/spans.py``, ``metrics/train_idle_ms.*``,
``metrics/langevin_idle_ms.*``, ``metrics/setup_capture_s``), over
synthetic kineto-like events: the reducer names an idle gap by the span
that encloses the host's operations at its middle, and each reader gives
that idle time per unit of work, or None where there is nothing to read."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import files
from benchmark.harness.runner import Run
from benchmark.harness.trace import reduce

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
MS = 1_000_000  # ns


class Event:
    def __init__(self, name, start_ms, end_ms, device=CPU, annotation=False):
        self._name, self._device, self._annotation = name, device, annotation
        self._start, self._dur = int(start_ms * MS), int((end_ms - start_ms) * MS)

    def name(self):
        return self._name

    def device_type(self):
        return self._device

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def is_user_annotation(self):
        return self._annotation


def span(name, start, end):
    return Event(name, start, end, annotation=True)


def kernel(start, end):
    return Event("kernel", start, end, device=CUDA)


def phases(names):
    """Each named span in turn, 10 ms long, with an aten op inside; the
    device runs 4 ms at the start of each and is idle for the other 6 ms
    (a gap in the span's second half), except for the last span."""
    events = []
    for i, name in enumerate(names):
        t = 10 * i
        events += [span(name, t, t + 10), Event("aten::to", t + 5, t + 9), kernel(t, t + 4)]
    return events + [kernel(10 * len(names), 10 * len(names) + 1)]


def test_a_gap_is_named_by_the_span_enclosing_the_host_operation():
    trace = reduce(phases(["trainer.batch", "trainer.draws"]) + [
        # a GPU-side annotation is not a device operation
        Event("trainer.batch", 0, 4, device=CUDA, annotation=True)], window_s=0.021)
    assert trace.idle_by_host == pytest.approx({"trainer.batch": 6e-3, "trainer.draws": 6e-3})
    assert trace.busy_s == pytest.approx(9e-3) and trace.kernels == 3


def test_without_a_span_the_gap_keeps_the_host_operations_name():
    trace = reduce([Event("aten::to", 5, 9), kernel(0, 4), kernel(10, 11)], window_s=0.011)
    assert trace.idle_by_host == pytest.approx({"aten::to": 6e-3})


TRAIN = ["trainer.batch", "trainer.draws", "trainer.gradients", "trainer.update"]
LANGEVIN = ["langevin.state", "langevin.step", "langevin.frames"]


def run_of(kind, events, work, device="cuda"):
    cell = SimpleNamespace(traffic={"driver": kind}, device=torch.device(device))
    driver = SimpleNamespace(work=work)
    trace = None if events is None else reduce(events, window_s=0.05)
    return Run(cell, driver, setup_s=1.0, window_s=1.0, units=1, trace=trace)


def read(metric, run):
    return files.metric(metric)(run)


def test_the_trainers_readers_give_each_spans_idle_ms_a_step():
    run = run_of("train", phases(TRAIN * 2), {"train_steps": 2})
    for name in TRAIN:
        assert read(f"train_idle_ms.{name.split('.')[1]}", run) == pytest.approx(6.0)


def test_the_langevin_readers_give_idle_ms_a_step():
    run = run_of("langevin", phases(LANGEVIN + ["langevin.step"]), {"steps": 3})
    assert read("langevin_idle_ms.step", run) == pytest.approx(12.0 / 3)
    assert read("langevin_idle_ms.copies", run) == pytest.approx(12.0 / 3)


@pytest.mark.parametrize("metric", ["train_idle_ms.batch", "train_idle_ms.draws",
                                    "train_idle_ms.gradients", "train_idle_ms.update",
                                    "langevin_idle_ms.step", "langevin_idle_ms.copies"])
def test_a_span_reader_finds_nothing_where_there_is_nothing(metric, monkeypatch):
    kind, work = (("train", {"train_steps": 2}) if metric.startswith("train")
                  else ("langevin", {"steps": 3}))
    events = phases(TRAIN + LANGEVIN)
    assert read(metric, run_of(kind, events, work)) is not None
    assert read(metric, run_of(kind, None, work)) is None  # untraced
    other = "langevin" if kind == "train" else "train"
    assert read(metric, run_of(other, events, work)) is None  # another driver kind
    assert read(metric, run_of(kind, [span("trainer.batch", 0, 1)], work)) is None  # no device
    # A program whose SPANS lacks the names (a parent without spans) reads nothing.
    from twoforone_torch.utils import profiling

    monkeypatch.setattr(profiling, "SPANS", {})
    assert read(metric, run_of(kind, events, work)) is None


def test_setup_capture_s_reads_the_capture_counter_on_the_card(monkeypatch):
    from twoforone_torch.utils.cuda_graph import StepGraphs

    monkeypatch.setattr(StepGraphs, "capture_s", 2.5)
    assert read("setup_capture_s", run_of("langevin", None, {})) == 2.5
    assert read("setup_capture_s", run_of("langevin", None, {}, device="cpu")) is None
    monkeypatch.delattr(StepGraphs, "capture_s")
    assert read("setup_capture_s", run_of("train", None, {})) is None
