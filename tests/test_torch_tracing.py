"""The port's spans and graph-capture counters
(``twoforone_torch/utils/profiling.py``: ``annotate``, ``SPANS``;
``twoforone_torch/utils/cuda_graph.py``: ``StepGraphs.captures`` and
``capture_s``), on the CPU.

- With no profiler recording, ``annotate`` returns one shared no-op and
  calls no ``record_function``; under ``torch.profiler`` it records a host
  event of its name.
- Each span of ``SPANS`` shows in a CPU profile of its path as often as the
  path opens it: the trainer's four once a step (eager, and graphed through
  the stand-in of ``test_torch_graph_capture.py``), the Langevin loop's
  ``langevin.step`` once a step, ``langevin.frames`` once a chunk and
  ``langevin.state`` once a read. The device work a graph records
  (``Trainer._gradients``, ``Trainer._update_work``) opens none: a span there
  would run at the capture alone.
- The first call of a graph key adds one capture and its seconds to the
  process-wide counters; replays add nothing.
"""

import ast
import os
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from test_torch_graph_capture import StandInGraphs, one_torch_thread  # noqa: F401 (autouse)
from test_torch_graph_train import _batches, _trainer
from twoforone_torch.dynamics.integrators import LangevinSimulation
from twoforone_torch.utils import profiling
from twoforone_torch.utils.cuda_graph import StepGraphs
from twoforone_torch.utils.profiling import SPANS, annotate

TRAINER_SPANS = ("trainer.batch", "trainer.draws", "trainer.gradients", "trainer.update")


def spans(prof) -> Counter:
    """How often each program span was opened in a profile's host events."""
    return Counter(ev.name() for ev in prof.profiler.kineto_results.events()
                   if ev.device_type() == torch.autograd.DeviceType.CPU
                   and ev.is_user_annotation() and ev.name() in SPANS)


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_every_span_is_documented_and_every_call_site_names_one():
    assert set(SPANS) == {"langevin.step", "langevin.frames", "langevin.state", *TRAINER_SPANS}
    assert all(isinstance(v, str) and v for v in SPANS.values())
    package = os.path.dirname(os.path.dirname(profiling.__file__))
    named = []
    for folder, _, names in os.walk(package):
        for name in names:
            if name.endswith(".py"):
                with open(os.path.join(folder, name)) as f:
                    tree = ast.parse(f.read())
                named += [node.args[0].value for node in ast.walk(tree)
                          if isinstance(node, ast.Call)
                          and getattr(node.func, "id", None) == "annotate"
                          and isinstance(node.args[0], ast.Constant)]
    assert sorted(set(named)) == sorted(SPANS) and len(named) == len(SPANS)


def test_annotate_outside_a_profiler_is_the_shared_no_op(monkeypatch):
    def refused(name):
        raise AssertionError("record_function called with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    first, second = annotate("langevin.step"), annotate("trainer.update")
    assert first is second is profiling._NO_SPAN
    with first:
        torch.ones(2).sum()
    with cpu_profile() as prof:
        pass
    assert spans(prof) == Counter()


def test_annotate_in_a_profiler_records_a_host_event_of_its_name():
    with cpu_profile() as prof:
        assert annotate("trainer.draws") is not profiling._NO_SPAN
        with annotate("trainer.draws"):
            torch.ones(8).sum()
    assert spans(prof) == Counter({"trainer.draws": 1})
    # The span encloses the operations issued inside it.
    events = {ev.name(): ev for ev in prof.profiler.kineto_results.events()}
    span, op = events["trainer.draws"], events["aten::sum"]
    assert span.start_ns() <= op.start_ns()
    assert op.start_ns() + op.duration_ns() <= span.start_ns() + span.duration_ns()


@pytest.mark.parametrize("graphed", [False, True])
def test_a_training_chunk_opens_each_trainer_span_once_a_step(tmp_path, graphed):
    trainer = _trainer(tmp_path)
    trainer._step_graphs = StandInGraphs() if graphed else None
    batches = np.stack(_batches(trainer, 3))
    gen = torch.Generator().manual_seed(5)
    trainer._train_chunk(batches[:1], gen)  # the stand-in captures at its first step
    with cpu_profile() as prof:
        trainer._train_chunk(batches[1:], gen)
    assert spans(prof) == Counter({name: 2 for name in TRAINER_SPANS})


def test_the_work_a_graph_records_opens_no_span(tmp_path):
    trainer = _trainer(tmp_path)
    batch = torch.as_tensor(_batches(trainer, 1)[0])[None]
    drawn = [trainer._draws(torch.Generator().manual_seed(1), batch.shape[1], True)]
    params = list(trainer.net.parameters())
    grads = [torch.zeros_like(p) for p in params]
    loss, kl = torch.zeros(()), torch.zeros(())
    with cpu_profile() as prof:
        trainer._gradients(grads, loss, kl, batch, drawn)
        for p, g in zip(params, grads):
            p.grad = g
        trainer.optimizer.advance()
        trainer._update_work(kl, True, trainer.optimizer.apply)
    assert spans(prof) == Counter()


def _simulation(length):
    def harmonic(x):
        return 0.5 * (x ** 2).sum(dim=(1, 2)), -x

    start = np.random.default_rng(0).standard_normal((3, 4, 3)).astype(np.float32)
    return LangevinSimulation(force_fn=harmonic, initial_coordinates=start, dt=1e-3,
                              friction=1.0, masses=[1.0] * 4, length=length,
                              save_interval=2, random_seed=1, device="cpu")


def test_a_langevin_call_opens_a_step_span_a_step_and_one_for_the_copies():
    sim = _simulation(length=4)
    sim.simulate(sub_interval=2)
    with cpu_profile() as prof:
        frames = sim.simulate(sub_interval=2)
        state = sim.state
    assert frames.shape == (3, 1, 4, 3) and state["t"] == 4
    assert spans(prof) == Counter({"langevin.step": 2, "langevin.frames": 1,
                                   "langevin.state": 1})


@pytest.fixture
def capture_counters():
    before = StepGraphs.captures, StepGraphs.capture_s
    yield
    StepGraphs.captures, StepGraphs.capture_s = before


def test_a_first_call_of_a_key_counts_one_capture_and_its_seconds(capture_counters):
    graphs = StandInGraphs()
    x = torch.arange(4.0)
    counts, seconds = StepGraphs.captures, StepGraphs.capture_s
    graphs("a", lambda: x * 2)
    assert StepGraphs.captures == counts + 1 and StepGraphs.capture_s > seconds
    after_a = StepGraphs.capture_s
    for _ in range(3):  # replays count nothing
        graphs("a", lambda: x * 2)
    assert (StepGraphs.captures, StepGraphs.capture_s) == (counts + 1, after_a)
    graphs("b", lambda: x * 3)  # a new key is captured again
    assert StepGraphs.captures == counts + 2 and StepGraphs.capture_s > after_a
    # Process-wide: a second object adds to the same counters.
    StandInGraphs()("a", lambda: x * 2)
    assert StepGraphs.captures == counts + 3
