"""The training batch's staging ring (``twoforone_torch/train/trainer.py``:
``StagingRing``, and ``Trainer._train_step`` on the card).

On the card a graphed step writes its host batch into a pinned slot of a
small ring and copies the slot into the gradient graph's static buffer
without a synchronisation; a slot is written again only once the event
recorded after its copy reports done. Here fake events take the CUDA
events' place: a recorded copy stays in flight until ``synchronize()``
(or is done at once), a slot rewritten while its copy is in flight fails
the test, and so does an event recorded again before its copy was waited
for. The ring's slots rotate per shape and dtype, the counters count each
batch and each wait, and what reaches the target is the caller's batch even
when the caller overwrites its array as soon as the call returns. Through
the CPU stand-in of the CUDA graphs the trainer's staged step keeps the
eager step's bits, alone and on each of two gloo ranks (this file runs as
a script for them: ``python tests/test_torch_staging.py CASE RANK WORLD
PORT FOLDER``). The ``cuda`` test needs the card (``python -m pytest
tests/test_torch_staging.py -m cuda --noconftest``): twenty graphed steps,
none of the steady ones synchronising the stream, bit for bit the eager
steps.
"""

import os
import socket
import subprocess
import sys
import time
from datetime import timedelta

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from test_torch_graph_capture import StandInGraphs, one_torch_thread  # noqa: F401 (autouse)
from test_torch_graph_train import (BATCH, CASES, RANK_TIMEOUT, REPO, _batches, _same, _state,
                                    _steps, _trainer)
from twoforone_torch.parallel.mesh import get_mesh, initialize_distributed, local_rows
from twoforone_torch.train.trainer import STAGING_DEPTH, StagingRing

N = 10


class FakeEvent:
    """A slot's event. ``record`` starts a copy from the slot, in flight
    until ``synchronize`` unless ``ready``; the test hands the event its
    slot and what the copy read (:func:`watch`), and completing the copy
    checks that the slot still holds it."""

    def __init__(self, ready: bool):
        self.ready, self.in_flight = ready, False
        self.slot = self.read = None
        self.records = self.syncs = 0

    def record(self, stream=None):
        assert stream is None  # a CPU target: no stream
        assert not self.in_flight, "a slot was reused while its copy was in flight"
        self.records += 1
        self.in_flight, self.read = not self.ready, None

    def query(self) -> bool:
        return not self.in_flight

    def synchronize(self):
        assert self.read is not None and torch.equal(self.slot, self.read), \
            "a slot was rewritten while its copy was in flight"
        self.syncs += 1
        self.in_flight = False


class Copies(TorchDispatchMode):
    """Each ``copy_`` run inside: (destination, source, non_blocking)."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten.copy_.default:
            non_blocking = kwargs.get("non_blocking", args[2] if len(args) > 2 else False)
            self.made.append((args[0].data_ptr(), args[1].data_ptr(), non_blocking))
        return func(*args, **kwargs)


def watch(ring):
    """Give each event just recorded its slot and what its copy read."""
    for slots in ring.slots.values():
        for host, event in slots:
            if event.in_flight and event.read is None:
                event.slot, event.read = host, host.clone()


@pytest.fixture
def counters(monkeypatch):
    monkeypatch.setattr(StagingRing, "staged", 0)
    monkeypatch.setattr(StagingRing, "waits", 0)


@pytest.mark.parametrize("ready", [False, True])
def test_slots_rotate_and_are_rewritten_only_after_their_copy(counters, ready):
    """Batches of one step (B, N, 3) into a (1, B, N, 3) target and of two
    micro-batches (2, B, N, 3), interleaved: each shape has its own ring,
    call j of a shape writes slot j % STAGING_DEPTH, every batch reaches its
    target although the caller overwrites its array at once, a slot is
    written again only after its copy completes, the target is copied from
    the slot without blocking, and ``waits`` counts each reuse that found
    the copy in flight (none where copies are done at once)."""
    events = []

    def event():
        events.append(FakeEvent(ready))
        return events[-1]

    depth = STAGING_DEPTH
    ring = StagingRing(event=event)
    rng = np.random.default_rng(depth)
    targets = {1: torch.zeros(1, 4, N, 3), 2: torch.zeros(2, 4, N, 3)}
    calls = {1: 0, 2: 0}
    n = 4 * depth + 1
    for j in range(n):
        accum = 1 + j % 2
        batch = rng.normal(size=(4, N, 3) if accum == 1 else (2, 4, N, 3))  # float64
        want = torch.as_tensor(batch, dtype=torch.float32).reshape(accum, 4, N, 3)
        out = targets[accum]
        with Copies() as copies:
            assert ring(batch, out) is out
        watch(ring)
        batch[...] = np.nan  # the caller reuses its array
        assert torch.equal(out, want)
        host, ev = ring.slots[(tuple(out.shape), torch.float32)][calls[accum] % depth]
        assert torch.equal(host, want) and ev.records == calls[accum] // depth + 1
        assert [c for c in copies.made if c[0] == out.data_ptr()] == [
            (out.data_ptr(), host.data_ptr(), True)]
        calls[accum] += 1
    assert sorted(ring.slots) == [((1, 4, N, 3), torch.float32), ((2, 4, N, 3), torch.float32)]
    assert all(len(s) == depth for s in ring.slots.values()) and len(events) == 2 * depth
    assert not any(host.is_pinned() for s in ring.slots.values() for host, _ in s)
    reuses = sum(max(0, c - depth) for c in calls.values())
    assert StagingRing.staged == n
    assert StagingRing.waits == sum(e.syncs for e in events) == (0 if ready else reuses)


def _eager_and_staged(folder, case, mesh=None):
    """Eight steps of this rank's rows, eagerly and graphed through the
    stand-in with the batch staged through a ring whose copies stay in
    flight until waited for, the caller's arrays overwritten after each
    call: both steps' metrics and states, the counters, the ring's keys and
    the graphs' keys."""
    accum = CASES[case].get("accum", 1)
    overrides = {k: v for k, v in CASES[case].items() if k != "accum"}
    eager = _trainer(os.path.join(folder, "e"), mesh=mesh, **overrides)
    staged = _trainer(os.path.join(folder, "s"), mesh=mesh, **overrides)
    batches = _batches(eager, 8, accum, rows=local_rows(BATCH, mesh))
    events = []
    staged._staging = StagingRing(event=lambda: events.append(FakeEvent(False)) or events[-1])
    staged._step_graphs = StandInGraphs()
    gen = torch.Generator().manual_seed(5)
    m_s = []
    for b in batches:
        mine = b.copy()
        m_s.append({k: v.cpu() for k, v in staged._train_step(mine, gen).items()})
        watch(staged._staging)
        mine[...] = np.nan
    return {"eager": _steps(eager, batches), "staged": (m_s, _state(staged, gen)),
            "counters": (StagingRing.staged, StagingRing.waits),
            "slots": list(staged._staging.slots), "graphs": list(staged._step_graphs.graphs)}


def _rank_main(case, rank, world, port, folder):
    """One gloo rank of :func:`_eager_and_staged`, saved for the test."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu",
                           timeout=timedelta(seconds=60))
    out = _eager_and_staged(os.path.join(folder, f"r{rank}"), case, get_mesh("cpu"))
    torch.save(out, os.path.join(folder, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _on_ranks(case, world, folder):
    """:func:`_eager_and_staged` on ``world`` gloo ranks; each rank's result."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs, logs = [], []
    for r in range(world):
        logs.append(folder / f"rank{r}.log")
        with open(logs[-1], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), case, str(r), str(world), str(port),
                 str(folder)], cwd=REPO, env=env, stdout=f, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + RANK_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log.read_text()[-4000:]
    return [torch.load(folder / f"rank{r}.pt") for r in range(world)]


@pytest.mark.parametrize("ranks", [1, 2])
@pytest.mark.parametrize("case", ["float32", "accumulate_2"])
def test_staged_graphed_steps_equal_eager_steps(tmp_path, counters, case, ranks):
    """Eight staged steps through the stand-in graphs, alone or on each of
    two gloo ranks (the mesh's collectives between the captured halves):
    every metric and the whole state bit for bit those of the eager steps
    on the same batches, six waits for eight batches through two slots, one
    ring and one gradient graph for the rank's batch shape; both ranks hold
    the same weights."""
    got = ([_eager_and_staged(tmp_path, case)] if ranks == 1
           else _on_ranks(case, ranks, tmp_path))
    shape = (CASES[case].get("accum", 1), BATCH // ranks, N, 3)
    for res in got:
        assert _same(res["staged"], res["eager"])
        assert res["counters"] == (8, 6)
        assert res["slots"] == [(shape, torch.float32)]
        assert ("gradients", shape) in res["graphs"]
    assert all(_same(res["staged"][1]["weights"], got[0]["staged"][1]["weights"])
               for res in got)


def test_a_cpu_trainer_keeps_the_pageable_copy(tmp_path):
    """The ring is the card's: a CPU trainer has none and keeps
    ``shard_batch``'s copy."""
    assert _trainer(tmp_path)._staging is None


# --------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and pinned memory)")
    return torch.device("cuda")


STEADY_FROM = 4  # every graph key captured and every slot used once by then


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_staged_steps_do_not_synchronise_and_equal_eager_on_the_card(
        tmp_path, cuda_device, counters, case):
    """Twenty graphed steps on the card, the steady ones under
    ``torch.cuda.set_sync_debug_mode("error")`` (a synchronising call
    raises), the caller's arrays overwritten after each call: each step's
    metrics, the gradients, the weights, Adam's moments and the EMA bit for
    bit those of the eager steps on the same batches and draws."""
    accum = CASES[case].get("accum", 1)
    overrides = {k: v for k, v in CASES[case].items() if k != "accum"}
    eager = _trainer(tmp_path / "e", cuda_device, **overrides)
    graphed = _trainer(tmp_path / "g", cuda_device, **overrides)
    batches = _batches(eager, 20, accum)
    m_e, s_e = _steps(eager, batches)
    gen = torch.Generator(cuda_device).manual_seed(5)
    m_g = []
    for k, b in enumerate(batches):
        mine = b.copy()
        torch.cuda.set_sync_debug_mode("error" if k >= STEADY_FROM else "default")
        try:
            m_g.append(graphed._train_step(mine, gen))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        mine[...] = np.nan
    assert _same([{k: v.cpu() for k, v in m.items()} for m in m_g], m_e)
    assert _same(_state(graphed, gen), s_e)
    assert StagingRing.staged == 20 and len(graphed._step_graphs.graphs) == 3
    host = [h for s in graphed._staging.slots.values() for h, _ in s]
    assert len(host) == 2 and all(h.is_pinned() for h in host)


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
