"""Profiling and tracing (port of ``twoforone_tpu/utils/profiling.py``).

- :func:`trace`: context manager around ``torch.profiler`` that writes a
  Chrome trace (viewable in Perfetto or ``chrome://tracing``) of the
  enclosed host and device work into a directory.
- :func:`annotate`: a named span on that trace; :data:`SPANS` lists the
  spans the port's hot loops open and what each covers. With no profiler
  recording a span costs one attribute read.
- :class:`PhaseTimer`: wall-clock phase accounting; with ``sync=True`` it
  waits for the CUDA device at each phase boundary, so a phase's time is
  its execution and not its dispatch.

To see where a run's time goes, wrap any call in ``with
profiling.trace(logdir):`` (or give the trainer ``profile_steps``) and open
``logdir/trace.json`` in Perfetto: the spans of :data:`SPANS` sit on the
host's row above the operations they issued, and a gap on the device's
row lies under the span the host was in. A span never encloses another
span: each names one phase of a step, not a whole call.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch
from torch.autograd import profiler as _autograd_profiler

# The spans the port opens, each with what it covers.
SPANS = {
    "langevin.step": "one Langevin step's host work: the coefficient's index, the noise draw "
                     "into its buffer, the replay (off the card, the eager step)",
    "langevin.frames": "a chunk's saved frames (and forces, potential, kinetic energy where "
                       "kept) stacked and copied to the host",
    "langevin.state": "the simulation state's copies to the host",
    "trainer.batch": "the batch written into a pinned staging slot and copied, without a "
                     "synchronisation, into its static buffer (a wait here is the ring's bound "
                     "on running ahead); off the card, copied to the device",
    "trainer.draws": "the micro-batches' rotations, timesteps and noise drawn and copied into "
                     "their static buffers",
    "trainer.gradients": "the gradient half of a training step (replayed on the card) and a "
                         "mesh's collectives",
    "trainer.update": "the update's host numbers (learning rate, EMA decay, Adam's count) and "
                      "the update half (replayed on the card)",
}

_NO_SPAN = contextlib.nullcontext()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block (CPU activity, and CUDA activity where a
    CUDA device is present) and write ``logdir/trace.json``. Yields the
    ``torch.profiler.profile`` object, whose ``key_averages()`` sums the
    time by operator and kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named trace span (shows up in the profiler timeline). When no
    profiler is recording it is one shared no-op context, so a span in a
    hot loop costs an attribute read and no ``record_function`` call."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name)


class PhaseTimer:
    """Accumulates wall-clock per phase; ``sync=True`` waits for the CUDA
    device's work so timings reflect real execution, not dispatch."""

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        if self.sync:
            self._block()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                self._block()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    @staticmethod
    def _block():
        """Wait for the CUDA device where one is in use; nothing on the CPU."""
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name}: {total:.3f}s total, {total / n * 1e3:.2f}ms/call x{n}")
        return "\n".join(lines)
