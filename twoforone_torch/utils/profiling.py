"""Profiling and tracing (port of ``twoforone_tpu/utils/profiling.py``).

- :func:`trace`: context manager around ``torch.profiler`` that writes a
  Chrome trace (viewable in Perfetto or ``chrome://tracing``) of the
  enclosed host and device work into a directory.
- :func:`annotate`: a named span on that trace.
- :class:`PhaseTimer`: wall-clock phase accounting; with ``sync=True`` it
  waits for the CUDA device at each phase boundary, so a phase's time is
  its execution and not its dispatch.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


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
    """Named trace span (shows up in the profiler timeline)."""
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
