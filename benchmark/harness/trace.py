"""Reduction of a ``torch.profiler`` trace to what the per-layer metrics
read: device operations by name, the busy time (the union of every device
operation's interval), kernel counts, and the idle gaps between device
operations, each named by what the host was doing during it.
"""

from __future__ import annotations

import heapq
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch


@dataclass
class Trace:
    window_s: float  # host clock over the traced units
    busy_s: float  # union of the device operations' intervals
    op_seconds: dict = field(default_factory=dict)  # device op name -> seconds
    op_counts: dict = field(default_factory=dict)
    idle_by_host: dict = field(default_factory=dict)  # host op -> idle seconds

    def seconds(self, *fragments) -> float:
        """Device seconds of the operations whose name holds any of ``fragments``."""
        return sum(s for name, s in self.op_seconds.items() if any(f in name for f in fragments))

    def count(self, *fragments) -> int:
        return sum(c for name, c in self.op_counts.items() if any(f in name for f in fragments))

    @property
    def kernels(self) -> int:
        """Device kernels: every device operation but copies and fills."""
        return sum(c for name, c in self.op_counts.items()
                   if not name.startswith(("Memcpy", "Memset")))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.op_seconds.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n[:160], s] for n, s in gaps]}


def _device(ev) -> bool:
    if ev.device_type() != torch.autograd.DeviceType.CUDA:
        return False
    return not (getattr(ev, "is_user_annotation", lambda: False)())


def traced(unit) -> Trace:
    """Run one ``unit()`` under the profiler (host and device) and reduce
    the trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        torch.cuda.synchronize() if torch.cuda.is_available() else None
        t0 = time.perf_counter()
        unit()
        torch.cuda.synchronize() if torch.cuda.is_available() else None
        window_s = time.perf_counter() - t0
    return reduce(prof.profiler.kineto_results.events(), window_s)


def reduce(events, window_s: float) -> Trace:
    dev, host = [], []
    op_seconds, op_counts = defaultdict(float), defaultdict(int)
    for ev in events:
        start, dur = ev.start_ns(), ev.duration_ns()
        if _device(ev):
            dev.append((start, start + dur))
            op_seconds[ev.name()] += dur * 1e-9
            op_counts[ev.name()] += 1
        elif ev.device_type() == torch.autograd.DeviceType.CPU and dur > 0:
            host.append((start, start + dur, ev.name()))
    dev.sort()
    busy, gaps = 0, []
    cur_s = cur_e = None
    for s, e in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    # Each gap is named by the outermost (longest) host operation running at
    # its middle: one sweep over the gaps and the host operations in time
    # order, the running operations in a heap by length.
    idle = defaultdict(float)
    host.sort()
    running, i = [], 0
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        while i < len(host) and host[i][0] <= mid:
            s, e, name = host[i]
            heapq.heappush(running, (s - e, e, name))
            i += 1
        while running and running[0][1] < mid:
            heapq.heappop(running)
        name = running[0][2] if running else "host (no operation traced)"
        idle[name] += (g1 - g0) * 1e-9
    return Trace(window_s=window_s, busy_s=busy * 1e-9, op_seconds=dict(op_seconds),
                 op_counts=dict(op_counts), idle_by_host=dict(idle))
