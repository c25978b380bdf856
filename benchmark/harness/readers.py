"""Arithmetic shared by the per-layer metric readers of ``metrics/``. Each
returns None where its run has nothing to read: no trace, another driver
kind, or no launch of the kernel it times."""

from __future__ import annotations

from . import yardstick

K1 = "fused_force_cl_kernel"
K2 = "cl_attention_fwd_kernel"
K3 = "cl_attention_bwd_kernel"


def _kind(run, kind: str) -> bool:
    """Whether ``run`` traced the device (a CPU run has no device trace) and
    drives ``kind``."""
    return run.trace is not None and bool(run.trace.op_counts) \
        and run.cell.traffic["driver"] == kind


def idle(run, kind: str):
    """Percent of the traced window in which no device operation ran."""
    if not _kind(run, kind):
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def kernels_per(run, kind: str, work: str):
    """Device kernels in the traced units per unit of ``work``."""
    if not _kind(run, kind):
        return None
    return run.trace.kernels / run.traced_per(work)


def _sizes(run):
    c = run.cell.config
    return c["n_beads"], c["hidden_nf"], c["n_layers"], run.driver.batch


def k1_roofline(run, kind: str):
    """Percent: K1's least time a call (operations at the FP32 peak, or
    coordinates, forces and weights once at the memory rate) over its traced
    device time a call."""
    if not _kind(run, kind) or not run.trace.count(K1):
        return None
    n, c, layers, batch = _sizes(run)
    least = yardstick.bound_s(yardstick.fused_force_flops(n, c, layers, batch),
                              yardstick.force_call_bytes(n, c, layers, batch))
    return 100.0 * least * run.trace.count(K1) / run.trace.seconds(K1)


def attn_core_roofline(run):
    """Percent: the attention core's least time (K2 and K3, each at the
    larger of its operation and byte bounds) over their traced device time."""
    if run.trace is None or not run.trace.count(K2, K3):
        return None
    n, _, _, batch = _sizes(run)
    fwd, bwd = yardstick.core_work(batch, n)
    least = (yardstick.bound_s(*fwd) * run.trace.count(K2)
             + yardstick.bound_s(*bwd) * run.trace.count(K3))
    return 100.0 * least / run.trace.seconds(K2, K3)


def sampler_overhead_ms(run):
    """ms a score call of the window takes beyond K1's traced device time a
    call."""
    if not _kind(run, "iid") or not run.trace.count(K1):
        return None
    wall = run.window_s / (run.units * run.driver.work["score_calls"])
    return 1e3 * (wall - run.trace.seconds(K1) / run.trace.count(K1))
