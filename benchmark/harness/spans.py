"""Device idle time by the program's own spans: the traced units' idle gaps
that the reducer (``trace.reduce``) named after a span of the program's
``SPANS`` (``twoforone_torch/utils/profiling.py``), per unit of work."""

from __future__ import annotations

from .readers import _kind


def idle_ms(run, kind: str, names, work: str):
    """ms of device idle under the spans ``names`` per unit of ``work`` in
    the traced units, or None: no device trace, another driver kind, or a
    program whose ``SPANS`` lacks one of the names (which opens no such
    span, so its gaps carry other names)."""
    try:
        from twoforone_torch.utils.profiling import SPANS
    except ImportError:
        return None
    if not _kind(run, kind) or not set(names) <= set(SPANS):
        return None
    return 1e3 * sum(run.trace.idle_by_host.get(n, 0.0) for n in names) / run.traced_per(work)
