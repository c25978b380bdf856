"""Cooperative preemption at resumable boundaries (copy of
``twoforone_tpu/utils/preempt.py``).

A launcher that shares the card with a measurement exports
``TWOFORONE_PREEMPT_FLAG``, the path of a flag file that the measurement
touches while it waits. Long-running work calls :func:`exit_if_preempted`
only where everything done so far is persisted (a training milestone just
saved), and exits with :data:`EXIT_PREEMPTED` (75, ``EX_TEMPFAIL``) while
the flag exists; the launcher resumes it afterwards. With the variable unset
nothing is ever preempted.
"""

from __future__ import annotations

import os

#: ``EX_TEMPFAIL``: the attempt is healthy and resumable; relaunch when the
#: flag clears.
EXIT_PREEMPTED = 75


def flag_path() -> str:
    """The flag file path, or "" when not under such a launcher."""
    return os.environ.get("TWOFORONE_PREEMPT_FLAG", "")


def preempt_requested() -> bool:
    """True when the flag file exists."""
    p = flag_path()
    return bool(p) and os.path.exists(p)


def exit_if_preempted(context: str) -> None:
    """Exit with :data:`EXIT_PREEMPTED` if the flag is set.

    Callers invoke this only at boundaries where all completed work is
    already persisted, so the resume loses nothing.
    """
    if preempt_requested():
        print(
            f"preemption flag set: yielding the card at {context} "
            f"(rc={EXIT_PREEMPTED}; resume is lossless)",
            flush=True,
        )
        raise SystemExit(EXIT_PREEMPTED)
