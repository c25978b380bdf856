"""ms a Langevin step of device idle under the copies to the host (the
``langevin.state`` and ``langevin.frames`` spans), in the plain network's
cells (``langevin_idle_ms.copies`` there)."""

from benchmark.harness.spans import idle_ms


def read(run):
    return idle_ms(run, "langevin", ["langevin.state", "langevin.frames"], "steps")
