"""ms a Langevin step of device idle under the ``langevin.step`` span, in the
plain network's cells (``langevin_idle_ms.step`` there)."""

from benchmark.harness.spans import idle_ms


def read(run):
    return idle_ms(run, "langevin", ["langevin.step"], "steps")
