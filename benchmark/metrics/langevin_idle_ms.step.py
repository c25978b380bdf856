"""ms a Langevin step of device idle under the ``langevin.step`` span."""

from benchmark.harness.spans import idle_ms


def read(run):
    return idle_ms(run, "langevin", ["langevin.step"], "steps")
