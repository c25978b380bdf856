"""ms a Langevin step of device idle under the copies to the host: the
``langevin.state`` and ``langevin.frames`` spans."""

from benchmark.harness.spans import idle_ms


def read(run):
    return idle_ms(run, "langevin", ["langevin.state", "langevin.frames"], "steps")
