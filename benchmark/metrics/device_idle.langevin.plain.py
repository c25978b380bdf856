"""Share of the traced Langevin units in which no device operation ran, in
the plain network's cells (``device_idle.langevin`` there)."""

from benchmark.harness.readers import idle


def read(run):
    return idle(run, "langevin")
