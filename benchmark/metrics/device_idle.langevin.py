"""Share of the traced Langevin units in which no device operation ran."""

from benchmark.harness.readers import idle


def read(run):
    return idle(run, "langevin")
