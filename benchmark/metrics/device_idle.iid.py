"""Share of the traced sampling batches in which no device operation ran."""

from benchmark.harness.readers import idle


def read(run):
    return idle(run, "iid")
