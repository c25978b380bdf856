"""Share of the traced training chunk in which no device operation ran."""

from benchmark.harness.readers import idle


def read(run):
    return idle(run, "train")
