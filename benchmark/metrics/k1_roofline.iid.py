"""K1's share of its roofline in the traced sampling batch."""

from benchmark.harness.readers import k1_roofline


def read(run):
    return k1_roofline(run, "iid")
