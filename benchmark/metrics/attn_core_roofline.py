"""K2 and K3's share of their byte bound in the traced units."""

from benchmark.harness.readers import attn_core_roofline


def read(run):
    return attn_core_roofline(run)
