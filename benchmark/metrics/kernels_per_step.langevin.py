"""Device kernels per Langevin step in the traced units."""

from benchmark.harness.readers import kernels_per


def read(run):
    return kernels_per(run, "langevin", "steps")
