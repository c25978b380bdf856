"""Device kernels per Langevin step in the traced units, in the plain
network's cells (``kernels_per_step.langevin`` there)."""

from benchmark.harness.readers import kernels_per


def read(run):
    return kernels_per(run, "langevin", "steps")
