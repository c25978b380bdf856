"""Device kernels per training step in the traced chunk."""

from benchmark.harness.readers import kernels_per


def read(run):
    return kernels_per(run, "train", "train_steps")
