"""Whole i.i.d. samples returned per second over the window."""

def read(run):
    return run.rate("samples")
