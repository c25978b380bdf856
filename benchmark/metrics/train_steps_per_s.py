"""Optimizer steps per second over the window, the host's batch draws
included."""

def read(run):
    return run.rate("train_steps")
