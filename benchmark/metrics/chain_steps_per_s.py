"""Langevin steps times chains completed per second over the window."""

def read(run):
    return run.rate("chain_steps")
