"""Share of the FP32 peak that a Langevin window's force products reached."""

def read(run):
    return run.mfu("langevin")
