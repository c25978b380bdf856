"""Share of the FP32 peak that a Langevin window's force products reached,
in the plain network's cells (``mfu.langevin`` there)."""

def read(run):
    return run.mfu("langevin")
