"""Share of the FP32 peak that a training window's products reached."""

def read(run):
    return run.mfu("train")
