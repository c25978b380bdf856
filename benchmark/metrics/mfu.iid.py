"""Share of the FP32 peak that a sampling window's score products reached."""

def read(run):
    return run.mfu("iid")
