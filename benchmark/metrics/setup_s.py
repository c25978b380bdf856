"""Set-up time: the process's start to the first timed unit (imports, weights,
kernel libraries from the build cache, graph capture, warm-up)."""

def read(run):
    return run.setup_s
