"""Langevin steps times chains completed per second over the window, in the
cells whose force is the plain network (``chain_steps_per_s`` there, under
a bound of its own: their runs spread more than the fused kernels' do)."""

def read(run):
    return run.rate("chain_steps")
