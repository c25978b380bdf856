"""Wall time per score call of the window minus K1's traced device time per
call: what the sampler loop adds around the kernel."""

from benchmark.harness.readers import sampler_overhead_ms


def read(run):
    return sampler_overhead_ms(run)
