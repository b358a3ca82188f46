"""Share of one profiled cycle of grid calls in which no operation ran
on rank 0's card (an upper bound: the profiler slows the host)."""
from perfbench.readers import device_idle


def read(run):
    return device_idle(run, "grid")
