"""Greedy's placement kernel's share (%) of its bytes bound over one
profiled cycle of grid calls, at 3.35 TB/s over its device time; the
bytes a lower bound (the placing tasks counted as the placer's loop
length, the edges and objects they read not at all)."""
from perfbench.readers import place_roofline


def read(run):
    return place_roofline(run)
