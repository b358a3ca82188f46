"""Simulations (grid rows that finished) per second of the window, in a
cell of a static scheduler (device-bound)."""
from perfbench.readers import sims_per_s


def read(run):
    return sims_per_s(run)
