"""Simulations (grid rows that finished) per second of the window, in
the cell whose grid calls the sharded engine splits over four cards,
one process a card: rank 0's clock, the gathered results."""
from perfbench.readers import sims_per_s


def read(run):
    return sims_per_s(run)
