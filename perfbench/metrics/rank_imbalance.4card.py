"""Over the window's grid calls, the slowest rank's event loop (its
``drive`` span) over the ranks' mean, from each rank's spans gathered
after the window: 1.0 when no rank waits on another at the gather."""
from perfbench.readers import rank_imbalance


def read(run):
    return rank_imbalance(run)
