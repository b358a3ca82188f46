"""K1's share (%) of its roofline over one profiled cycle of grid calls:
the bytes bound of every launch (each launch's R, F, W; inputs read
once, output written once) at 3.35 TB/s over K1's device time."""
from perfbench.readers import k1_roofline


def read(run):
    return k1_roofline(run)
