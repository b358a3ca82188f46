"""K1's device time over all device busy time of one profiled cycle of
grid calls: what any K1 change can move at most."""
from perfbench.readers import k1_device_share


def read(run):
    return k1_device_share(run)
