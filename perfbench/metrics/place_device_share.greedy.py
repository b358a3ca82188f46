"""Greedy's placement kernel's device time over all device busy time of
one profiled cycle of grid calls: what any change to it can move at
most."""
from perfbench.readers import device_share


def read(run):
    tr = run.get("trace")
    if not tr or tr.get("gp_device_s", 0) <= 0:
        return None
    return device_share(run, "gp_device_s")
