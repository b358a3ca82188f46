"""Share of the event loop's time the host spends in its reads of "any
row live", each waiting for the steps queued before it: the program's
summed ``poll`` span over its ``loop`` spans."""
from perfbench.spans import poll_wait_share


def read(run):
    return poll_wait_share(run)
