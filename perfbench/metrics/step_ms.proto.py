"""Request wall time over the event loop's steps (eager first steps plus
replays, ``capture_counter``)."""
from perfbench.readers import ms_per_step


def read(run):
    return ms_per_step(run, "proto")
