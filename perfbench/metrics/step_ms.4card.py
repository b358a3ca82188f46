"""Rank 0's grid call wall time (the runner's call: its block's
simulator call, the split and the gather) over its event-loop steps
(eager first steps plus replays, ``capture_counter``)."""
from perfbench.readers import ms_per_step


def read(run):
    return ms_per_step(run, "grid", "run_s")
