"""A grid call's wall time (the runner's call) over its event-loop steps
(eager first steps plus replays, ``capture_counter``)."""
from perfbench.readers import ms_per_step


def read(run):
    return ms_per_step(run, "grid", "run_s")
