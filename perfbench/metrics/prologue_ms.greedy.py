"""Greedy's eager prologue (due assignments, the scheduler invocation
and its placer, run before each replay) a replayed step: the
program's summed ``prologue`` span over its replays."""
from perfbench.spans import prologue_ms


def read(run):
    return prologue_ms(run)
