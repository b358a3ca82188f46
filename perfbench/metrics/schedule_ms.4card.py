"""The static schedule (blevel's list schedule over rank 0's block of
rows) a runner call: its stream time between two CUDA events on the
card (the program's ``schedule`` span)."""
from perfbench.spans import schedule_ms


def read(run):
    return schedule_ms(run, "grid")
