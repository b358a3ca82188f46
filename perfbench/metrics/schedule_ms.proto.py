"""The static schedule a request: its stream time between two CUDA events
on the card, its host time on the CPU (the program's ``schedule``
span)."""
from perfbench.spans import schedule_ms


def read(run):
    return schedule_ms(run, "proto")
