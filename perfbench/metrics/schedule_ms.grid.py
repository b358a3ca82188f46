"""The static schedule (blevel's list schedule over the call's rows)
a runner call: its stream time between two CUDA events on the card, its
host time on the CPU (the program's ``schedule`` span)."""
from perfbench.spans import schedule_ms


def read(run):
    return schedule_ms(run, "grid")
