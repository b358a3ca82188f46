"""The greedy placer's loop iterations (the ready count it reads on the
host) a loop step: the program's ``place_iters`` counter over step 0
and the replays."""
from perfbench.spans import place_iters_per_step


def read(run):
    return place_iters_per_step(run)
