"""A replayed step of the event loop: the program's ``loop`` span less
``step0`` and ``capture``, over its replays (the prologue, the graph's
launch and the polls)."""
from perfbench.spans import replay_step_ms


def read(run):
    return replay_step_ms(run, "grid")
