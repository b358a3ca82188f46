"""Step 0, the CUDA graph's capture and its free a request (the
program's ``step0``, ``capture`` and ``free`` spans)."""
from perfbench.spans import graph_setup_ms


def read(run):
    return graph_setup_ms(run)
