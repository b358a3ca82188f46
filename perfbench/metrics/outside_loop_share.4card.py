"""Share of rank 0's grid call wall time outside its simulator call
(the program's ``prepare`` and ``drive`` spans): the sharded engine's
split, row queue and gather over the host, and the copy of the results
to the host."""
from perfbench.spans import outside_loop_share


def read(run):
    return outside_loop_share(run)
