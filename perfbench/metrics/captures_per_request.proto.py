"""CUDA graph captures of the event step per request
(``capture_counter``)."""
from perfbench.readers import calls_of


def read(run):
    cs = calls_of(run, "proto")
    return sum(c["captures"] for c in cs) / len(cs) if cs else None
