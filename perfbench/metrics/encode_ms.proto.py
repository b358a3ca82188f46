"""Mean time a request spends in ``encode_graph_batch`` (graph encoding)."""
from perfbench.readers import mean_span_ms


def read(run):
    return mean_span_ms(run, "proto", "encode_s")
