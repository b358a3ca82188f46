"""Mean time a request spends in ``make_grid_runner`` (front door)."""
from perfbench.readers import mean_span_ms


def read(run):
    return mean_span_ms(run, "proto", "build_s")
