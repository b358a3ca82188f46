"""90th percentile latency of a prototyping request."""
from perfbench.readers import latencies_ms, percentile


def read(run):
    return percentile(latencies_ms(run), 90)
