"""Mean latency of a prototyping request (encode, build, run, results on
the host) over all requests of the window."""
from perfbench.readers import latencies_ms, mean


def read(run):
    return mean(latencies_ms(run))
