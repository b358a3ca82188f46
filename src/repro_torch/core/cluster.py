"""Cluster naming shared by the port's survey and grid runners: copies
of ``repro.core.simulator.parse_cluster`` and
``repro.workloads.datasets.w_bucket``."""
from __future__ import annotations


def parse_cluster(name: str):
    """Cluster-name grammar shared by the survey grid and the parity
    suites: ``"<n>x<c>"`` is n workers with c cores each, and ``+`` sums
    heterogeneous segments — ``"1x8+4x2"`` is one 8-core worker followed
    by four 2-core workers.  Returns the per-worker core list (the
    ``cores: i32[W]`` vector of the vectorized simulators)."""
    cores = []
    for part in name.split("+"):
        n, c = part.split("x")
        cores.extend([int(c)] * int(n))
    if not cores:
        raise ValueError(f"empty cluster spec {name!r}")
    return cores


def w_bucket(n_workers: int) -> int:
    """Padded worker-count bucket: the next power of two >= n_workers.
    Same-bucket clusters pad to one W (zero-core filler workers are
    inert) and share one grid runner per (bucket, scheduler,
    netmodel)."""
    w = 1
    while w < n_workers:
        w *= 2
    return w
