"""Helpers the metric readers (``metrics/<name>.py``) share.

A reader is ``read(run) -> float | None``.  ``run`` holds ``kind``
(``grid`` or ``proto``), ``setup_s``, ``window`` (host-clock start and
end), ``calls`` (one record a call or request of the window: ``t0``,
``t1``, ``rows``, ``ok``, ``row_steps``, the spans ``encode_s``,
``build_s``, ``run_s``, the loop's ``sim_calls``, ``captures``,
``replays`` and ``k1_launches``), ``W`` and, in a traced run,
``trace`` (``trace.profile`` over one cycle of calls, with the cycle's
``calls``).  A reader that finds nothing to read returns ``None`` and
its metric is left out of the line.
"""
from __future__ import annotations

import statistics

from perfbench.roofline import DOWNLOAD_SLOTS, HBM_BYTES_S, k1_bytes


def calls_of(run, kind):
    """The window's calls, when the run's traffic is of ``kind``."""
    return run["calls"] if run["kind"] == kind else []


def latencies_ms(run):
    return [(c["t1"] - c["t0"]) * 1e3 for c in calls_of(run, "proto")]


def mean(values):
    return sum(values) / len(values) if values else None


def percentile(values, q):
    """The ``q``-th percentile (1..99) by ``statistics.quantiles``."""
    if len(values) < 2:
        return None
    return statistics.quantiles(values, n=100)[q - 1]


def loop_steps(c):
    """Event-loop steps of one call: the eager first step of each
    simulator call and one replay a later step."""
    return c["sim_calls"] + c["replays"]


def mean_span_ms(run, kind, span):
    cs = calls_of(run, kind)
    return 1e3 * sum(c[span] for c in cs) / len(cs) if cs else None


def ms_per_step(run, kind, span=None):
    cs = calls_of(run, kind)
    steps = sum(loop_steps(c) for c in cs)
    if not steps:
        return None
    wall = sum((c[span] if span else c["t1"] - c["t0"]) for c in cs)
    return 1e3 * wall / steps


def device_idle(run, kind):
    tr = run.get("trace")
    if not tr or run["kind"] != kind or tr["wall_s"] <= 0:
        return None
    return 1.0 - tr["busy_s"] / tr["wall_s"]


def sims_per_s(run):
    """Grid rows that finished over the window's seconds."""
    cs = calls_of(run, "grid")
    t = run["window"][1] - run["window"][0]
    return sum(c["ok"] for c in cs) / t if cs and t > 0 else None


def row_step_util(run):
    """The rows' own ``n_steps`` over rows x the call's loop steps."""
    cs = calls_of(run, "grid")
    attempted = sum(c["rows"] * loop_steps(c) for c in cs)
    return sum(c["row_steps"] for c in cs) / attempted if attempted else None


def k1_roofline(run):
    """K1's share (%) of its bytes bound over the profiled cycle: every
    launch's R, F, W (inputs read once, output written once) at the
    card's HBM rate, over K1's device time."""
    tr = run.get("trace")
    if not tr or run["kind"] != "grid" or tr["k1_device_s"] <= 0:
        return None
    W = run["W"]
    need = sum(c["k1_launches"] * k1_bytes(c["rows"], DOWNLOAD_SLOTS * W, W)
               for c in tr["calls"])
    return 100.0 * need / HBM_BYTES_S / tr["k1_device_s"] if need else None


def k1_device_share(run):
    """K1's device time over all device busy time of the profiled
    cycle of grid calls."""
    tr = run.get("trace")
    if not tr or run["kind"] != "grid" or tr["busy_s"] <= 0:
        return None
    return tr["k1_device_s"] / tr["busy_s"]
