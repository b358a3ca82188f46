"""Helpers the readers of the program's own spans share
(``metrics/schedule_ms.*``, ``prologue_ms.greedy``, ...).

The program keeps one tree of span records a runner call
(``repro_torch.core.vectorized.span_log``, on ``time.perf_counter()``,
the clock of ``run["window"]``): once-records ``grid_call``,
``rows_in``, ``prepare``, ``schedule`` (with ``device_s``, its stream
time, on a card), ``drive``, ``loop``, ``step0``, ``capture``,
``free``, ``results_out``; each ``drive`` record sums its per-step
spans (``sums``: ``{name: [count, seconds, largest]}`` of ``prologue``,
``place``, ``replay``, ``poll``, ``step``) and holds the odometers'
deltas over it (``counters``: ``calls``, ``captures``, ``replays``,
``polls``, ``place_iters``).  A reader returns ``None`` when the program
keeps no such log (an older program), holds no runner call of the
window, or let go of calls inside it.
"""
from __future__ import annotations


def window_calls(run, kind):
    """The window's runner calls (``grid_call`` trees), each a list of
    its records, when the run's traffic is of ``kind``; else ``None``."""
    if run["kind"] != kind:
        return None
    from perfbench import bench
    span_log = getattr(bench.program()[1], "span_log", None)
    if span_log is None:
        return None
    records, dropped = span_log(*run["window"])
    if dropped:
        return None
    calls = {}
    for r in records:
        calls.setdefault(r["call"], []).append(r)
    calls = [c for c in calls.values() if c[0]["name"] == "grid_call"]
    return calls or None


def _records(calls, name):
    return [r for c in calls for r in c if r["name"] == name]


def seconds(calls, name):
    """Total host seconds of the once-records ``name``."""
    return sum(r["end"] - r["start"] for r in _records(calls, name))


def summed(calls, name):
    """Total seconds of the per-step span ``name`` over the drives."""
    return sum(d["sums"].get(name, (0, 0.0))[1]
               for d in _records(calls, "drive"))


def counter(calls, name):
    return sum(d["counters"][name] for d in _records(calls, "drive"))


def schedule_ms(run, kind):
    """The schedule's time a runner call: its stream time on a card
    (``device_s``), its host time on the CPU, where ops run in order."""
    calls = window_calls(run, kind)
    if calls is None:
        return None
    recs = _records(calls, "schedule")
    if not recs:
        return None
    return 1e3 * sum(r.get("device_s", r["end"] - r["start"])
                     for r in recs) / len(calls)


def prologue_ms(run):
    """Greedy's eager prologue a replayed step."""
    calls = window_calls(run, "grid")
    replays = counter(calls, "replays") if calls else 0
    return 1e3 * summed(calls, "prologue") / replays if replays else None


def place_iters_per_step(run):
    """The greedy placer's loop iterations over the loop's steps: step 0
    of each drive, its replays and (eager) its later steps."""
    calls = window_calls(run, "grid")
    if calls is None:
        return None
    steps = (counter(calls, "calls") + counter(calls, "replays")
             + sum(d["sums"].get("step", (0,))[0]
                   for d in _records(calls, "drive")))
    return counter(calls, "place_iters") / steps if steps else None


def replay_step_ms(run, kind):
    """The loop's time past step 0 and the capture over the replays:
    a replayed step's prologue, launch and share of the polls."""
    calls = window_calls(run, kind)
    replays = counter(calls, "replays") if calls else 0
    if not replays:
        return None
    rest = (seconds(calls, "loop") - seconds(calls, "step0")
            - seconds(calls, "capture"))
    return 1e3 * rest / replays


def poll_wait_share(run):
    """The host's reads of "any row live" (each waits for the steps
    queued before it) over the loop's time."""
    calls = window_calls(run, "grid")
    loop = seconds(calls, "loop") if calls else 0.0
    return summed(calls, "poll") / loop if loop > 0 else None


def graph_setup_ms(run):
    """Step 0, the capture and the graph's free a request."""
    calls = window_calls(run, "proto")
    if calls is None or not _records(calls, "capture"):
        return None
    return 1e3 * (seconds(calls, "step0") + seconds(calls, "capture")
                  + seconds(calls, "free")) / len(calls)
