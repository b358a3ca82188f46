"""The grid engine's odometers and span record: where a runner call
spends its time, on the host's clock, always on.

``GRAPH_EVENTS`` holds the process-wide odometers of the event loops:
``calls`` (simulator calls), ``captures`` (one per call whose step ran
from a CUDA graph), ``replays``, ``polls`` (the host's reads of "any
row live"), and the counters a simulator call adds once, after its
loop (``count``): ``place_iters`` (the greedy placer's loop
iterations) and ``slot_busy`` (download slots occupied in live rows,
summed over the steps), both counted on the device inside the step;
``edge_lanes`` and ``valid_edges`` (the bucket's padded and real input
edges, times the rows); ``schedule_launches`` (the launches of the
static schedule's kernel, ``kernels.list_schedule``, in the call's
``schedule`` span: one on a card for a list scheduler or greedy, none on
the CPU).  ``PEAKS`` hold a largest value, not a sum:
``frontier_peak`` (the fullest candidate-flow frontier of a live row
in any step, counted on the device) and ``flow_cap`` (that frontier's
cap); their odometer keeps the largest a call has reported.
``engine.capture_counter`` reads the sums, and the span totals, as
scoped deltas.

Beside them every runner call is one tree of spans::

    grid_call          BucketedGridRunner.__call__
    ├ rows_in          row_inputs: estimates, row index, copy to the card
    ├ prepare          the simulator's run() before its loop
    │ └ schedule       the static schedule, or greedy's priorities
    ├ drive            sim._drive, one per simulator call
    │ ├ loop           every step and every poll
    │ │ ├ step0        eager step 0
    │ │ ├ capture      the CUDA graph's capture
    │ │ └ place, replay, poll, step    (summed)
    │ └ free           the graph and its pool released
    └ results_out      copy to the host, reshape, the ``ok`` check

The outermost open span starts a call (a simulator called directly is
a call of its own).  A span that runs once is one record, a dict:
``name``, ``start`` and ``end`` (``time.perf_counter()`` seconds, the
clock of a caller's own timings), ``call`` (the id of its call), ``id``
and ``parent`` (the enclosing span's id, ``None`` at the root).  The
spans that run per step or per poll (``place`` around greedy's
placement where the step runs eagerly, never inside a captured step,
``replay``, ``poll``, and ``step`` for an eager step past step 0) are
summed into their ``drive`` record's ``sums``: ``{name: [count,
seconds, largest]}``; the drive record's ``counters`` are the
odometers' deltas over it, and a peak's value in that call.  A
``schedule`` on a card also records a pair of CUDA events on its
stream and gets ``device_s``, the stream time between them, once both
are done: when its call ends (after the call's own copy to the host)
or when ``span_log`` reads it, never by a sync of its own.

The calls sit in a bounded buffer of ``MAX_CALLS``; what it lets go is
counted (``LOG.dropped``).  Nothing is written out.  The timestamps and
sums always run; while a ``torch.profiler`` session is on
(``torch.autograd.profiler._is_profiler_enabled``, the flag the
profiler sets on start and clears on stop), each span also opens
``record_function("repro_torch.<name>")``, so the spans reach the
profiler's trace on the device trace's clock; otherwise no such object
is made.  One thread drives the loops, as every caller in the port
does.
"""
from __future__ import annotations

import collections
import functools
import itertools
import math
import time

import torch
import torch.autograd.profiler as _prof

PREFIX = "repro_torch."
MAX_CALLS = 4096

GRAPH_EVENTS = {"calls": 0, "captures": 0, "replays": 0, "polls": 0,
                "place_iters": 0, "slot_busy": 0, "edge_lanes": 0,
                "valid_edges": 0, "frontier_peak": 0, "flow_cap": 0,
                "schedule_launches": 0}
# the counters that hold a largest value, not a sum
PEAKS = ("frontier_peak", "flow_cap")
# every span closed in the process: {name: [count, seconds]}; a summed
# span counts here when its drive ends
SPAN_TOTALS = {}

_now = time.perf_counter
_ids = itertools.count()
_open = []        # the open span records, innermost last
_drives = []      # the open drive records, innermost last
_call = None      # the records of the open call, root first
_pending = []     # (record, start event, end event) of card schedules


class _Log:
    """The last ``max_calls`` calls as ``(start, end, records)``."""

    def __init__(self, max_calls):
        self.calls = collections.deque(maxlen=max_calls)
        self.dropped = 0
        self.dropped_until = -math.inf    # end of the newest call let go

    def add(self, call):
        if len(self.calls) == self.calls.maxlen:
            self.dropped += 1
            self.dropped_until = self.calls[0][1]
        self.calls.append(call)


LOG = _Log(MAX_CALLS)


def _profiled(name):
    """``record_function`` of ``name`` entered, under a profiler only."""
    if not _prof._is_profiler_enabled:
        return None
    rf = torch.profiler.record_function(PREFIX + name)
    rf.__enter__()
    return rf


def _add_total(name, n, seconds):
    tot = SPAN_TOTALS.get(name)
    if tot is None:
        SPAN_TOTALS[name] = [n, seconds]
    else:
        tot[0] += n
        tot[1] += seconds


def _begin(name):
    """Open a record; ``(record, whether it opened the call)``."""
    global _call
    rec = {"name": name, "call": None, "id": next(_ids),
           "parent": _open[-1]["id"] if _open else None,
           "start": None, "end": None}
    owns = _call is None
    if owns:
        rec["call"] = rec["id"]
        _call = [rec]
    else:
        rec["call"] = _call[0]["call"]
        _call.append(rec)
    _open.append(rec)
    rec["_rf"] = _profiled(name)
    rec["start"] = _now()
    return rec, owns


def _end(rec):
    """Close ``rec``, and first any span left open inside it."""
    t = _now()
    while _open:
        r = _open.pop()
        r["end"] = t
        rf = r.pop("_rf")
        if rf is not None:
            rf.__exit__(None, None, None)
        _add_total(r["name"], 1, t - r["start"])
        if r is rec:
            return


def _resolve():
    """``device_s`` of the card schedules whose events are done."""
    keep = []
    for rec, e0, e1 in _pending:
        if e1.query():
            rec["device_s"] = e0.elapsed_time(e1) / 1e3
        else:
            keep.append((rec, e0, e1))
    _pending[:] = keep


def _finish_call(start):
    global _call
    LOG.add((start, _now(), _call))
    _call = None
    if _pending:
        _resolve()


class span:
    """``with span(name[, device]):`` one record of a span that runs
    once (see the module docstring).  With a CUDA ``device`` it also
    records a CUDA event on the device's current stream at each end."""

    __slots__ = ("name", "device", "rec", "owns", "e0")

    def __init__(self, name, device=None):
        self.name = name
        self.device = device if device is not None \
            and device.type == "cuda" else None

    def __enter__(self):
        self.rec, self.owns = _begin(self.name)
        if self.device is not None:
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e0.record(torch.cuda.current_stream(self.device))
        return self.rec

    def __exit__(self, *exc):
        rec = self.rec
        if self.device is not None:
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record(torch.cuda.current_stream(self.device))
            _pending.append((rec, self.e0, e1))
        if rec["end"] is None:
            _end(rec)
        if self.owns:
            _finish_call(rec["start"])
        return False


class drive(span):
    """The ``drive`` span of one simulator call (``sim._drive``).  It
    first ends an open ``prepare``: the simulator's set-up ends where
    its loop begins.  The summed spans inside it land in its ``sums``,
    the odometers' deltas over it in its ``counters``, and for a peak
    the value of its own call."""

    __slots__ = ("at",)

    def __init__(self):
        super().__init__("drive")

    def __enter__(self):
        if _open and _open[-1]["name"] == "prepare":
            _end(_open[-1])
        rec = super().__enter__()
        rec["sums"] = {}
        rec["peaks"] = dict.fromkeys(PEAKS, 0)
        self.at = dict(GRAPH_EVENTS)
        _drives.append(rec)
        return rec

    def __exit__(self, *exc):
        rec = _drives.pop()
        peaks = rec.pop("peaks")
        rec["counters"] = {k: peaks[k] if k in peaks else v - self.at[k]
                           for k, v in GRAPH_EVENTS.items()}
        for name, (n, s, _) in rec["sums"].items():
            _add_total(name, n, s)
        return super().__exit__(*exc)


class _Summed:
    """A span that runs per step or per poll: summed into the innermost
    open drive record (count, seconds, largest); outside a drive only
    the process totals see it."""

    __slots__ = ("name", "t", "rf")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.rf = _profiled(self.name) if _prof._is_profiler_enabled \
            else None
        self.t = _now()

    def __exit__(self, *exc):
        dt = _now() - self.t
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        if not _drives:
            _add_total(self.name, 1, dt)
            return False
        sums = _drives[-1]["sums"]
        acc = sums.get(self.name)
        if acc is None:
            sums[self.name] = [1, dt, dt]
        else:
            acc[0] += 1
            acc[1] += dt
            if dt > acc[2]:
                acc[2] = dt
        return False


def count(name, value):
    """Add ``value`` to the odometer ``name``, or for one of ``PEAKS``
    raise it to ``value`` and keep ``value`` as the open drive's own."""
    if name not in PEAKS:
        GRAPH_EVENTS[name] += value
        return
    GRAPH_EVENTS[name] = max(GRAPH_EVENTS[name], value)
    if _drives:
        peaks = _drives[-1]["peaks"]
        peaks[name] = max(peaks[name], value)


PLACE, REPLAY, POLL, STEP = (
    _Summed(n) for n in ("place", "replay", "poll", "step"))


def span_log(t0=-math.inf, t1=math.inf):
    """``(records, dropped)``: the records, in the order they opened, of
    the calls that started at or after ``t0`` and ended by ``t1``
    (``time.perf_counter()`` seconds), and the count of calls the buffer
    has let go if any of them ended at or after ``t0`` (else 0: the
    interval is whole)."""
    if _pending:
        _resolve()
    recs = [r for start, end, call in LOG.calls
            if start >= t0 and end <= t1 for r in call]
    return recs, (LOG.dropped if LOG.dropped_until >= t0 else 0)


def totals():
    """A copy of ``SPAN_TOTALS``: ``{name: (count, seconds)}``."""
    return {k: (n, s) for k, (n, s) in SPAN_TOTALS.items()}


def prepared(run):
    """``run``, a simulator's call, inside a ``prepare`` span, which the
    call's ``drive`` ends where the loop begins."""
    @functools.wraps(run)
    def call(*args, **kwargs):
        with span("prepare"):
            return run(*args, **kwargs)
    return call
