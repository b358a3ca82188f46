"""The grid engine's span record (``repro_torch.core.vectorized._spans``)
on the CPU: one runner call is one span tree with one call id, the
spans of the graph path (a stand-in capture) account for the loop,
``capture_counter`` keeps its counts and gains scoped span totals,
``span_log`` selects calls by interval and reports what the buffer let
go, the spans reach a ``torch.profiler`` trace only under a profiler
and leave the results unchanged, simlint stays clean on the spanned
files, and the benchmark's readers of the spans on a synthetic log.
The card's own spans (schedule's stream time, capture, free) are in
``tests/test_torch_cuda.py``."""
import pathlib
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from repro_torch.core import MiB  # noqa: E402
from repro_torch.core.graphs import random_graph  # noqa: E402
from repro_torch.core.vectorized import (_spans, capture_counter,  # noqa: E402
                                         make_grid_runner, sim, span_log)
from repro_torch.core.vectorized.specs import encode_graph  # noqa: E402

POINTS = [dict(imode="user", bandwidth=64 * MiB, msd=0.1,
               decision_delay=0.05),
          dict(imode="exact", bandwidth=512 * MiB, msd=0.0)]
CHILDREN = {"rows_in", "prepare", "drive", "results_out"}
PARENT = {"rows_in": "grid_call", "prepare": "grid_call",
          "drive": "grid_call", "results_out": "grid_call",
          "schedule": "prepare", "loop": "drive", "step0": "loop",
          "capture": "loop", "free": "drive"}


def runner(sched, **kw):
    gs = [random_graph(s, n_tasks=14, max_cpus=2) for s in (1, 2)]
    return make_grid_runner([(g, encode_graph(g)) for g in gs], sched, 4,
                            [2, 2, 1, 1], device="cpu", **kw)


def one_call(run):
    """``(result, records of the call, capture_counter)``."""
    import time
    t0 = time.perf_counter()
    with capture_counter() as cc:
        res = run(POINTS)
    recs, dropped = span_log(t0, time.perf_counter())
    assert dropped == 0
    return res, recs, cc


def check_tree(recs):
    """One call id; each record's parent is the span the tree names,
    and lies inside it."""
    root = recs[0]
    assert root["name"] == "grid_call" and root["parent"] is None
    assert {r["call"] for r in recs} == {root["id"]}
    by_id = {r["id"]: r for r in recs}
    for r in recs[1:]:
        p = by_id[r["parent"]]
        assert p["name"] == PARENT[r["name"]], r["name"]
        assert p["start"] <= r["start"] <= r["end"] <= p["end"]
    return {r["name"]: r for r in recs}


@pytest.mark.parametrize("sched,check_every", [("blevel", 16),
                                               ("greedy", 16),
                                               ("greedy", 5)])
def test_eager_call_is_one_span_tree(sched, check_every):
    res, recs, cc = one_call(runner(sched, check_every=check_every))
    names = check_tree(recs)
    assert sorted(r["name"] for r in recs) == sorted(
        ["grid_call", "rows_in", "prepare", "schedule", "drive", "loop",
         "step0", "results_out"])
    d = names["drive"]
    steps = 1 + d["sums"]["step"][0]
    # the loop stops only at a poll: the first multiple of check_every
    # past the slowest row's last step
    assert steps % check_every == 0
    assert steps - check_every < res.n_steps.max() <= steps
    assert d["counters"]["polls"] == d["sums"]["poll"][0] == \
        steps // check_every + 1 == cc.polls
    assert d["counters"]["calls"] == cc.calls == 1
    assert d["counters"]["replays"] == 0 and "replay" not in d["sums"]
    if sched == "greedy":
        assert d["counters"]["place_iters"] == cc.place_iters > 0
        assert d["sums"]["place"][0] > 0
    else:
        assert d["counters"]["place_iters"] == 0
    for n, s, big in d["sums"].values():
        assert n > 0 and 0 <= big <= s


class FakeCapture:
    """Stands in for ``sim._capture`` on the CPU: a "replay" runs the
    captured step eagerly and counts as the card's does."""

    def __call__(self, step, device):
        sim.GRAPH_EVENTS["captures"] += 1

        def replay():
            step()
            sim.GRAPH_EVENTS["replays"] += 1
        return replay, lambda: None


@pytest.mark.parametrize("sched", ["blevel", "greedy"])
def test_graph_path_spans_account_for_the_loop(sched, monkeypatch):
    want, _, eager = one_call(runner(sched))
    monkeypatch.setattr(sim, "_capture", FakeCapture())
    monkeypatch.setattr(sim, "_resolve_step_graph", lambda s, d: True)
    res, recs, cc = one_call(runner(sched))
    for f in want._fields:
        assert np.array_equal(getattr(want, f), getattr(res, f)), f
    names = check_tree(recs)
    assert {"capture", "free", "step0"} <= set(names)
    d = names["drive"]
    c = d["counters"]
    assert c["captures"] == cc.captures == 1
    assert c["replays"] == cc.replays == d["sums"]["replay"][0] > 0
    steps = c["replays"] + 1            # the steps capture_counter counts
    assert steps == cc.calls + cc.replays
    assert c["polls"] == steps // 16 + 1 and steps % 16 == 0
    assert "step" not in d["sums"]
    # greedy's invocation is replayed with the rest of the step: no
    # prologue runs, no span sits inside the captured step, and the
    # placer's iterations, summed in the call's tally and read once
    # after the loop, equal the eager run's
    assert "prologue" not in d["sums"] and "place" not in d["sums"]
    assert c["place_iters"] == cc.place_iters == eager.place_iters
    assert (c["place_iters"] > 0) == (sched == "greedy")
    loop = names["loop"]
    inside = sum(names[n]["end"] - names[n]["start"]
                 for n in ("step0", "capture")) + sum(
        d["sums"].get(n, (0, 0.0))[1] for n in ("replay", "poll"))
    assert inside <= loop["end"] - loop["start"]
    root = names["grid_call"]
    kids = sum(r["end"] - r["start"] for r in recs
               if r["name"] in CHILDREN)
    assert 0.5 < kids / (root["end"] - root["start"]) <= 1.0


def test_capture_counter_counts_unchanged_and_span_totals_nest():
    run = runner("greedy")
    with capture_counter() as outer:
        run(POINTS)
        with capture_counter() as inner:
            run(POINTS)
        partial = dict(outer.spans)
    assert outer.calls == 2 and inner.calls == 1
    assert outer.captures == inner.captures == 0
    assert outer.replays == inner.replays == 0
    assert set(inner.spans) == {"grid_call", "rows_in", "prepare",
                                "schedule", "drive", "loop", "step0",
                                "results_out", "poll", "step", "place"}
    for name, (n, s) in inner.spans.items():
        n2, s2 = outer.spans[name]
        assert n2 == 2 * n if name in CHILDREN | {"grid_call"} else n2 > n
        assert s2 > s > 0
    assert inner.spans["grid_call"][0] == 1
    assert outer.polls > inner.polls > 0
    assert outer.place_iters > inner.place_iters > 0
    assert partial == outer.spans                   # held at the exit
    run(POINTS)
    assert outer.spans == partial and outer.calls == 2


def test_span_log_selects_by_interval_and_reports_drops(monkeypatch):
    import time
    monkeypatch.setattr(_spans, "LOG", _spans._Log(3))
    marks = []
    for i in range(5):
        marks.append(time.perf_counter())
        with _spans.span(f"call{i}"):
            with _spans.span("inner"):
                pass
    end = time.perf_counter()
    recs, dropped = span_log(marks[3], end)
    assert [r["name"] for r in recs] == ["call3", "inner", "call4", "inner"]
    assert dropped == 0
    assert recs[1]["parent"] == recs[0]["id"] == recs[1]["call"]
    # calls 0 and 1 were let go: an interval that reaches them says so
    recs, dropped = span_log(marks[1], end)
    assert [r["name"] for r in recs[::2]] == ["call2", "call3", "call4"]
    assert dropped == 2 == _spans.LOG.dropped
    assert span_log(marks[0], marks[2])[0] == []
    assert span_log()[1] == 2


def test_profiler_sees_spans_only_when_on(monkeypatch):
    from torch.profiler import ProfilerActivity, profile
    run = runner("greedy")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = run(POINTS)
    names = {e.name for e in prof.events()}
    want = {_spans.PREFIX + n for n in (
        "grid_call", "rows_in", "prepare", "schedule", "drive", "loop",
        "step0", "step", "poll", "place", "results_out")}
    assert want <= names

    def refuse(*a, **k):
        raise AssertionError("record_function made with no profiler on")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    off = run(POINTS)
    for f in on._fields:
        assert np.array_equal(getattr(on, f), getattr(off, f)), f


@pytest.mark.parametrize("name", ["sim.py", "scheduling.py", "_spans.py"])
def test_simlint_clean_on_the_spanned_files(name):
    from repro_torch.analysis import active, check_source
    path = ROOT / "src" / "repro_torch" / "core" / "vectorized" / name
    assert active(check_source(path.read_text(), str(path))) == []


# ------------------------------------------------ the benchmark's readers

def _rec(call, id_, parent, name, start, end, **extra):
    return dict(call=call, id=id_, parent=parent, name=name, start=start,
                end=end, **extra)


def synthetic_log(device_s):
    """Two runner calls of one drive each: seconds chosen so that every
    reader's value is worked out by hand below."""
    recs = []
    for k, t in enumerate((10.0, 20.0)):
        c = 100 * k
        sch = dict(device_s=device_s) if device_s is not None else {}
        recs += [
            _rec(c, c, None, "grid_call", t, t + 5.0),
            _rec(c, c + 1, c, "rows_in", t, t + 0.1),
            _rec(c, c + 2, c, "prepare", t + 0.1, t + 0.5),
            _rec(c, c + 3, c + 2, "schedule", t + 0.2, t + 0.4, **sch),
            _rec(c, c + 4, c, "drive", t + 0.5, t + 4.9,
                 sums=dict(prologue=[90, 0.9, 0.02],
                           replay=[90, 1.8, 0.03],
                           poll=[7, 0.7, 0.2], place=[90, 0.5, 0.01]),
                 counters=dict(calls=1, captures=1, replays=90, polls=7,
                               place_iters=455)),
            _rec(c, c + 5, c + 4, "loop", t + 0.6, t + 4.6),
            _rec(c, c + 6, c + 5, "step0", t + 0.6, t + 0.7),
            _rec(c, c + 7, c + 5, "capture", t + 0.7, t + 0.73),
            _rec(c, c + 8, c + 4, "free", t + 4.6, t + 4.65),
            _rec(c, c + 9, c, "results_out", t + 4.9, t + 5.0),
        ]
    return recs


# metric: (value on the log with device_s 0.15, value with no device_s)
READERS = {
    "schedule_ms.grid": (150.0, 200.0),
    "schedule_ms.proto": (150.0, 200.0),
    "prologue_ms.greedy": (10.0, 10.0),
    "place_iters_per_step.greedy": (5.0, 5.0),
    "replay_step_ms.grid": (43.0, 43.0),
    "replay_step_ms.greedy": (43.0, 43.0),
    "replay_step_ms.proto": (43.0, 43.0),
    "poll_wait_share.grid": (0.175, 0.175),
    "poll_wait_share.greedy": (0.175, 0.175),
    "graph_setup_ms.proto": (180.0, 180.0),
}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_span_reader_on_a_synthetic_log(metric, monkeypatch):
    from perfbench import bench, run as prun
    read = prun.reader(metric, ROOT / "perfbench")
    kind = "proto" if metric.endswith(".proto") else "grid"
    other = "grid" if kind == "proto" else "proto"
    state = dict(log=None, dropped=0, window=None)

    def span_log(t0, t1):
        state["window"] = (t0, t1)
        return ([r for r in state["log"] if t0 <= r["start"] <= t1],
                state["dropped"])
    vec = types.SimpleNamespace(span_log=span_log)
    monkeypatch.setattr(bench, "program", lambda: (None, vec, None))
    run = dict(kind=kind, window=(5.0, 30.0), calls=[], trace=None)
    for device_s, want in zip((0.15, None), READERS[metric]):
        state["log"] = synthetic_log(device_s)
        assert read(run) == pytest.approx(want, rel=1e-9)
        assert state["window"] == (5.0, 30.0)
    # a call outside the window is not read
    state["log"] = synthetic_log(0.15)[:10]
    assert read(dict(run, window=(5.0, 15.5))) == pytest.approx(
        READERS[metric][0], rel=1e-9)
    # nothing to read: no call in the window, calls let go inside it,
    # another traffic kind, a program without a span log
    assert read(dict(run, window=(40.0, 50.0))) is None
    state["dropped"] = 1
    assert read(run) is None
    state["dropped"] = 0
    assert read(dict(run, kind=other)) is None
    monkeypatch.setattr(bench, "program",
                        lambda: (None, types.SimpleNamespace(), None))
    assert read(run) is None
