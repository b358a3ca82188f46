"""The benchmark's irw cell (``irw-w32.blevel-grid``) on the CPU: the
frozen irw generators under ``perfbench/reference/datasets/irw.py``
equal the port's ``core/graphs/irw.py`` field by field; the port's grid
runner equals the plain reference on cross-validation graphs and a
mapreduce shuffle in one bucket; the flow path's device counters
(``slot_busy``, ``frontier_peak``) equal an eager recount and leave the
results and the host's polls unchanged; and the readers of the cell's
per-layer metrics on a synthetic span log."""
import importlib.util
import pathlib
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import bench, check  # noqa: E402
from perfbench import run as prun  # noqa: E402
from perfbench.reference import generators as gen  # noqa: E402
from repro_torch.core.graphs import irw  # noqa: E402
from repro_torch.core.vectorized import (capture_counter,  # noqa: E402
                                         make_grid_runner, sim, span_log)
from repro_torch.core.vectorized.specs import encode_graph  # noqa: E402

CELL = "irw-w32.blevel-grid"
DATASETS = ROOT / "perfbench" / "reference" / "datasets"
# the port's generator and its arguments for each graph of the cell
PORT = {"gridcat": ("gridcat", {}), "crossv": ("crossv", {}),
        "crossvx": ("crossvx", {}), "fastcrossv": ("fastcrossv", {}),
        "nestedcrossv": ("nestedcrossv", {}),
        "mapreduce48": ("mapreduce", dict(maps=48, reduces=48))}


def reference_irw():
    """The frozen dataset file as a module (``mapreduce`` at any size)."""
    spec = importlib.util.spec_from_file_location("irw_reference",
                                                  DATASETS / "irw.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fields(g):
    return dict(
        tasks=[(t.name, t.cpus) for t in g.tasks],
        durations=[t.duration for t in g.tasks],
        objects=[(o.parent.id, [c.id for c in o.consumers])
                 for o in g.objects],
        sizes=[o.size for o in g.objects],
        edges=[[o.id for o in t.inputs] for t in g.tasks],
        user=([t.expected_duration for t in g.tasks],
              [o.expected_size for o in g.objects]))


def test_cell_names_the_dataset_files_graphs():
    w = bench.cell(CELL)
    assert w["config_data"]["dataset"] == "irw"
    assert list(gen.dataset_file("irw")) == w["config_data"]["graphs"]
    assert set(w["config_data"]["graphs"]) == set(PORT)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(PORT))
def test_reference_generators_equal_the_ports(name, seed):
    ref = gen.make_graph("irw", name, seed)
    fn, kw = PORT[name]
    port = irw.IRW[fn](seed, **kw)
    assert ref.name == name
    want, got = fields(port), fields(ref)
    for key in want:
        assert got[key] == want[key], key


# six points over both msds, both imodes and both bandwidths the test
# covers: (bandwidth MiB/s, imode, msd)
POINTS = [(32, "exact", 0.0), (8192, "user", 1.6), (32, "user", 1.6),
          (8192, "exact", 0.0), (32, "exact", 1.6), (8192, "user", 0.0)]


def gen_bucket(g):
    from perfbench.reference import encode
    return encode.t_bucket(g.task_count)


def small_shuffle_workload(seed):
    """The cell's workload with its graphs swapped for ``crossv``,
    ``fastcrossv`` and a 16 x 16 ``mapreduce`` (33 tasks: the smallest
    square that shares their T160 bucket; 8 x 8 has 17 tasks and a
    bucket of its own) in one bucket, on its two 32-worker clusters, at
    ``POINTS``."""
    w = bench.cell(CELL)
    wl = bench.Workload(w, seed)
    ref = reference_irw()
    wl.graphs = [ref.crossv(seed), ref.fastcrossv(seed),
                 ref.mapreduce(seed, maps=16, reduces=16)]
    names = tuple(g.name for g in wl.graphs)
    assert len({gen_bucket(g) for g in wl.graphs}) == 1
    wl.units = [(names, (0, 1))]
    want = {(bw * bench.MiB, im, m) for bw, im, m in POINTS}
    wl.points = [p for p in wl.points
                 if (p["bandwidth"], p["imode"], p["msd"]) in want]
    assert len(wl.points) == len(POINTS)
    return w, wl


def test_port_grid_equals_the_reference_on_a_shuffle_bucket():
    w, wl = small_shuffle_workload(seed=2 ** 31 + 31)
    client = bench.Client(wl, torch.device("cpu"))
    client.setup()
    rec = client.call(0)
    assert rec["error"] is None
    assert rec["ok"] == rec["rows"] == 2 * 3 * len(POINTS)
    rows = check.unit_rows(wl, 0)
    got = check.program_rows(rec["result"], rows)
    want = check.reference(wl, 0, rows, torch.device("cpu"))
    for key in ("ok", "n_events", "n_steps"):
        assert np.array_equal(got[key], want[key]), key
    numbers = check.compare([(got, want)])
    lim = check.limits(w)
    assert numbers["not_ok"] == 0
    for key in ("makespan_rel", "transferred_rel", "counts_rel"):
        assert numbers[key] <= lim[key], key
    # the rows move bytes between workers
    assert (got["transferred"] > 0).any()


# ------------------------------------------------ the flow counters

def shuffle_runner(**kw):
    ref = reference_irw()
    gs = [ref.mapreduce(5, maps=20, reduces=16), ref.crossv(5)]
    return make_grid_runner([(g, encode_graph(g)) for g in gs], "blevel", 8,
                            [2] * 8, device="cpu", **kw)


SHUFFLE_POINTS = [dict(imode="exact", bandwidth=32 * bench.MiB, msd=0.0),
                  dict(imode="user", bandwidth=256 * bench.MiB, msd=0.4,
                       decision_delay=0.05)]


def counted_call(run):
    """``(result, the drive record's counters, capture_counter)``."""
    import time
    t0 = time.perf_counter()
    with capture_counter() as cc:
        res = run(SHUFFLE_POINTS)
    recs, _ = span_log(t0, time.perf_counter())
    (d,) = [r for r in recs if r["name"] == "drive"]
    return res, d["counters"], cc


def test_flow_counters_equal_an_eager_recount(monkeypatch):
    """K1's ``active`` flows are the occupied slots of each step, and the
    frontier the flow candidates' append returns is its fill; a row that
    is no longer live has finished, holding no slot and no candidate, so
    every row is recounted."""
    busy, peaks = [], []
    make_wf = sim._make_waterfill

    def counting_waterfill(*a, **k):
        wf = make_wf(*a, **k)

        def run(src, dst, active, caps):
            busy.append(int(active.sum()))
            return wf(src, dst, active, caps)
        return run
    append = sim._frontier_append

    def counting_append(fr, new_mask, ids):
        out = append(fr, new_mask, ids)
        if ids.shape[0] == E:
            peaks.append(int((out[0] >= 0).sum(dim=1).amax()))
        return out
    runner = shuffle_runner()
    T, O, E = runner.shape
    assert T != E
    monkeypatch.setattr(sim, "_make_waterfill", counting_waterfill)
    monkeypatch.setattr(sim, "_frontier_append", counting_append)
    res, c, cc = counted_call(shuffle_runner())
    # one K1 solve and one flow append a loop step; the loop stops at a
    # poll, every 16 steps
    assert len(busy) == len(peaks) == (c["polls"] - 1) * 16
    assert c["slot_busy"] == sum(busy) > 0
    assert c["frontier_peak"] == max(peaks) > 0
    # the shape's own caps (the benchmark passes full ones, (E, T))
    assert c["flow_cap"] == sim._frontier_caps(None, T, O, E)[0] < E
    assert c["edge_lanes"] == res.n_steps.size * E
    n_edges = sum(len(t.inputs) for g in runner.graphs for t in g.tasks)
    assert c["valid_edges"] == n_edges * len(SHUFFLE_POINTS)
    # every slot a row holds counts once a step: no more than the pool
    assert c["slot_busy"] <= res.n_steps.sum() * 4 * 8


def test_counters_leave_results_and_polls_unchanged(monkeypatch):
    want, c_on, cc_on = counted_call(shuffle_runner())
    monkeypatch.setattr(sim, "_count_flows", lambda *a, **k: None)
    got, c_off, cc_off = counted_call(shuffle_runner())
    for f in want._fields:
        assert np.array_equal(getattr(want, f), getattr(got, f),
                              equal_nan=True), f
    assert c_off["slot_busy"] == c_off["frontier_peak"] == 0
    assert c_on["slot_busy"] > 0 and c_on["frontier_peak"] > 0
    steps = -(-int(want.n_steps.max()) // 16) * 16
    assert cc_on.polls == cc_off.polls == steps // 16 + 1 == c_on["polls"]


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
def test_graph_path_counts_what_the_eager_path_counts(sched, monkeypatch):
    ref = reference_irw()
    gs = [ref.mapreduce(9, maps=17, reduces=16), ref.fastcrossv(9)]

    def runner():
        return make_grid_runner([(g, encode_graph(g)) for g in gs], sched,
                                4, [2, 2, 1, 1], device="cpu")
    want, eager, _ = counted_call(runner())
    monkeypatch.setattr(sim, "_capture", FakeCapture())
    monkeypatch.setattr(sim, "_resolve_step_graph", lambda s, d: True)
    got, graph, cc = counted_call(runner())
    assert cc.captures == 1 and cc.replays > 0
    for f in want._fields:
        assert np.array_equal(getattr(want, f), getattr(got, f),
                              equal_nan=True), f
    for key in ("slot_busy", "frontier_peak", "flow_cap", "edge_lanes",
                "valid_edges", "place_iters", "polls"):
        assert graph[key] == eager[key], key
    assert graph["slot_busy"] > 0


def test_per_edge_path_counts_slots_only():
    want, c, _ = counted_call(shuffle_runner(frontier=False))
    assert c["slot_busy"] > 0
    assert c["frontier_peak"] == c["flow_cap"] == 0
    on, c_on, _ = counted_call(shuffle_runner())
    assert c["slot_busy"] == c_on["slot_busy"]


def test_peaks_are_a_calls_own_in_its_drive_record():
    _, first, _ = counted_call(shuffle_runner())
    ref = reference_irw()
    gs = [ref.mapreduce(5, maps=2, reduces=2)]
    small = make_grid_runner([(g, encode_graph(g)) for g in gs], "blevel",
                             8, [2] * 8, device="cpu")
    _, second, _ = counted_call(small)
    assert second["flow_cap"] < first["flow_cap"]
    assert second["frontier_peak"] < first["frontier_peak"]
    assert sim.GRAPH_EVENTS["frontier_peak"] >= first["frontier_peak"]


# ------------------------------------------------ the cell's readers

def _drive(call, id_, start, **counters):
    base = dict(calls=1, captures=1, replays=90, polls=7, place_iters=0)
    return dict(call=call, id=id_, parent=call, name="drive", start=start,
                end=start + 4.0, sums={}, counters=dict(base, **counters))


def synthetic_log(with_counters=True):
    """Two runner calls of one drive each (T160- and T512-like): counts
    chosen so that every reader's value is worked out by hand below."""
    new = ([dict(slot_busy=40960, frontier_peak=1184, flow_cap=2368,
                 edge_lanes=360 * 2368, valid_edges=120 * (406 + 406 + 2352)),
            dict(slot_busy=20480, frontier_peak=124, flow_cap=992,
                 edge_lanes=360 * 992, valid_edges=120 * (600 + 974 + 871))]
           if with_counters else [{}, {}])
    recs = []
    for k, (t, extra) in enumerate(zip((10.0, 20.0), new)):
        c = 100 * k
        recs += [dict(call=c, id=c, parent=None, name="grid_call", start=t,
                      end=t + 5.0),
                 _drive(c, c + 1, t + 0.5, **extra)]
    return recs


ROW_STEPS = (800, 1200)       # Σ rows' n_steps of the two calls
# slot_busy / (Σ n_steps x 4 x W): 61440 / (2000 x 128)
READERS = {
    "slot_use.irw": 61440 / (2000 * 4 * 32),
    # the larger of 1184 / 2368 and 124 / 992
    "frontier_fill.irw": 0.5,
    "pad_lane_share.irw": 1.0 - 120 * (3164 + 2445) / (360 * (2368 + 992)),
}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_cell_reader_on_a_synthetic_log(metric, monkeypatch):
    read = prun.reader(metric, ROOT / "perfbench")
    state = dict(log=synthetic_log(), dropped=0)

    def log(t0, t1):
        return ([r for r in state["log"] if t0 <= r["start"] <= t1],
                state["dropped"])
    monkeypatch.setattr(bench, "program", lambda: (
        None, types.SimpleNamespace(span_log=log), None))
    calls = [dict(rows=360, ok=360, row_steps=s) for s in ROW_STEPS]
    run = dict(kind="grid", window=(5.0, 30.0), calls=calls, W=32,
               trace=None)
    assert read(run) == pytest.approx(READERS[metric], rel=1e-12)
    assert 0.0 < read(run) < 1.0
    # nothing to read: a program without the counters (an older one),
    # another traffic kind, calls let go inside the window, no span log
    state["log"] = synthetic_log(with_counters=False)
    assert read(run) is None
    state["log"] = synthetic_log()
    assert read(dict(run, kind="proto")) is None
    state["dropped"] = 1
    assert read(run) is None
    monkeypatch.setattr(bench, "program",
                        lambda: (None, types.SimpleNamespace(), None))
    assert read(run) is None
