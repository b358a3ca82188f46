"""Tests of the port that need an NVIDIA card: the CUDA kernels (the
waterfill K1, flash attention K2 on each of its routes and head dims,
the SSD scan K3 whole and each of its three kernels alone, greedy's
placement, the static list schedule) against
their plain PyTorch versions, their launch counters and checks, the
dynamic and static simulators and the LM serving path through the
kernels against the plain versions, the gradients of K2 and K3 (the
kernel forward, the plain backward) and a training loss and gradient
through them, and the simulators' event step replayed from a CUDA graph
against the eager step.  They are marked ``cuda`` and skip when no card
is present; on a card run
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    return torch.device("cuda")


def flow_sets(seed, R, W, F, device):
    rng = np.random.default_rng(seed)
    out = (rng.integers(0, W, (R, F)).astype(np.int32),
           rng.integers(0, W, (R, F)).astype(np.int32),
           rng.random((R, F)) < 0.6,
           rng.uniform(50, 150, (R, W)).astype(np.float32))
    return [torch.as_tensor(x, device=device) for x in out]


@pytest.mark.parametrize("W", [1, 8, 32, 256])
def test_kernel_equals_plain_version_bitwise(dev, W):
    from repro_torch.core.vectorized.waterfill import waterfill as plain
    from repro_torch.kernels.waterfill import waterfill
    src, dst, active, caps = flow_sets(W, 512, W, 4 * W, dev)
    got = waterfill(src, dst, active, caps, caps)
    want = plain(src, dst, active, caps, caps)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_kernel_counts_launches_and_checks_inputs(dev):
    from repro_torch.kernels import WATERFILL_LAUNCHES
    from repro_torch.kernels.waterfill import waterfill
    src, dst, active, caps = flow_sets(1, 8, 4, 16, dev)
    before = WATERFILL_LAUNCHES.count
    waterfill(src, dst, active, caps, caps)
    assert WATERFILL_LAUNCHES.count == before + 1
    with pytest.raises(TypeError, match="int32"):
        waterfill(src.long(), dst, active, caps, caps)
    # 2W resources must fit one block's threads; F no longer needs to
    # (the per-edge simulator solves F = E flows)
    with pytest.raises(ValueError, match="exceed"):
        wide = flow_sets(2, 2, 513, 8, dev)
        waterfill(wide[0], wide[1], wide[2], wide[3], wide[3])
    big = flow_sets(2, 2, 4, 2048, dev)
    got = waterfill(big[0], big[1], big[2], big[3], big[3])
    torch.cuda.synchronize()
    assert torch.equal(got, waterfill_plain_of(*big))


def waterfill_case(name, W, device):
    """Inputs ``(src, dst, active, caps, max_rounds)`` of one named K1
    case at ``W`` workers, ``F = 4W`` flows."""
    F = 4 * W
    src, dst, active, caps = flow_sets(W + 100, 8, W, F, "cpu")
    max_rounds = None
    if name == "all_inactive":
        active[:] = False
    elif name == "single_source":
        src[:] = 0
        dst[:] = torch.from_numpy(1 + np.arange(F) % max(W - 1, 1)) % W
        active[:] = True
        caps[:] = 90.0
    elif name == "equal_share_ties":
        src[:] = torch.arange(F) % W
        dst[:] = (src + 1) % W
        active[:] = True
        caps[:] = 64.0
    elif name == "ids_out_of_range":
        src[:, ::3] = torch.from_numpy(np.where(np.arange(8)[:, None] % 2,
                                                W, -1).astype(np.int32))
        dst[:, 1::3] = W + 3
    elif name == "max_rounds_2":
        max_rounds = 2
    elif name in ("rows_1", "rows_7"):     # R off the 4 rows per block
        src, dst, active, caps = flow_sets(W + 200, int(name[5:]), W, F,
                                           "cpu")
    return [x.to(device) for x in (src, dst, active, caps)] + [max_rounds]


def waterfill_plain_of(src, dst, active, caps, max_rounds=None):
    """The plain version, with flows whose ids fall outside ``[0, W)``
    made inactive (what the kernels do with them)."""
    from repro_torch.core.vectorized.waterfill import waterfill as plain
    W = caps.shape[1]
    inside = (src >= 0) & (src < W) & (dst >= 0) & (dst < W)
    return plain(src.clamp(0, W - 1), dst.clamp(0, W - 1), active & inside,
                 caps, caps, max_rounds)


# greedy's placement kernel: (graphs, rows, workers, place_inputs options)
PLACE_CASES = {
    "t160_r360_w16": ("T160", 360, 16, {}),
    "t512_r240_w16": ("T512", 240, 16, {}),
    "t512_r1800_w32": ("T512", 1800, 32, {}),
    "t512_w40_stride": ("T512", 240, 40, {}),
    "ties": ("T160", 360, 16, dict(ties=True)),
    "fit_none": ("T160", 96, 16, dict(fit_none=True)),
    "nothing_placing": ("T512", 96, 16, dict(p_place=0.0)),
    "d0": ("T160", 96, 16, dict(ties=True)),
}


@pytest.mark.parametrize("case", sorted(PLACE_CASES))
def test_greedy_place_kernel_equals_plain_version_bitwise(dev, case):
    """The kernel's proposed workers and placer-iteration tally equal
    the plain version's on the card, bit for bit; a second launch adds
    the same count again (its scratch was left at 0).  The T160 rows
    hold cybershake's 80-input task, placing in every other row."""
    import test_torch_greedy_place as tg
    from repro_torch.core.vectorized.scheduling import greedy_place_plain
    from repro_torch.kernels.greedy_place import greedy_place
    bucket, R, W, kw = PLACE_CASES[case]
    g, args = tg.place_inputs(*getattr(tg, bucket), R, W, seed=len(case),
                              device=dev, **kw)
    args = list(args)
    if case == "d0":
        args[1] = args[1][:, :, :0].contiguous()
    if bucket == "T160":
        assert (args[1] >= 0).sum(dim=2).amax() == 80 or case == "d0"
    want_tally = torch.zeros(3, dtype=torch.int64, device=dev)
    want = greedy_place_plain(*args[:8], want_tally)
    got = greedy_place(*args)
    again = greedy_place(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(again, want)
    n = int(want_tally[0])
    assert args[8].tolist() == [2 * n, 0, 0]
    assert n == int(args[0].sum(dim=1).amax())


def test_greedy_place_counts_launches_and_checks_inputs(dev):
    import test_torch_greedy_place as tg
    from repro_torch.kernels import GREEDY_PLACE_LAUNCHES
    from repro_torch.kernels.greedy_place import greedy_place
    _, args = tg.place_inputs(*tg.T160, 8, 16, seed=2, device=dev)
    before = GREEDY_PLACE_LAUNCHES.count
    greedy_place(*args)
    assert GREEDY_PLACE_LAUNCHES.count == before + 1
    bad = list(args)
    bad[7] = args[7].int()
    with pytest.raises(TypeError, match="load0"):
        greedy_place(*bad)
    _, wide = tg.place_inputs(*tg.T160, 2, 513, seed=2, device=dev)
    with pytest.raises(ValueError, match="exceed"):
        greedy_place(*wide)
    assert GREEDY_PLACE_LAUNCHES.count == before + 1


# the list schedule's card cases: (graphs, clusters, rows, bucket shape);
# the benchmark cells' shapes, a single-row request of each pegasus
# bucket, irw's T160 bucket at E 2368 and a T2048 bucket
LIST_CASES = {
    "t512_r1800_w32": (("fork1", "size_stairs", "grid", "fern"),
                       ("32x4", "32x16"), 1800, (512, 416, 704)),
    "t160_r120_w32": (("merge_triplets",), ("32x4", "32x16"), 120,
                      (160, 128, 128)),
    "t160_r1_w16": (("montage",), ("16x8",), 1, (160, 160, 224)),
    "t512_r1_w16": (("epigenomics",), ("16x4",), 1, (512, 320, 320)),
    "irw_t160_r360_w32": (("crossv", "fastcrossv", "mapreduce48"),
                          ("32x4", "32x16"), 360, (160, 2368, 2368)),
    "t2048_r8_w32": (("random2048",), ("32x4", "1x8+4x2"), 8,
                     (2048, 2528, 2720)),
}


def list_inputs(case, dev, seed=0):
    """``test_torch_list_schedule.schedule_inputs`` of a ``LIST_CASES``
    case on ``dev``: ``(g, args)``."""
    import test_torch_list_schedule as tl
    graphs, clusters, R, shape = LIST_CASES[case]
    return tl.schedule_inputs(graphs, clusters, R, seed, device=dev,
                              shape=shape)


@pytest.mark.parametrize("order", ["blevel", "tlevel", "mcp"])
@pytest.mark.parametrize("case", sorted(LIST_CASES))
def test_list_schedule_kernel_equals_plain_version_bitwise(dev, case,
                                                           order):
    """The kernel's assignment and priorities equal the plain version's
    on the card, bit for bit, and so do greedy's priorities alone (the
    ``blevel`` ones); each call is one launch."""
    from repro_torch.core.vectorized.scheduling import (
        blevel_priorities_plain, list_schedule_plain)
    from repro_torch.kernels import LIST_SCHEDULE_LAUNCHES as L
    from repro_torch.kernels.list_schedule import (blevel_priorities,
                                                   list_schedule)
    g, args = list_inputs(case, dev, seed=len(case))
    *tensors, C = args
    want = list_schedule_plain(order, *tensors, C)
    before = dict(L.routes)
    got = list_schedule(order, *tensors, C)
    torch.cuda.synchronize()
    assert L.routes["place"] == before["place"] + 1
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    if order == "blevel":
        prio = blevel_priorities(g.e_task, g.prod_e, g.edge_valid,
                                 tensors[5])
        torch.cuda.synchronize()
        assert L.routes["priorities"] == before["priorities"] + 1
        assert torch.equal(prio, want[1])
        assert torch.equal(prio, blevel_priorities_plain(
            g.e_task, g.prod_e, g.edge_valid, tensors[5]))


def test_list_schedule_checks_its_inputs_on_the_card(dev):
    from repro_torch.kernels import LIST_SCHEDULE_LAUNCHES as L
    from repro_torch.kernels.list_schedule import list_schedule
    _, args = list_inputs("t160_r1_w16", dev)
    *tensors, C = args
    before = L.count
    with pytest.raises(ValueError, match="max_cores"):
        list_schedule("blevel", *tensors, 33)
    bad = list(tensors)
    bad[8] = torch.zeros(1, 513, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="workers"):
        list_schedule("blevel", *bad, C)
    bad = list(tensors)
    bad[6] = tensors[6].cpu()
    with pytest.raises(ValueError, match="several devices"):
        list_schedule("blevel", *bad, C)
    assert L.count == before


@pytest.mark.parametrize("sched", ["blevel", "tlevel", "mcp", "greedy"])
def test_each_simulator_call_launches_the_schedule_once(dev, sched):
    """A grid runner call launches the schedule's kernel once a
    simulator call, and each drive record counts its own launch."""
    import time
    from repro_torch.core import MiB
    from repro_torch.core.graphs import encode_graph_batch, survey_names
    from repro_torch.core.vectorized import make_grid_runner, span_log
    from repro_torch.kernels import LIST_SCHEDULE_LAUNCHES as L
    encoded, groups = encode_graph_batch(survey_names(1), bucket=True)
    grp = groups[0]
    run = make_grid_runner([encoded[n] for n in grp.names], sched, 8,
                           [4] * 8, shape=grp.shape, batch=grp.batch,
                           device=dev)
    before = dict(L.routes)
    t0 = time.perf_counter()
    res = run([dict(bandwidth=64 * MiB)])
    recs, _ = span_log(t0, time.perf_counter())
    assert bool(res.ok.all())
    drives = [r for r in recs if r["name"] == "drive"]
    mode = "priorities" if sched == "greedy" else "place"
    assert L.routes[mode] - before[mode] == len(drives) >= 1
    assert all(r["counters"]["schedule_launches"] == 1 for r in drives)


@pytest.mark.parametrize("route", ["warp", "block"])
@pytest.mark.parametrize("W", [1, 8, 16, 32])
def test_each_waterfill_route_equals_plain_version_bitwise(dev, route, W):
    from repro_torch.kernels import waterfill as wk
    src, dst, active, caps = flow_sets(W + 7, 1024, W, 4 * W, dev)
    got = wk._waterfill(src, dst, active, caps, caps, route=route)
    want = waterfill_plain_of(src, dst, active, caps)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("route", ["warp", "block"])
@pytest.mark.parametrize("case", ["all_inactive", "single_source",
                                  "equal_share_ties", "ids_out_of_range",
                                  "max_rounds_2", "rows_1", "rows_7"])
@pytest.mark.parametrize("W", [4, 32])
def test_waterfill_routes_on_edge_cases_bitwise(dev, route, case, W):
    from repro_torch.kernels import waterfill as wk
    src, dst, active, caps, max_rounds = waterfill_case(case, W, dev)
    got = wk._waterfill(src, dst, active, caps, caps, max_rounds,
                        route=route)
    want = waterfill_plain_of(src, dst, active, caps, max_rounds)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if case == "all_inactive":
        assert not got.any()


def test_waterfill_block_route_at_w64_f256(dev):
    from repro_torch.kernels import waterfill as wk
    src, dst, active, caps = flow_sets(64, 300, 64, 256, dev)
    assert wk.route_for(256, 64) == "block"
    for max_rounds in (None, 5):
        got = wk._waterfill(src, dst, active, caps, caps, max_rounds,
                            route="block")
        want = waterfill_plain_of(src, dst, active, caps, max_rounds)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="warp route"):
        wk._waterfill(src, dst, active, caps, caps, route="warp")


@pytest.mark.parametrize("F", [992, 1024, 1025, 2016])
def test_waterfill_block_route_past_one_block_of_flows(dev, F):
    """The per-edge simulator's solve: F = E flows per row (992 at the
    T512 bucket, 2016 at T2048), more than one block's threads."""
    from repro_torch.kernels import waterfill as wk
    src, dst, active, caps = flow_sets(F, 96, 32, F, dev)
    assert wk.route_for(F, 32) == "block"
    for max_rounds in (None, 3):
        got = wk._waterfill(src, dst, active, caps, caps, max_rounds)
        want = waterfill_plain_of(src, dst, active, caps, max_rounds)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    s2, d2, a2, c2, _ = waterfill_case("ids_out_of_range", 32, dev)
    reps = -(-F // s2.shape[1])
    s2, d2, a2 = (x.repeat(1, reps)[:, :F].contiguous() for x in (s2, d2, a2))
    got = wk._waterfill(s2, d2, a2, c2, c2)
    torch.cuda.synchronize()
    assert torch.equal(got, waterfill_plain_of(s2, d2, a2, c2))


@pytest.mark.parametrize("F,W,route", [(128, 32, "warp"), (20, 5, "warp"),
                                       (129, 32, "block"),
                                       (128, 33, "block")])
def test_waterfill_counts_launches_by_route(dev, F, W, route):
    from repro_torch.kernels import WATERFILL_LAUNCHES as K1
    from repro_torch.kernels.waterfill import waterfill
    src, dst, active, caps = flow_sets(F, 5, W, F, dev)
    before, routes = K1.count, dict(K1.routes)
    waterfill(src, dst, active, caps, caps)
    torch.cuda.synchronize()
    assert K1.count == before + 1
    routes[route] += 1
    assert K1.routes == routes


def test_simulator_through_the_kernel_equals_the_plain_version(dev):
    from repro_torch.core import MiB
    from repro_torch.core.graphs import encode_graph_batch, survey_names
    from repro_torch.core.vectorized import make_grid_runner
    encoded, groups = encode_graph_batch(survey_names(1), bucket=True)
    grp = groups[0]
    points = [dict(bandwidth=32 * MiB, imode="user", msd=0.1,
                   decision_delay=0.05)]
    out = {}
    for impl in ("auto", "torch"):
        runner = make_grid_runner([encoded[n] for n in grp.names],
                                  "greedy", 8, [4] * 8, shape=grp.shape,
                                  batch=grp.batch, device=dev,
                                  waterfill_impl=impl)
        out[impl] = runner(points)
    for f in out["auto"]._fields:
        assert np.array_equal(getattr(out["auto"], f),
                              getattr(out["torch"], f)), f


def test_static_simulator_through_the_kernel_equals_the_plain_version(dev):
    """The static simulator at W 32 (the warp route's widest shape):
    rows of random schedules through K1 and through the plain waterfill
    on the card, bitwise equal in every field."""
    from repro_torch.core.graphs import make_graph
    from repro_torch.core.vectorized import build
    from repro_torch.core.vectorized.specs import encode_graph
    from repro_torch.kernels import WATERFILL_LAUNCHES
    spec = encode_graph(make_graph("fastcrossv", seed=0))
    rng = np.random.default_rng(0)
    A = rng.integers(0, 32, (16, spec.T)).astype(np.int32)
    P = rng.uniform(1, 100, (16, spec.T)).astype(np.float32)
    out, launches = {}, {}
    for impl in ("auto", "torch"):
        before = WATERFILL_LAUNCHES.count
        out[impl] = build(spec, n_workers=32, cores=4, device=dev,
                          waterfill_impl=impl)(A, P)
        torch.cuda.synchronize()
        launches[impl] = WATERFILL_LAUNCHES.count - before
    assert launches["auto"] > 0 and launches["torch"] == 0
    assert bool(out["auto"].ok.all())
    for f in out["auto"]._fields:
        assert torch.equal(getattr(out["auto"], f),
                           getattr(out["torch"], f)), f


def _step_graph_runs(run, modes=("eager", "graph")):
    """``{mode: (result, K1 launches, capture_counter)}`` of ``run(mode)``
    with the event step eager and replayed from a CUDA graph; the
    greedy placement kernel's launches of each mode land in
    ``_step_graph_runs.placements[mode]``."""
    from repro_torch.core.vectorized import capture_counter
    from repro_torch.kernels import (GREEDY_PLACE_LAUNCHES,
                                     WATERFILL_LAUNCHES)
    out = {}
    _step_graph_runs.placements = {}
    for mode in modes:
        WATERFILL_LAUNCHES.reset()
        GREEDY_PLACE_LAUNCHES.reset()
        with capture_counter() as cc:
            res = run(mode)
        torch.cuda.synchronize()
        out[mode] = (res, WATERFILL_LAUNCHES.count, cc)
        _step_graph_runs.placements[mode] = GREEDY_PLACE_LAUNCHES.count
    return out


@pytest.mark.parametrize("netmodel", ["maxmin", "simple"])
@pytest.mark.parametrize("sched", ["blevel", "greedy"])
def test_step_graph_equals_eager_bitwise_with_one_capture(dev, sched,
                                                          netmodel):
    """The dynamic simulator with its event step replayed from a CUDA
    graph (greedy's placement kernel inside it, no prologue): every
    field bitwise the eager run's, one capture per simulator call (one
    per chunk when streamed), as many K1 launches, and for greedy as
    many placement launches, one a step, and as many placer
    iterations."""
    from repro_torch.core import MiB
    from repro_torch.core.graphs import encode_graph_batch, survey_names
    from repro_torch.core.vectorized import make_grid_runner
    encoded, groups = encode_graph_batch(survey_names(1), bucket=True)
    grp = groups[0]
    points = [dict(bandwidth=32 * MiB, imode="user", msd=0.1,
                   decision_delay=0.05),
              dict(bandwidth=256 * MiB, imode="exact", msd=0.0)]
    for engine, calls in (("vmap", 1), ("sharded", 3)):
        runs = _step_graph_runs(lambda mode: make_grid_runner(
            [encoded[n] for n in grp.names], sched, 8, [4] * 8,
            netmodel=netmodel, shape=grp.shape, batch=grp.batch, device=dev,
            step_graph=mode, engine=engine,
            stream_rows=3 if engine == "sharded" else None)(points))
        (eager, n_eager, c_eager), (graph, n_graph, c_graph) = \
            runs["eager"], runs["graph"]
        for f in eager._fields:
            assert np.array_equal(getattr(eager, f), getattr(graph, f)), \
                (engine, f)
        assert c_eager.calls == c_graph.calls == calls
        assert c_eager.captures == 0 and c_graph.captures == calls
        assert c_graph.replays > 0
        assert n_graph == n_eager
        assert (n_graph > 0) == (netmodel == "maxmin")
        assert "prologue" not in c_graph.spans
        place = _step_graph_runs.placements
        assert place["graph"] == place["eager"]
        assert c_graph.place_iters == c_eager.place_iters
        if sched == "greedy":
            assert place["graph"] == c_graph.calls + c_graph.replays > 0
            assert c_graph.place_iters > 0
        else:
            assert place["graph"] == 0 == c_graph.place_iters


def test_static_step_graph_equals_eager_bitwise(dev):
    """The static simulator at W 32 through K1 and through the plain
    waterfill (all its rounds inside the graph): graph and eager runs
    bitwise equal, one capture per call, equal K1 launches."""
    from repro_torch.core.graphs import make_graph
    from repro_torch.core.vectorized import build
    from repro_torch.core.vectorized.specs import encode_graph
    spec = encode_graph(make_graph("fastcrossv", seed=0))
    rng = np.random.default_rng(1)
    A = rng.integers(0, 32, (16, spec.T)).astype(np.int32)
    P = rng.uniform(1, 100, (16, spec.T)).astype(np.float32)
    for impl in ("auto", "torch"):
        runs = _step_graph_runs(lambda mode: build(
            spec, n_workers=32, cores=4, device=dev, waterfill_impl=impl,
            step_graph=mode)(A, P))
        (eager, n_eager, c_eager), (graph, n_graph, c_graph) = \
            runs["eager"], runs["graph"]
        assert bool(graph.ok.all())
        for f in eager._fields:
            assert torch.equal(getattr(eager, f), getattr(graph, f)), \
                (impl, f)
        assert c_graph.captures == c_graph.calls == 1
        assert n_graph == n_eager and (n_graph > 0) == (impl == "auto")


def test_step_graph_auto_captures_on_the_card(dev):
    """``step_graph="auto"`` (the default) replays from a graph on the
    card: one capture per call, every call's graph freed after it."""
    from repro_torch.core.graphs import make_graph
    from repro_torch.core.vectorized import build, capture_counter
    from repro_torch.core.vectorized.specs import encode_graph
    spec = encode_graph(make_graph("fastcrossv", seed=0))
    A = np.zeros((4, spec.T), np.int32)
    P = np.ones((4, spec.T), np.float32)
    run = build(spec, n_workers=4, cores=4, device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    with capture_counter() as cc:
        for _ in range(3):
            res = run(A, P)
            del res
    torch.cuda.synchronize()
    assert cc.calls == cc.captures == 3
    # no graph pool outlives its call
    assert torch.cuda.memory_allocated(dev) <= base + (1 << 20)



@pytest.mark.parametrize("sched", ["blevel", "greedy"])
def test_spans_of_a_runner_call_on_the_card(dev, sched):
    """The span record of one runner call replayed from a CUDA graph:
    eager step 0, one capture, one replay a later step (greedy too: no
    prologue, and no ``place`` span inside the captured step), the graph
    freed, the per-step spans inside the loop, the
    schedule's stream time from its CUDA events once the call's results
    are on the host, and the counters the replayed step keeps on the
    card (greedy's placer iterations, the flow path's occupied slots
    and fullest frontier) equal to the eager CPU run's on the same
    rows."""
    import time
    from repro_torch.core import MiB
    from repro_torch.core.graphs import encode_graph_batch, survey_names
    from repro_torch.core.vectorized import (capture_counter,
                                             make_grid_runner, span_log)
    encoded, groups = encode_graph_batch(survey_names(1), bucket=True)
    grp = groups[0]
    points = [dict(bandwidth=32 * MiB, imode="user", msd=0.1,
                   decision_delay=0.05),
              dict(bandwidth=256 * MiB, imode="exact", msd=0.0)]
    run = make_grid_runner([encoded[n] for n in grp.names], sched, 8,
                           [4] * 8, shape=grp.shape, batch=grp.batch,
                           device=dev)
    t0 = time.perf_counter()
    with capture_counter() as cc:
        res = run(points)
    recs, dropped = span_log(t0, time.perf_counter())
    assert dropped == 0 and bool(res.ok.all())
    names = {r["name"]: r for r in recs}
    assert {"grid_call", "rows_in", "prepare", "schedule", "drive", "loop",
            "step0", "capture", "free", "results_out"} == set(names)
    assert len(recs) == len(names)
    d = names["drive"]
    c = d["counters"]
    assert c["calls"] == cc.calls == 1
    assert c["captures"] == cc.captures == 1
    assert c["replays"] == cc.replays == d["sums"]["replay"][0] > 0
    steps = c["replays"] + 1
    assert c["polls"] == d["sums"]["poll"][0] == steps // 16 + 1
    assert steps % 16 == 0 and int(res.n_steps.max()) <= steps
    assert "prologue" not in d["sums"] and "place" not in d["sums"]
    cpu = make_grid_runner([encoded[n] for n in grp.names], sched, 8,
                           [4] * 8, shape=grp.shape, batch=grp.batch,
                           device="cpu")
    t0 = time.perf_counter()
    with capture_counter() as plain:
        cpu(points)
    (eager,) = [r["counters"] for r in span_log(t0, time.perf_counter())[0]
                if r["name"] == "drive"]
    for key in ("slot_busy", "frontier_peak", "flow_cap", "edge_lanes",
                "valid_edges", "place_iters"):
        assert c[key] == eager[key], key
    assert c["slot_busy"] > 0 and c["frontier_peak"] > 0
    if sched == "greedy":
        assert c["place_iters"] == cc.place_iters == plain.place_iters > 0
    else:
        assert c["place_iters"] == 0
    loop = names["loop"]
    inside = sum(names[n]["end"] - names[n]["start"]
                 for n in ("step0", "capture")) + sum(
        d["sums"].get(n, (0, 0.0))[1] for n in ("replay", "poll"))
    assert inside <= loop["end"] - loop["start"]
    assert 0.0 < names["schedule"]["device_s"] < 60.0
    assert c["schedule_launches"] == 1

ATTN = [  # B, Hq, Hkv, Sq, Skv, D, causal, window, kv_len
    (2, 25, 5, 64, 80, 64, True, 16, 64),
    (2, 25, 5, 1, 80, 64, True, 16, 70),
    (1, 8, 1, 37, 37, 32, True, 0, 37),
    (1, 4, 1, 50, 60, 256, True, 8, 55),
    (2, 4, 2, 20, 20, 16, False, 0, 20),
    # the edges of the bf16 routes: Sq, Skv and kv_len off the 64-key
    # tile, a window ending inside a tile, kv_len < Skv at prefill ...
    (2, 8, 2, 1000, 1100, 64, True, 100, 1030),
    (1, 8, 2, 600, 650, 256, True, 100, 630),
    # ... decode at kv_len 1, with one split, with several, and with
    # more than 8 query heads per kv head
    (4, 25, 5, 1, 1568, 64, True, 0, 1),
    (4, 25, 5, 1, 1568, 64, True, 0, 30),
    (4, 25, 5, 1, 1568, 64, True, 1024, 1552),
    (1, 12, 1, 1, 300, 256, True, 0, 250),
    # head dims 128 and 160 on every route (prefill: tc or f32; decode:
    # split or f32), D 160 also off the tile and with a window
    (1, 16, 2, 130, 140, 128, True, 0, 135),
    (2, 16, 2, 1, 300, 128, True, 100, 290),
    (1, 8, 2, 100, 130, 160, True, 40, 120),
    (1, 12, 1, 1, 300, 160, True, 0, 250),
    # cross-attention: non-causal, a prompt longer than the encoder's
    # tokens (Sq > kv_len), and its decode
    (2, 8, 2, 100, 40, 128, False, 0, 40),
    (2, 8, 2, 1, 40, 128, False, 0, 40),
]


@pytest.mark.parametrize("case", ATTN)
@pytest.mark.parametrize("dtype,tol", [("float32", (1e-5, 1e-5)),
                                       ("bfloat16", (4e-3, 8e-3))])
def test_flash_attention_kernel_matches_plain_version(dev, case, dtype,
                                                      tol):
    from repro_torch.kernels import FLASH_ATTENTION_LAUNCHES, ref
    from repro_torch.kernels.flash_attention import flash_attention
    B, Hq, Hkv, Sq, Skv, D, causal, window, kv_len = case
    g = torch.Generator(device=dev).manual_seed(sum(case))
    dt = getattr(torch, dtype)
    q = torch.randn(B, Hq, Sq, D, generator=g, device=dev).to(dt)
    # the KV cache's layout [B, S, Hkv, D], seen as [B, Hkv, S, D]
    k = torch.randn(B, Skv, Hkv, D, generator=g, device=dev).to(dt)
    v = torch.randn(B, Skv, Hkv, D, generator=g, device=dev).to(dt)
    kw = dict(causal=causal, window=window, kv_len=kv_len)
    before = FLASH_ATTENTION_LAUNCHES.count
    got = flash_attention(q, k.transpose(1, 2), v.transpose(1, 2), **kw)
    assert FLASH_ATTENTION_LAUNCHES.count == before + 1
    want = ref.attention_ref(q, k.transpose(1, 2), v.transpose(1, 2), **kw)
    torch.cuda.synchronize()
    assert got.dtype == dt
    torch.testing.assert_close(got.float(), want.float(), atol=tol[0],
                               rtol=tol[1])


@pytest.mark.parametrize("dtype,Sq,route", [("float32", 1, "f32"),
                                            ("float32", 40, "f32"),
                                            ("bfloat16", 1, "split"),
                                            ("bfloat16", 40, "tc")])
def test_flash_attention_counts_one_launch_per_call_by_route(dev, dtype,
                                                             Sq, route):
    from repro_torch.kernels import FLASH_ATTENTION_LAUNCHES as FA
    from repro_torch.kernels.flash_attention import flash_attention
    g = torch.Generator(device=dev).manual_seed(Sq)
    dt = getattr(torch, dtype)
    q = torch.randn(2, 10, Sq, 64, generator=g, device=dev).to(dt)
    k, v = (torch.randn(2, 2, 48, 64, generator=g, device=dev).to(dt)
            for _ in range(2))
    before, routes = FA.count, dict(FA.routes)
    flash_attention(q, k, v, window=16, kv_len=45)
    torch.cuda.synchronize()
    assert FA.count == before + 1
    routes[route] += 1
    assert FA.routes == routes


@pytest.mark.parametrize("Bt,L,H,P,N", [(2, 128, 3, 64, 16),
                                        (1, 96, 2, 16, 128),
                                        (1, 64, 4, 32, 8)])
def test_ssd_kernel_matches_plain_version(dev, Bt, L, H, P, N):
    from repro_torch.kernels import SSD_LAUNCHES, ref
    from repro_torch.kernels.ssd import ssd_scan
    g = torch.Generator(device=dev).manual_seed(L * H)
    x = torch.randn(Bt, L, H, P, generator=g, device=dev)
    dt = 0.001 + 0.099 * torch.rand(Bt, L, H, generator=g, device=dev)
    A = -(0.5 + 1.5 * torch.rand(H, generator=g, device=dev))
    B, C = (torch.randn(Bt, L, N, generator=g, device=dev)
            for _ in range(2))
    D = torch.randn(H, generator=g, device=dev)
    before = SSD_LAUNCHES.count
    y, state = ssd_scan(x, dt, A, B, C, D, chunk=32, return_state=True)
    assert SSD_LAUNCHES.count == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(y, ref.ssd_chunked(x, dt, A, B, C, D,
                                                  chunk=32),
                               atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(state, ref.ssd_final_state(x, dt, A, B),
                               atol=1e-4, rtol=1e-4)
    with pytest.raises(TypeError, match="float32"):
        ssd_scan(x.double(), dt, A, B, C, D, chunk=32)


SSD_PHASE_CASES = [
    # Bt, L, H, P, N, chunk, (A, dt) held constant or None
    (2, 64, 6, 64, 16, 64, None),          # one chunk
    (2, 256, 10, 64, 16, 32, None),        # chunk 32
    (1, 128, 3, 32, 128, 64, None),        # N 128
    (4, 512, 53, 64, 16, 64, None),        # a short last head group
    (2, 512, 12, 16, 16, 64, None),        # P 16
    (2, 256, 8, 64, 16, 64, (-8.0, 0.1)),  # Γ overflows above the diagonal
    (2, 36, 3, 10, 6, 9, None),            # Q, P, N off the tiles
    (2, 8, 4, 16, 8, 64, None),            # the smoke serve's L 8
]


@pytest.mark.parametrize("case", SSD_PHASE_CASES)
def test_ssd_phase_kernels_match_their_plain_pieces(dev, case):
    from repro_torch.kernels import SSD_LAUNCHES, ref
    from repro_torch.kernels import ssd as sk
    Bt, L, H, P, N, chunk, decay = case
    g = torch.Generator(device=dev).manual_seed(L + H)
    x = torch.randn(Bt, L, H, P, generator=g, device=dev)
    dt = 0.001 + 0.099 * torch.rand(Bt, L, H, generator=g, device=dev)
    A = -(0.5 + 1.5 * torch.rand(H, generator=g, device=dev))
    if decay is not None:
        A, dt = torch.full_like(A, decay[0]), torch.full_like(dt, decay[1])
    B, C = (torch.randn(Bt, L, N, generator=g, device=dev)
            for _ in range(2))
    D = torch.randn(H, generator=g, device=dev)
    tol = dict(atol=1e-4, rtol=1e-4)
    S_ref, tot_ref = ref.ssd_chunk_states(x, dt, A, B, chunk=chunk)
    h_ref, fin_ref = ref.ssd_pass_states(S_ref, tot_ref)
    before = SSD_LAUNCHES.count
    S, tot = sk.chunk_states(x, dt, A, B, chunk=chunk)
    h_in, fin = sk.pass_states(S_ref, tot_ref)
    y = sk.chunk_scan(x, dt, A, B, C, D, h_ref, chunk=chunk)
    assert SSD_LAUNCHES.count == before      # the phases alone: not counted
    torch.cuda.synchronize()
    torch.testing.assert_close(S, S_ref, **tol)
    torch.testing.assert_close(tot, tot_ref, **tol)
    torch.testing.assert_close(h_in, h_ref, **tol)
    torch.testing.assert_close(fin, fin_ref, **tol)
    torch.testing.assert_close(
        y, ref.ssd_chunk_scan(x, dt, A, B, C, D, h_ref, chunk=chunk), **tol)
    y, state = sk.ssd_scan(x, dt, A, B, C, D, chunk=chunk, return_state=True)
    assert SSD_LAUNCHES.count == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(y, ref.ssd_chunked(x, dt, A, B, C, D,
                                                  chunk=chunk), **tol)
    torch.testing.assert_close(state, ref.ssd_final_state(x, dt, A, B),
                               **tol)


@pytest.mark.parametrize("arch,kw", [
    ("hymba-1.5b", {}), ("mamba2-130m", {}), ("gemma3-1b", {}),
    ("chatglm3-6b", {}), ("qwen3-32b", dict(kv_cache_dtype="int8")),
    ("stablelm-12b", {}), ("mixtral-8x22b", {}),
    ("mixtral-8x22b", dict(moe_dispatch="gather")),
    ("llama4-scout-17b-a16e", {}), ("llama-3.2-vision-11b", {}),
    ("musicgen-large", {})])
def test_serving_through_the_kernels_matches_the_plain_path(dev, arch, kw):
    from repro_torch.configs import smoke_config
    from repro_torch.launch.serve import make_inputs
    from repro_torch.models import decode_step, init_params, prefill
    cfg = smoke_config(arch, **kw)
    g = torch.Generator(device=dev).manual_seed(0)
    model = init_params(cfg, g, device=dev)
    for layer in model.cross_layers:
        layer.attn["gate"].data.fill_(0.5)
    toks, vision = make_inputs(cfg, 2, 36, g, dev)
    out = {}
    for impl in ("auto", "torch"):
        lg, cache, pos = prefill(model, toks[:, :32], cache_len=36,
                                 impl=impl, vision=vision)
        logits = [lg]
        for i in range(4):
            lg, cache, pos = decode_step(model, toks[:, 32 + i:33 + i],
                                         cache, pos, impl=impl)
            logits.append(lg)
        out[impl] = torch.cat(logits, dim=1)
    torch.testing.assert_close(out["auto"], out["torch"], atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_gradient_goes_through_the_kernel_and_the_plain_backward(
        dev, dtype):
    from repro_torch.kernels import FLASH_ATTENTION_LAUNCHES as FA
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device=dev).manual_seed(11)
    dt = getattr(torch, dtype)
    q = torch.randn(2, 10, 96, 64, generator=g, device=dev).to(dt)
    k, v = (torch.randn(2, 2, 96, 64, generator=g, device=dev).to(dt)
            for _ in range(2))
    gout = torch.randn(2, 10, 96, 64, generator=g, device=dev).to(dt)
    kw = dict(causal=True, window=40)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = FA.count
    out = ops.attention(*leaves, **kw)
    assert FA.count == before + 1
    got = torch.autograd.grad(out, leaves, gout)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.attention_ref(*plain, **kw), plain, gout)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == dt
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_ssd_gradient_goes_through_the_kernel_and_the_plain_backward(dev):
    from repro_torch.kernels import SSD_LAUNCHES, ops, ref
    g = torch.Generator(device=dev).manual_seed(12)
    Bt, L, H, P, N = 2, 128, 3, 64, 16
    x = torch.randn(Bt, L, H, P, generator=g, device=dev)
    dt = 0.001 + 0.099 * torch.rand(Bt, L, H, generator=g, device=dev)
    A = -(0.5 + 1.5 * torch.rand(H, generator=g, device=dev))
    B, C = (torch.randn(Bt, L, N, generator=g, device=dev)
            for _ in range(2))
    D = torch.randn(H, generator=g, device=dev)
    gy = torch.randn(Bt, L, H, P, generator=g, device=dev)
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, B, C, D)]
    before = SSD_LAUNCHES.count
    y = ops.ssd(*leaves, chunk=64)
    assert SSD_LAUNCHES.count == before + 1
    got = torch.autograd.grad(y, leaves, gy)
    plain = [t.clone().requires_grad_() for t in (x, dt, A, B, C, D)]
    want = torch.autograd.grad(ref.ssd_chunked(*plain, chunk=64), plain, gy)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-130m",
                                  "gemma3-1b"])
def test_training_through_the_kernels_matches_the_plain_path(dev, arch):
    from repro_torch.configs import smoke_config
    from repro_torch.models import init_params, make_loss_fn
    cfg = smoke_config(arch, remat="full")
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), device=dev,
                         generator=torch.Generator(device=dev)
                         .manual_seed(1))
    out = {}
    for impl in ("auto", "torch"):
        loss = make_loss_fn(cfg, impl=impl)(model, {"tokens": toks})
        out[impl] = (loss.detach(), torch.autograd.grad(
            loss, list(model.parameters())))
    torch.testing.assert_close(out["auto"][0], out["torch"][0], atol=1e-5,
                               rtol=1e-5)
    for a, b in zip(out["auto"][1], out["torch"][1]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)
