"""The port's static simulator (``build`` with no scheduler,
``make_bucket_simulator``, ``make_simulator``, ``simulate_batch``) and
the per-graph scheduling bindings against the reference package's on
the CPU, on the same inputs made with numpy from a seed.

Graphs: crossv, fork1 and splitters on 8x4, ``random_graph(seed,
n_tasks=20)`` on 4x4 (seeds 0-3), both netmodels, rows of distinct
assignments and priorities in one batched call (the reference runs the
same rows under ``jax.vmap``); heterogeneous clusters, clusters given at
call time with ``max_cores``, graphs of one padded bucket, a frontier
overflow and an exhausted step budget.

Contract: ``ok``, ``overflow``, ``n_events`` and ``n_steps`` exact;
``makespan`` bitwise (``genetic-vec`` ranks its population by it);
``transferred`` within rtol 1e-5 (a float sum in another order).
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import TaskGraph as JTaskGraph  # noqa: E402
from repro.core.graphs import make_graph as j_make_graph  # noqa: E402
from repro.core.graphs import random_graph as j_random_graph  # noqa: E402
from repro.core.vectorized import api as japi  # noqa: E402
from repro.core.vectorized import scheduling as jsched  # noqa: E402
from repro.core.vectorized import encode_graph as j_encode  # noqa: E402
from repro.core.vectorized import simulate_batch as j_simulate_batch  # noqa
from repro.core.vectorized.specs import BucketedGraphSpec as JSpec  # noqa
from repro.core.vectorized.specs import frontier_caps_for_spec as j_caps  # noqa
from repro_torch.core import MiB, TaskGraph  # noqa: E402
from repro_torch.core.graphs import make_graph, random_graph  # noqa: E402
from repro_torch.core.imodes import encode_imode  # noqa: E402
from repro_torch.core.vectorized import (build, make_bucket_simulator,  # noqa
                                         make_simulator, simulate_batch)
from repro_torch.core.vectorized import scheduling as psched  # noqa: E402
from repro_torch.core.vectorized.specs import (as_bucketed,  # noqa: E402
                                               encode_graph, pad_spec,
                                               pad_to, round_up,
                                               stack_specs, t_bucket)

RTOL = 1e-5
BW = np.float32(100 * MiB)


def rows(seed, R, T, W):
    """R distinct assignments and priority rows over T tasks."""
    rng = np.random.default_rng(seed)
    A = rng.integers(0, W, (R, T)).astype(np.int32)
    P = np.stack([rng.permutation(T).astype(np.float32) + 1
                  for _ in range(R)])
    return A, P


def fit(A, cores, cpus):
    """``A`` with every task that fits no core count of its row's worker
    moved to the row's largest worker."""
    cores = np.broadcast_to(np.atleast_2d(cores),
                            (A.shape[0], np.shape(cores)[-1]))
    big = cores.argmax(axis=1)[:, None]
    return np.where(np.take_along_axis(cores, A, 1) >= cpus[None], A,
                    big).astype(np.int32)


def reference(bspec, A, P, W, cores, netmodel, *, call_cores=None,
              max_cores=None, bw=BW, **opts):
    """The reference's bucket simulator over the rows under ``jax.vmap``
    (the spec batched when it has a row axis).  An unbatched spec gets
    the caps the port's bound ``build`` widens it to, unless given."""
    js = JSpec(**as_bucketed(bspec).numpy())
    if js.durations.ndim == 1:
        opts.setdefault("frontier_caps", j_caps(js))
    brun = japi.build(None, n_workers=W, cores=cores, netmodel=netmodel,
                      max_cores=max_cores, **opts)
    spec_ax = None if js.durations.ndim == 1 else 0
    cores_ax = None if call_cores is None else 0
    fn = jax.jit(jax.vmap(lambda s, a, p, c: brun(s, a, p, None, None,
                                                  jnp.float32(bw), c),
                          in_axes=(spec_ax, 0, 0, cores_ax)))
    res = fn(js, A, P, None if call_cores is None
             else np.asarray(call_cores, np.int32))
    return {f: np.asarray(getattr(res, f)) for f in res._fields}


def assert_agree(got, want, ctx, expect_ok=True):
    got = {f: getattr(got, f).cpu().numpy() for f in got._fields}
    for f in ("ok", "overflow", "n_events", "n_steps"):
        assert np.array_equal(got[f], want[f]), (ctx, f, got[f], want[f])
    if expect_ok:
        assert got["ok"].all(), ctx
    assert np.array_equal(got["makespan"], want["makespan"],
                          equal_nan=True), (ctx, got["makespan"],
                                            want["makespan"])
    np.testing.assert_allclose(got["transferred"], want["transferred"],
                               rtol=RTOL, atol=0, err_msg=str(ctx))


@pytest.mark.parametrize("netmodel", ["maxmin", "simple"])
@pytest.mark.parametrize("gname", ["crossv", "fork1", "splitters"])
def test_static_matches_reference(gname, netmodel):
    g = make_graph(gname, seed=0)
    spec = encode_graph(g)
    A, P = rows(len(gname), 3, spec.T, 8)
    got = build(spec, n_workers=8, cores=4, netmodel=netmodel,
                device="cpu")(A, P, bandwidth=BW)
    want = reference(spec, A, P, 8, 4, netmodel)
    assert_agree(got, want, (gname, netmodel))
    # the graph is the reference's own
    assert encode_graph(j_make_graph(gname, seed=0)).T == spec.T


@pytest.mark.parametrize("netmodel", ["maxmin", "simple"])
@pytest.mark.parametrize("seed", range(4))
def test_static_matches_reference_random(seed, netmodel):
    g = random_graph(seed, n_tasks=20)
    assert j_random_graph(seed, n_tasks=20).task_count == g.task_count
    spec = encode_graph(g)
    A, P = rows(seed + 50, 4, spec.T, 4)
    got = build(spec, n_workers=4, cores=4, netmodel=netmodel,
                device="cpu")(A, P, bandwidth=BW)
    want = reference(spec, A, P, 4, 4, netmodel)
    assert_agree(got, want, (seed, netmodel))


@pytest.mark.parametrize("netmodel", ["maxmin", "simple"])
def test_heterogeneous_and_call_time_clusters(netmodel):
    """A heterogeneous cluster bound at build time, and one cluster per
    row passed at call time with ``max_cores`` (zero-core padding
    included)."""
    g = random_graph(7, n_tasks=24, max_cpus=2)
    spec = encode_graph(g)
    assert spec.cpus.max() == 2
    A, P = rows(7, 3, spec.T, 4)
    het = np.array([1, 2, 2, 4])
    A = fit(A, het, spec.cpus)
    got = build(spec, n_workers=4, cores=het, netmodel=netmodel,
                device="cpu")(A, P, bandwidth=BW)
    assert_agree(got, reference(spec, A, P, 4, het, netmodel),
                 (netmodel, "het"))
    caps = j_caps(JSpec(**as_bucketed(spec).numpy()))
    per_row = np.array([[2, 2, 2, 2], [4, 1, 2, 0], [3, 3, 2, 2]])
    A = fit(A, per_row, spec.cpus)
    brun = build(None, n_workers=4, cores=None, netmodel=netmodel,
                 max_cores=4, frontier_caps=caps, device="cpu")
    got = brun(as_bucketed(spec), A, P, None, None, BW, per_row)
    assert_agree(got, reference(spec, A, P, 4, None, netmodel,
                                call_cores=per_row, max_cores=4,
                                frontier_caps=caps), (netmodel, "rows"))


def test_padded_bucket_of_graphs_matches_reference():
    """Two graphs padded into one bucket and stacked: one row each."""
    specs = [encode_graph(make_graph(n, seed=0)) for n in ("crossv",
                                                           "splitters")]
    shape = (t_bucket(max(s.T for s in specs)),
             round_up(max(s.O for s in specs)),
             round_up(max(s.E for s in specs)))
    batch = stack_specs([pad_spec(s, shape) for s in specs])
    A, P = rows(3, 2, shape[0], 8)
    got = build(None, n_workers=8, cores=4, device="cpu")(batch, A, P)
    assert_agree(got, reference(batch, A, P, 8, 4, "maxmin",
                                bw=100 * MiB), "bucket")


@pytest.mark.parametrize("netmodel", ["maxmin", "simple"])
def test_frontier_overflow_matches_reference(netmodel):
    g = make_graph("crossv", seed=0)
    spec = encode_graph(g)
    A, P = rows(11, 2, spec.T, 8)
    got = build(spec, n_workers=8, cores=4, netmodel=netmodel,
                frontier_caps=(2, 2), device="cpu")(A, P, bandwidth=BW)
    want = reference(spec, A, P, 8, 4, netmodel, frontier_caps=(2, 2))
    assert want["overflow"].all() and not want["ok"].any()
    assert_agree(got, want, netmodel, expect_ok=False)


def test_exhausted_budget_matches_reference():
    """``max_steps=1`` cannot finish the graph: ok False, NaN makespan
    on both sides; ``simulate_batch`` raises on a schedule that cannot
    start as the reference's does."""
    g = make_graph("fork1", seed=0)
    spec = encode_graph(g)
    A = np.zeros((1, spec.T), np.int32)
    P = np.arange(spec.T, 0, -1, dtype=np.float32)[None]
    got = build(spec, n_workers=4, cores=4, max_steps=1,
                device="cpu")(A, P)
    want = reference(spec, A, P, 4, 4, "maxmin", max_steps=1,
                     bw=100 * MiB)
    assert not want["ok"].any() and np.isnan(want["makespan"]).all()
    assert_agree(got, want, "max_steps", expect_ok=False)
    stuck_j, stuck_p = JTaskGraph("stuck"), TaskGraph("stuck")
    stuck_j.new_task(1.0, cpus=4)
    stuck_p.new_task(1.0, cpus=4)
    args = (np.zeros((1, 1), np.int32), np.ones((1, 1), np.float32), 2, 1)
    with pytest.raises(RuntimeError, match="event budget"):
        j_simulate_batch(stuck_j, *args)
    with pytest.raises(RuntimeError, match="event budget"):
        simulate_batch(stuck_p, *args, device="cpu")


def test_bench_pr7_static_merge_triplets_row():
    """``BENCH_PR7.json``'s static T160 row: blevel from the exact
    estimates, the schedule padded to the bucket, the shape's caps."""
    g = make_graph("merge_triplets", seed=0)
    spec = encode_graph(g)
    shape = (t_bucket(spec.T), round_up(spec.O), round_up(spec.E))
    d, s = encode_imode(g, "exact")
    aw, prio = build(spec, n_workers=8, cores=4, scheduler="blevel",
                     device="cpu")(d, s, BW)
    run = build(None, n_workers=8, cores=4, device="cpu")
    res = run(pad_spec(spec, shape), pad_to(aw.numpy(), shape[0], 0),
              pad_to(prio.numpy(), shape[0], 0.0), None, None, BW)
    assert bool(res.ok) and not bool(res.overflow)
    assert int(res.n_events) == 232 and int(res.n_steps) == 232
    assert float(res.makespan) == 249.30433654785156
    np.testing.assert_allclose(float(res.transferred), 8741974016.0,
                               rtol=RTOL)


def test_unbatched_call_and_bindings_equal_batched_rows():
    """An unbatched schedule gives an unbatched result equal to its row;
    ``make_simulator`` (deprecated), ``make_bucket_simulator`` and
    ``simulate_batch`` give the same rows as ``build``."""
    g = make_graph("splitters", seed=0)
    spec = encode_graph(g)
    A, P = rows(5, 3, spec.T, 8)
    batch = build(spec, n_workers=8, cores=4, device="cpu")(A, P)
    one = build(spec, n_workers=8, cores=4, device="cpu")(A[1], P[1])
    assert one.makespan.dim() == 0
    for f in batch._fields:
        assert torch.equal(getattr(one, f), getattr(batch, f)[1]), f
    with pytest.warns(DeprecationWarning, match="build"):
        legacy = make_simulator(spec, 8, 4, device="cpu")
    bucket = make_bucket_simulator(8, 4, device="cpu")(as_bucketed(spec),
                                                       A, P)
    ms, xfer = simulate_batch(g, A, P, 8, 4, device="cpu")
    for res in (legacy(A, P), bucket):
        for f in ("makespan", "n_steps", "n_events"):
            assert torch.equal(getattr(res, f), getattr(batch, f)), f
    assert torch.equal(ms, batch.makespan)
    assert torch.equal(xfer, batch.transferred)


def test_static_simulator_rejects_the_per_edge_escape_hatches():
    """The per-edge escape hatches are ported: ``flow_slots=False`` and
    ``frontier=False`` (and both) run and equal the reference's static
    simulator with the same flags, makespans bitwise."""
    spec = encode_graph(make_graph("crossv", seed=0))
    A, P = rows(5, 3, spec.T, 8)
    for opt in (dict(flow_slots=False), dict(frontier=False),
                dict(flow_slots=False, frontier=False)):
        got = build(spec, n_workers=8, cores=4, device="cpu", **opt)(
            A, P, bandwidth=BW)
        assert_agree(got, reference(spec, A, P, 8, 4, "maxmin", **opt),
                     opt)


SCHEDULER_BINDINGS = ["make_static_blevel_scheduler",
                      "make_static_tlevel_scheduler",
                      "make_static_mcp_scheduler", "make_etf_scheduler",
                      "make_random_scheduler"]


@pytest.mark.parametrize("name", SCHEDULER_BINDINGS)
def test_scheduler_bindings_match_reference(name):
    g = make_graph("crossv", seed=0)
    spec = encode_graph(g)
    d, s = encode_imode(g, "user")
    cores = [4, 4, 2, 2]
    aw, prio = getattr(psched, name)(spec, 4, cores, device="cpu")(
        d, s, BW, 3)
    jaw, jprio = getattr(jsched, name)(j_encode(
        j_make_graph("crossv", seed=0)), 4, cores)(d, s, BW, jnp.int32(3))
    assert aw.tolist() == np.asarray(jaw).tolist()
    assert np.array_equal(prio.numpy(), np.asarray(jprio))


def test_vec_scheduler_and_level_bindings_match_reference():
    g = make_graph("fork1", seed=0)
    spec = encode_graph(g)
    js = j_encode(j_make_graph("fork1", seed=0))
    d, s = encode_imode(g, "exact")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        got = psched.make_vec_scheduler(spec, 4, 4, "etf", device="cpu")(
            d, s, BW)
        want = jsched.make_vec_scheduler(js, 4, 4, "etf")(d, s, BW)
    assert got[0].tolist() == np.asarray(want[0]).tolist()
    for name in ("make_blevel_fn", "make_tlevel_fn"):
        lv = getattr(psched, name)(spec, device="cpu")(d)
        jlv = getattr(jsched, name)(js)(jnp.asarray(d))
        assert lv.shape == (spec.T,)
        assert np.array_equal(lv.numpy(), np.asarray(jlv)), name


def test_transfer_cost_and_greedy_bindings_match_reference():
    g = random_graph(2, n_tasks=20)
    spec = encode_graph(g)
    js = j_encode(j_random_graph(2, n_tasks=20))
    rng = np.random.default_rng(2)
    size_now = rng.uniform(1, 100, spec.O).astype(np.float32)
    missing = rng.random((spec.O, 4)) < 0.5
    cost = psched.make_transfer_costs(spec, 4, device="cpu")(size_now,
                                                             missing)
    jcost = jsched.make_transfer_costs(js, 4)(size_now, missing)
    assert np.array_equal(cost.numpy(), np.asarray(jcost))
    ready = rng.random(spec.T) < 0.6
    load0 = np.array([0, 2, 1, 0], np.int32)
    got = psched.make_greedy_placer(spec, 4, [2, 4, 4, 2], device="cpu")(
        ready, cost, load0)
    want = jsched.make_greedy_placer(js, 4, [2, 4, 4, 2])(
        jnp.asarray(ready), jcost, jnp.asarray(load0))
    assert got.tolist() == np.asarray(want).tolist()
