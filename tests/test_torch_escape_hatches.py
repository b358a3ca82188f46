"""The per-edge escape hatches of the port's simulators
(``flow_slots=False``: one flow per input edge; ``frontier=False``: every
edge and task scanned at every event) against the reference package's
simulators with the same flags, on the CPU.

Graphs crossv, merge_triplets and fork1, padded to one bucket and run
as rows of one call on 8x4, both netmodels; the static simulator on two
seeded schedules per graph, the dynamic one with blevel and greedy at
two grid points per graph (one with msd and a decision delay).  Contract (Queue A's): ``ok``, ``overflow``, ``n_events`` and
``n_steps`` exact; ``makespan`` and ``transferred`` within rtol 1e-5.
The flags also hold the reference's own contract between the modes:
every mode gives the default path's makespan, steps and events.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.vectorized import api as japi  # noqa: E402
from repro.core.vectorized.specs import BucketedGraphSpec as JSpec  # noqa: E402
from repro_torch.core import MiB  # noqa: E402
from repro_torch.core.graphs import make_graph  # noqa: E402
from repro_torch.core.imodes import encode_imode  # noqa: E402
from repro_torch.core.vectorized import (  # noqa: E402
    build, make_bucket_dynamic_simulator, make_bucket_simulator,
    make_grid_runner)
from repro_torch.core.vectorized.engine import capture_counter  # noqa: E402
from repro_torch.core.vectorized.specs import (  # noqa: E402
    as_bucketed, encode_graph, pad_spec, pad_to, round_up, stack_specs)

RTOL = 1e-5
W, CORES = 8, 4
BW = np.float32(100 * MiB)
GRAPHS = ("crossv", "merge_triplets", "fork1")
NETMODELS = ("maxmin", "simple")
HATCHES = {"flow_slots_off": dict(flow_slots=False),
           "frontier_off": dict(frontier=False)}
POINTS = [dict(msd=0.0, decision_delay=0.0, bandwidth=32 * MiB),
          dict(msd=0.1, decision_delay=0.05, bandwidth=256 * MiB)]


def _jspec(spec):
    return JSpec(**as_bucketed(spec).numpy())


def _np(res):
    return {f: np.asarray(getattr(res, f).cpu() if torch.is_tensor(
        getattr(res, f)) else getattr(res, f)) for f in res._fields}


def assert_agree(got, want, ctx):
    for f in ("ok", "overflow", "n_events", "n_steps"):
        assert np.array_equal(got[f], want[f]), (ctx, f, got[f], want[f])
    assert got["ok"].all(), ctx
    for f in ("makespan", "transferred"):
        np.testing.assert_allclose(got[f], want[f], rtol=RTOL, atol=0,
                                   err_msg=f"{ctx} {f}")


def _bucket():
    """The three graphs padded to one bucket shape, stacked."""
    graphs = [make_graph(n, seed=0) for n in GRAPHS]
    specs = [encode_graph(g) for g in graphs]
    shape = (max(s.T for s in specs), round_up(max(s.O for s in specs)),
             round_up(max(s.E for s in specs)))
    return graphs, specs, shape


def _rows_spec(specs, shape, reps):
    """One spec row per (graph, repeat), graph-major."""
    return stack_specs([pad_spec(s, shape) for s in specs
                        for _ in range(reps)])


def _schedules(specs, shape, reps=2, seed=7):
    rng = np.random.default_rng(seed)
    A = rng.integers(0, W, (len(specs) * reps, shape[0])).astype(np.int32)
    P = np.stack([rng.permutation(shape[0]).astype(np.float32) + 1
                  for _ in range(len(A))])
    return A, P


@pytest.mark.parametrize("hatch", sorted(HATCHES))
@pytest.mark.parametrize("netmodel", NETMODELS)
def test_static_hatch_matches_reference(netmodel, hatch):
    opts = HATCHES[hatch]
    _, specs, shape = _bucket()
    spec = _rows_spec(specs, shape, 2)
    A, P = _schedules(specs, shape)
    got = _np(make_bucket_simulator(W, CORES, netmodel, device="cpu",
                                    **opts)(spec, A, P, bandwidth=BW))
    jrun = japi.build(None, n_workers=W, cores=CORES, netmodel=netmodel,
                      **opts)
    want = jax.jit(jax.vmap(lambda s, a, p: jrun(s, a, p, None, None,
                                                 jnp.float32(BW))))(
        _jspec(spec), A, P)
    assert_agree(got, _np(want), (netmodel, hatch))
    # the reference's own contract between the modes: the same events
    base = _np(make_bucket_simulator(W, CORES, netmodel, device="cpu")(
        spec, A, P, bandwidth=BW))
    assert np.array_equal(got["makespan"], base["makespan"])
    for f in ("n_steps", "n_events"):
        assert np.array_equal(got[f], base[f]), f


def _dyn_rows(graphs, shape):
    """One row per (graph, point), graph-major."""
    R = len(POINTS)
    est = [encode_imode(g, "exact") for g in graphs]
    D = np.stack([pad_to(d, shape[0]) for d, _ in est for _ in range(R)])
    S = np.stack([pad_to(s, shape[1]) for _, s in est for _ in range(R)])
    pts = POINTS * len(graphs)
    M = np.array([p["msd"] for p in pts], np.float32)
    DD = np.array([p["decision_delay"] for p in pts], np.float32)
    B = np.array([p["bandwidth"] for p in pts], np.float32)
    return D, S, M, DD, B, np.zeros(len(pts), np.int32)


@pytest.mark.parametrize("hatch", sorted(HATCHES))
@pytest.mark.parametrize("sched", ("blevel", "greedy"))
@pytest.mark.parametrize("netmodel", NETMODELS)
def test_dynamic_hatch_matches_reference(netmodel, sched, hatch):
    opts = HATCHES[hatch]
    graphs, specs, shape = _bucket()
    spec = _rows_spec(specs, shape, len(POINTS))
    D, S, M, DD, B, SD = _dyn_rows(graphs, shape)
    got = _np(make_bucket_dynamic_simulator(
        W, CORES, sched, netmodel, device="cpu", **opts)(
            spec, D, S, M, DD, B, SD.astype(np.int64)))
    jrun = japi.build(None, n_workers=W, cores=CORES, scheduler=sched,
                      netmodel=netmodel, dynamic=True, **opts)
    want = jax.jit(jax.vmap(jrun))(_jspec(spec), D, S, M, DD, B, SD)
    assert_agree(got, _np(want), (netmodel, sched, hatch))


def test_frontier_true_without_flow_slots_raises_on_the_dynamic_path():
    spec = encode_graph(make_graph("crossv", seed=0))
    with pytest.raises(ValueError, match="frontier=True requires"):
        build(spec, n_workers=W, cores=CORES, scheduler="blevel",
              dynamic=True, flow_slots=False, frontier=True, device="cpu")
    # the static simulator keeps its frontier over per-edge flows
    run = make_bucket_simulator(W, CORES, flow_slots=False, frontier=True,
                                device="cpu")
    A, P = _schedules([spec], (spec.T, spec.O, spec.E), reps=1)
    assert bool(run(as_bucketed(spec), A[0], P[0], bandwidth=BW).ok)


@pytest.mark.parametrize("hatch", sorted(HATCHES))
def test_grid_runner_takes_the_hatches(hatch):
    """``make_grid_runner`` passes the flags through: a two-graph group
    gives the default path's makespans and events, on both engines."""
    graphs, specs, shape = _bucket()
    entries = list(zip(graphs, specs))
    points = [dict(bandwidth=64 * MiB)]
    base = make_grid_runner(entries, "blevel", W, CORES, shape=shape,
                            device="cpu")(points)
    for engine in ("vmap", "sharded"):
        with capture_counter() as cc:
            res = make_grid_runner(entries, "blevel", W, CORES, shape=shape,
                                   device="cpu", engine=engine,
                                   **HATCHES[hatch])(points)
        assert cc.calls == 1 and cc.captures == 0     # eager on the CPU
        assert np.array_equal(res.makespan, base.makespan), engine
        assert np.array_equal(res.n_events, base.n_events), engine
        assert np.array_equal(res.n_steps, base.n_steps), engine
