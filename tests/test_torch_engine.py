"""The port's grid engine (``repro_torch.core.vectorized.engine``) and
the in-place event step on the CPU.

* ``DoubleBufferQueue`` keeps the reference queue's invariants.
* ``ShardedGridRunner(devices=1, stream_rows=2)`` streams G = 6 rows
  (2 graphs x 3 points) in 3 chunks and equals the JAX package's
  ``ShardedGridRunner(devices=1)`` and the port's ``BucketedGridRunner``
  bitwise on every ``SimResult`` field, for blevel and greedy on both
  netmodels (the reference test's entries and points,
  ``tests/test_engine.py``).
* The event step writes into the carry (``sim._step_into``): run
  eagerly it equals the loop that rebuilt the carry every step, bit for
  bit, for both simulators.
* Sync-free: the part of a step that a CUDA graph captures on the card
  runs here with every host read of a tensor patched to raise, through
  the same driver path as on the card (``_capture`` replaced by a
  replay of the step on the CPU), and gives the eager results.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

from repro.core.vectorized import ShardedGridRunner as JShardedGridRunner  # noqa: E402
from repro.core.vectorized.sim import _points_arrays  # noqa: E402
from repro_torch.core import MiB, TaskGraph  # noqa: E402
from repro_torch.core.graphs import random_graph  # noqa: E402
from repro_torch.core.vectorized import (BucketedGridRunner,  # noqa: E402
                                         DoubleBufferQueue, ShardedGridRunner,
                                         build, capture_counter,
                                         make_grid_runner, sim)
from repro_torch.core.vectorized.specs import encode_graph  # noqa: E402

import test_vectorized_dynamic as tvd  # noqa: E402

POINTS = [dict(imode="exact", bandwidth=100 * MiB, msd=0.0,
               decision_delay=0.0, seed=3),
          dict(imode="user", bandwidth=32 * MiB, msd=0.1,
               decision_delay=0.05, seed=3),
          dict(imode="exact", bandwidth=32 * MiB, msd=0.0,
               decision_delay=0.0, seed=7)]


def mini_fork(n=6):
    """``test_vectorized_dynamic.mini_fork`` built with the port's
    ``TaskGraph``."""
    g = TaskGraph("mini_fork")
    for i in range(n):
        p = g.new_task(1.0 + 0.11 * i, outputs=[(50 + 8 * i) * MiB],
                       expected_duration=1.5 + 0.13 * i,
                       expected_sizes=[(40 + 9 * i) * MiB], name="prod")
        for j in range(2):
            g.new_task(0.5 + 0.07 * (2 * i + j), inputs=p.outputs,
                       expected_duration=0.6 + 0.05 * (2 * i + j),
                       name="cons")
    return g


def mini_merge(n=5):
    """``test_vectorized_dynamic.mini_merge`` built with the port's
    ``TaskGraph``."""
    g = TaskGraph("mini_merge")
    prods = [g.new_task(1.0 + 0.13 * i, outputs=[(60 + 7 * i) * MiB],
                        expected_duration=1.2 + 0.17 * i,
                        expected_sizes=[(50 + 11 * i) * MiB], name="p")
             for i in range(n)]
    mids = []
    for i in range(n):
        mids.append(g.new_task(
            0.8 + 0.09 * i,
            inputs=[prods[i].outputs[0], prods[(i + 1) % n].outputs[0]],
            outputs=[(30 + 5 * i) * MiB],
            expected_duration=0.7 + 0.08 * i, name="m"))
    g.new_task(0.6, inputs=[m.outputs[0] for m in mids],
               expected_duration=0.9, name="final")
    return g


def entries():
    return [(g, encode_graph(g)) for g in (mini_fork(), mini_merge())]


def jax_full_result(runner, points):
    """The JAX runner's un-sliced ``SimResult[K, B, N]`` (as
    ``tests/test_engine.py`` takes it)."""
    pts, M, DD, BW, SD = _points_arrays(points)
    D = np.stack([runner._estimates(p.get("imode", "exact"))[0]
                  for p in pts], axis=1)
    S = np.stack([runner._estimates(p.get("imode", "exact"))[1]
                  for p in pts], axis=1)
    return runner._execute(D, S, M, DD, BW, SD)


def assert_bitwise(got, want, ctx=""):
    for field, a, b in zip(want._fields, got, want, strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f"{ctx} {field}")


# ------------------------------------------------------- DoubleBufferQueue

def test_queue_order_and_exactly_once():
    put_log = []
    q = DoubleBufferQueue(range(5), put=lambda x: (put_log.append(x), x)[1])
    assert list(q) == list(range(5))
    assert put_log == list(range(5))            # each batch put exactly once


def test_queue_prefetch_depth():
    """put(k+1) runs before batch k is consumed — depth-2, no deeper."""
    put_log = []
    q = DoubleBufferQueue(range(4), put=put_log.append)
    assert put_log == [0]                       # constructor primes batch 0
    next(q)
    assert put_log == [0, 1]                    # consuming 0 prefetched 1
    next(q)
    assert put_log == [0, 1, 2]


def test_queue_drains_last_batch():
    q = DoubleBufferQueue([7])
    assert next(q) == 7
    with pytest.raises(StopIteration):
        next(q)
    assert list(DoubleBufferQueue([])) == []
    assert list(DoubleBufferQueue(iter([1, 2]))) == [1, 2]


def test_queue_identity_put_default():
    assert list(DoubleBufferQueue((x * x for x in range(3)))) == [0, 1, 4]


# ------------------------------------------- the engine against JAX and vmap

@pytest.mark.parametrize("netmodel", ["maxmin", "simple"])
@pytest.mark.parametrize("sched", ["blevel", "greedy"])
def test_streamed_rows_equal_jax_sharded_and_vmap_bitwise(sched, netmodel):
    want = jax_full_result(
        JShardedGridRunner([(tvd.mini_fork(), None), (tvd.mini_merge(), None)],
                           sched, 4, 2, netmodel=netmodel, devices=1),
        POINTS)
    runner = ShardedGridRunner(entries(), sched, 4, 2, netmodel=netmodel,
                               devices=1, stream_rows=2, device="cpu")
    assert runner._row_chunks(6) == (2, 6)      # three chunks of two rows
    streamed = runner(POINTS)
    vmap = BucketedGridRunner(entries(), sched, 4, 2, netmodel=netmodel,
                              device="cpu")(POINTS)
    assert streamed.ok.all() and streamed.makespan.shape == (1, 2, 3)
    assert_bitwise(streamed, want, f"{sched}/{netmodel} vs JAX")
    assert_bitwise(streamed, vmap, f"{sched}/{netmodel} vs vmap")


def test_padded_last_chunk_is_sliced_off():
    """stream_rows=4 over 6 rows: two chunks, the second padded with two
    copies of row 0 — same bits as one call."""
    runner = make_grid_runner(entries(), "blevel", 4, [2, 2, 1, 1],
                              engine="sharded", stream_rows=4, device="cpu")
    assert runner._row_chunks(6) == (4, 8)
    vmap = make_grid_runner(entries(), "blevel", 4, [2, 2, 1, 1],
                            device="cpu")
    assert_bitwise(runner(POINTS), vmap(POINTS))


def test_row_chunks_are_equal_and_cover_the_rows():
    r = ShardedGridRunner(entries()[:1], "blevel", 4, 2, device="cpu")
    assert r._row_chunks(6) == (6, 6)           # default: one chunk
    r.stream_rows = 4
    assert r._row_chunks(6) == (4, 8)           # 2 chunks, 2 pad rows
    r.stream_rows = 7
    assert r._row_chunks(6) == (7, 7)           # one chunk, 1 pad row
    r.stream_rows = 3
    assert r._row_chunks(6) == (3, 6)           # no padding
    r.stream_rows = 1
    assert r._row_chunks(6) == (1, 6)
    r.stream_rows = 0
    assert r._row_chunks(6) == (1, 6)           # at least one row


def test_make_grid_runner_dispatch():
    e = entries()[:1]
    assert type(make_grid_runner(e, "blevel", 4, 2, device="cpu")) \
        is BucketedGridRunner
    r = make_grid_runner(e, "blevel", 4, 2, engine="sharded", devices=1,
                         stream_rows=3, device="cpu")
    assert isinstance(r, ShardedGridRunner) and r.stream_rows == 3
    with pytest.raises(TypeError, match="unknown engine"):
        make_grid_runner(e, "blevel", 4, 2, engine="pmap", device="cpu")
    # build carries the engine block in its config, as the reference's
    spec = e[0][1]
    d = np.full(spec.T, 1.0, np.float32)
    s = np.full(spec.O, 1.0, np.float32)
    res = build(spec, n_workers=4, cores=2, scheduler="blevel",
                dynamic=True, engine="sharded", stream_rows=2,
                device="cpu")(d, s)
    assert bool(res.ok)


@pytest.mark.parametrize("case", ["devices", "cache_dir", "graph_on_cpu"])
def test_options_that_cannot_run_here_raise(case):
    e = entries()[:1]
    if case == "devices":
        # two ranks need a started process group: no quiet one-card run
        with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
            make_grid_runner(e, "blevel", 4, 2, engine="sharded",
                             devices=2, device="cpu")
    elif case == "cache_dir":
        with pytest.raises(NotImplementedError, match="across processes"):
            make_grid_runner(e, "blevel", 4, 2, engine="sharded",
                             cache_dir="/nonexistent", device="cpu")
        with pytest.raises(NotImplementedError, match="across processes"):
            build(e[0][1], n_workers=4, cores=2, cache_dir="x",
                  device="cpu")
    else:
        with pytest.raises(ValueError, match="needs a CUDA device"):
            make_grid_runner(e, "blevel", 4, 2, step_graph="graph",
                             device="cpu")
        with pytest.raises(ValueError, match="needs a CUDA device"):
            build(e[0][1], n_workers=4, cores=2, step_graph="graph",
                  device="cpu")
        with pytest.raises(ValueError, match="step_graph"):
            build(e[0][1], n_workers=4, cores=2, step_graph="sometimes",
                  device="cpu")


def test_cpu_runs_capture_nothing():
    with capture_counter() as cc:
        make_grid_runner(entries(), "blevel", 4, 2, engine="sharded",
                         stream_rows=2, device="cpu")(POINTS[:1])
    assert cc.captures == 0 and cc.replays == 0


# ------------------------------------ the in-place step and the graph path

def rebuilt_carry_drive(st, body, cond, check_every, graph=False,
                        device=None, tallies=None):
    """The event loop as it was before the carry was written in place:
    a new carry dict every step, frozen with ``torch.where``."""
    assert not graph
    live = cond(st)
    R = live.shape[0]
    step = 0
    while True:
        if step % check_every == 0 and not bool(live.any()):
            break
        new = body(st, live)
        st = {k: torch.where(live.view((R,) + (1,) * (v.dim() - 1)),
                             new[k], v) for k, v in st.items()}
        live = cond(st)
        step += 1
    return st


SYNCS = ("__bool__", "item", "__int__", "__index__", "__float__",
         "tolist", "cpu", "numpy")


class SyncFreeCapture:
    """Stands in for ``sim._capture`` on the CPU: "capturing" records
    nothing, and each replay runs the step with every host read of a
    tensor patched to raise — what would break a capture on the card."""

    def __init__(self, monkeypatch):
        self.mp = monkeypatch
        self.captures = self.replays = 0

    def __call__(self, step, device):
        self.captures += 1

        def replay():
            self.replays += 1
            with self.mp.context() as m:
                for name in SYNCS:
                    m.setattr(torch.Tensor, name, self._raise(name))
                step()

        return replay, lambda: None

    @staticmethod
    def _raise(name):
        def fail(*args, **kwargs):
            raise AssertionError(f"host read Tensor.{name} inside the "
                                 f"captured part of a step")
        return fail


def static_case(netmodel, **kw):
    g = random_graph(5, n_tasks=40, max_cpus=2)
    spec = encode_graph(g)
    rng = np.random.default_rng(0)
    A = rng.integers(0, 4, (6, spec.T)).astype(np.int32)
    P = rng.uniform(1, 100, (6, spec.T)).astype(np.float32)
    run = build(spec, n_workers=4, cores=2, netmodel=netmodel,
                device="cpu", **kw)
    return lambda: run(A, P, bandwidth=np.float32(64 * MiB))


def dynamic_case(sched, netmodel, **kw):
    runner = make_grid_runner(entries(), sched, 4, [2, 2, 1, 1],
                              netmodel=netmodel, device="cpu", **kw)
    return lambda: runner(POINTS)


CASES = {
    "static/maxmin": lambda **kw: static_case("maxmin", **kw),
    "static/simple": lambda **kw: static_case("simple", **kw),
    "blevel/maxmin": lambda **kw: dynamic_case("blevel", "maxmin", **kw),
    "blevel/simple": lambda **kw: dynamic_case("blevel", "simple", **kw),
    "greedy/maxmin": lambda **kw: dynamic_case("greedy", "maxmin", **kw),
    "greedy/simple": lambda **kw: dynamic_case("greedy", "simple", **kw),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_in_place_step_equals_the_rebuilt_carry_bitwise(case, monkeypatch):
    got = CASES[case]()()
    monkeypatch.setattr(sim, "_drive", rebuilt_carry_drive)
    want = CASES[case]()()
    assert_bitwise(got, want, case)
    assert np.asarray(got.ok).all()


def sync_free_placement(placing, table, e_obj, size_now, missing, cpus,
                        cores, load0, tally):
    """Stands in for greedy's placement kernel on the CPU, reading
    nothing on the host as the kernel does: the plain costs, then every
    task id in turn (one that is not placing places nowhere)."""
    from repro_torch.core.vectorized.scheduling import (
        BIG, INF, table_transfer_costs)
    R, T = placing.shape
    if R and T:
        tally[0] += placing.sum(dim=1).amax()
    cost = table_transfer_costs(table, e_obj, size_now, missing)
    load = load0.clone()
    pw = torch.full((R, T), -1, dtype=torch.int64)
    rows = torch.arange(R)
    for t in range(T):
        act = placing[:, t]
        c = torch.where(cores >= cpus[:, t, None], cost[:, t], INF)
        cand = c == c.amin(dim=1, keepdim=True)
        ld = torch.where(cand, load, BIG)
        cand = cand & (ld == ld.amin(dim=1, keepdim=True))
        w = cand.int().argmax(dim=1)
        pw[:, t] = torch.where(act, w, -1)
        load[rows, w] += act.long()
    return pw


@pytest.mark.parametrize("case", sorted(CASES))
def test_captured_part_of_the_step_reads_no_host(case, monkeypatch):
    """The graph path of ``_drive`` on the CPU: step 0 eager, then every
    later step replayed whole, greedy's invocation too; the plain
    waterfill runs all its rounds, as it does in a graph on the card,
    and a placement with no host read stands in for greedy's kernel."""
    want = CASES[case](waterfill_impl="torch", step_graph="eager")()
    fake = SyncFreeCapture(monkeypatch)
    monkeypatch.setattr(sim, "_capture", fake)
    monkeypatch.setattr("repro_torch.kernels.greedy_place.greedy_place",
                        sync_free_placement)
    monkeypatch.setattr(sim, "_resolve_step_graph", lambda s, d: True)
    got = CASES[case](waterfill_impl="torch")()
    assert_bitwise(got, want, case)
    assert fake.captures == 1 and fake.replays > 0   # one simulator call


def test_plain_waterfill_without_host_reads_equals_early_exit():
    from repro_torch.core.vectorized.waterfill import waterfill_rounds
    rng = np.random.default_rng(3)
    R, W, F = 64, 6, 24
    src = torch.as_tensor(rng.integers(0, W, (R, F)).astype(np.int32))
    dst = torch.as_tensor(rng.integers(0, W, (R, F)).astype(np.int32))
    active = torch.as_tensor(rng.random((R, F)) < 0.5)
    caps = torch.as_tensor(rng.uniform(10, 90, (R, W)).astype(np.float32))
    a, ra = waterfill_rounds(src, dst, active, caps, caps)
    b, rb = waterfill_rounds(src, dst, active, caps, caps, sync=False)
    assert torch.equal(a, b) and torch.equal(ra, rb)
