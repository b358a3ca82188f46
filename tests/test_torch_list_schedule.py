"""The static list schedule's wrapper (``repro_torch.kernels.list_schedule``)
on the CPU: its plain route equals the schedulers as they were before
the kernel (two host loops of eager ops, frozen below as ``seed_*``) bit
for bit, for ``blevel``, ``tlevel``, ``mcp`` and greedy's priorities;
the kernel's algorithm, written out per row in numpy (``row_model``: a
serial walk over one row as a warp of the CUDA source walks it), gives
the same; and the wrapper checks its inputs and counts no launch on the
CPU.  The kernel itself is held against the plain route in
``tests/test_torch_cuda.py`` on inputs made by ``schedule_inputs``."""
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import parse_cluster  # noqa: E402
from repro_torch.core.graphs import (  # noqa: E402
    irw, make_graph, random_graph)
from repro_torch.core.vectorized import _spans  # noqa: E402
from repro_torch.core.vectorized._ops import take  # noqa: E402
from repro_torch.core.vectorized.api import make_grid_runner  # noqa: E402
from repro_torch.core.vectorized.scheduling import (  # noqa: E402
    LIST_ORDERS, graph_view, make_bucket_scheduler)
from repro_torch.core.vectorized.specs import (  # noqa: E402
    encode_graph, pad_spec, stack_specs)
from repro_torch.kernels import LIST_SCHEDULE_LAUNCHES  # noqa: E402
from repro_torch.kernels.list_schedule import (  # noqa: E402
    blevel_priorities, list_schedule)

INF = float("inf")

# T160-class graphs of the three datasets and one bucket that holds them
GRAPHS = {"elementary": ("merge_triplets",),
          "pegasus": ("montage", "cybershake", "sipht"),
          "irw": ("crossv", "mapreduce16")}
SHAPE = (160, 288, 416)
# cluster groups, each padded to its widest with zero-core workers
CLUSTERS = {"8x4": ("8x4", "1x8+4x2"), "32x16": ("32x16", "1x8+4x2")}


def _graph(name):
    if name.startswith("mapreduce"):        # mapreduce<n>: n maps x n reduces
        n = int(name[len("mapreduce"):])
        return irw.mapreduce(0, maps=n, reduces=n)
    if name == "random2048":                # 1900 tasks: the T2048 bucket
        return random_graph(5, n_tasks=1900, edge_p=0.05)
    return make_graph(name, seed=0)


def schedule_inputs(graphs, clusters, R, seed, device="cpu", shape=SHAPE,
                    zero_dur=False, bandwidths=(32.0, 1024.0, 8192.0),
                    tiny_cores=False):
    """Seeded inputs of one schedule call, row r on graph ``r %
    len(graphs)`` padded to ``shape`` and cluster ``r % len(clusters)``
    padded to the widest with zero-core workers: ``(g, args)``, ``args``
    the wrapper's positional arguments after the order.  ``zero_dur``:
    every estimated duration 0 (b-level ties); ``bandwidths`` in MiB/s,
    one a row in turn; ``tiny_cores``: every worker 1 core, so no worker
    fits a task of 2 or more cores."""
    rng = np.random.default_rng(seed)
    specs = [pad_spec(encode_graph(_graph(n)), shape) for n in graphs]
    g = graph_view(stack_specs([specs[r % len(specs)] for r in range(R)])
                   .to(torch.device(device)))
    T, O = g.T, g.O
    lists = [parse_cluster(c) for c in clusters]
    W = max(len(c) for c in lists)
    cores = np.zeros((R, W), np.int64)
    for r in range(R):
        c = lists[r % len(lists)]
        cores[r, :len(c)] = c
    C = int(cores.max())      # the static bound on a worker's cores
    if tiny_cores:
        cores = np.minimum(cores, 1)
    dur = rng.lognormal(2, 1, (R, T)).astype(np.float32)
    if zero_dur:
        dur[:] = 0.0
    size = rng.lognormal(17, 2, (R, O)).astype(np.float32)
    bw = np.asarray([bandwidths[r % len(bandwidths)] for r in range(R)],
                    np.float32) * np.float32(2 ** 20)
    est_dur = torch.where(g.task_valid, torch.as_tensor(dur, device=device),
                          0.0)
    est_size = torch.where(g.obj_valid, torch.as_tensor(size, device=device),
                           0.0)
    args = (g.e_task, g.prod_e, g.e_obj, g.edge_valid, g.cpus, est_dur,
            est_size, torch.as_tensor(bw, device=device),
            torch.as_tensor(cores, device=device), C)
    return g, args


# ------------------------------------------- the schedulers before the kernel

def seed_blevel(g, est_dur):
    T = g.T
    bl = torch.zeros(g.R, T, dtype=torch.float32)
    if g.E == 0:
        return bl + est_dur
    for t in range(T - 1, -1, -1):
        mask = (g.prod_e == t) & g.edge_valid
        child = torch.where(mask, take(bl, g.e_task), 0.0).amax(dim=1)
        bl[:, t] = est_dur[:, t] + child
    return bl


def seed_tlevel(g, est_dur):
    T = g.T
    tl = torch.zeros(g.R, T, dtype=torch.float32)
    if g.E == 0:
        return tl
    par_dur = take(est_dur, g.prod_e)
    for t in range(T):
        mask = (g.e_task == t) & g.edge_valid
        tl[:, t] = torch.where(mask, take(tl, g.prod_e) + par_dur,
                               0.0).amax(dim=1)
    return tl


def seed_rank_priorities(bl):
    R, T = bl.shape
    order = torch.sort(-bl, dim=1, stable=True).indices
    ranks = (T - torch.arange(T)).float()
    return torch.zeros(R, T, dtype=torch.float32).scatter_(
        1, order, ranks.expand(R, T).contiguous())


SEED_ORDERS = {
    "blevel": lambda g, d: torch.sort(-seed_blevel(g, d), dim=1,
                                      stable=True).indices,
    "tlevel": lambda g, d: torch.sort(seed_tlevel(g, d), dim=1,
                                      stable=True).indices,
    "mcp": lambda g, d: torch.sort(
        seed_blevel(g, d).amax(dim=1, keepdim=True) - seed_blevel(g, d),
        dim=1, stable=True).indices,
}


def seed_schedule(order, g, est_dur, est_size, bandwidth, cores, C):
    """``_make_bucket_list_scheduler``'s loop as it was."""
    R, T, W = g.R, g.T, cores.shape[1]
    order = SEED_ORDERS[order](g, est_dur)
    ar = torch.arange(C)
    slots = torch.where(ar[None, None, :] < cores[:, :, None], 0.0,
                        INF).float()
    xfer = take(est_size.float(), g.e_obj) / bandwidth[:, None]
    w_ids = torch.arange(W)
    rows = torch.arange(R)
    aw = torch.zeros(R, T, dtype=torch.int64)
    fin = torch.zeros(R, T, dtype=torch.float32)
    prio = torch.zeros(R, T, dtype=torch.float32)
    for r in range(T):
        t = order[:, r]
        ct = g.cpus[rows, t]
        if g.E:
            pw = take(aw, g.prod_e)
            pf = take(fin, g.prod_e)
            ready_ew = pf[:, :, None] + torch.where(
                pw[:, :, None] == w_ids, 0.0, xfer[:, :, None])
            mine = (g.e_task == t[:, None]) & g.edge_valid
            data_ready = torch.where(mine[:, :, None], ready_ew,
                                     0.0).amax(dim=1)
        else:
            data_ready = torch.zeros(R, W)
        core_ready = slots[rows, :, ct - 1]
        est = torch.maximum(core_ready, data_ready)
        est = torch.where(cores >= ct[:, None], est, INF)
        w = est.argmin(dim=1)
        finish = est[rows, w] + est_dur[rows, t]
        row = torch.where(ar[None, :] < ct[:, None], finish[:, None],
                          slots[rows, w])
        slots[rows, w] = torch.sort(row, dim=1).values
        aw[rows, t] = w
        fin[rows, t] = finish
        prio[rows, t] = float(T - r)
    return aw, prio


# ------------------------------------------ the kernel's algorithm, one row

def row_model(order, e_task, prod_e, e_obj, valid, cpus, dur, size, bw,
              cores, C, place=True):
    """One row as a warp of ``csrc/list_schedule.cu`` computes it, in
    float32 numpy: the edge lists by task, the level sweep with its
    maxima started at 0.0 unless all E edges are the task's, the ranks
    counted, and the placement with the merge of the finish time into
    the worker's core slots."""
    f32 = np.float32
    T, E, W = len(dur), len(e_task), len(cores)
    ok = valid & (e_task >= 0) & (e_task < T) & (prod_e >= 0) & (prod_e < T)

    def lists(key):
        out = [[] for _ in range(T)]
        for e in np.flatnonzero(ok):
            out[key[e]].append(e)
        return out

    def start(n):
        return f32(-INF) if E > 0 and n == E else f32(0.0)

    lvl = np.zeros(T, f32)
    if order == "tlevel":
        ins = lists(e_task)
        for t in range(T):
            m = start(len(ins[t]))
            for e in ins[t]:
                m = max(m, f32(lvl[prod_e[e]] + dur[prod_e[e]]))
            lvl[t] = m
    else:
        outs = lists(prod_e)
        for t in range(T - 1, -1, -1):
            m = start(len(outs[t]))
            for e in outs[t]:
                m = max(m, lvl[e_task[e]])
            lvl[t] = f32(dur[t] + m)
    key = {"blevel": -lvl, "tlevel": lvl,
           "mcp": (lvl.max() - lvl).astype(f32)}[order]
    rank = np.array([int(np.sum(key < key[t]) + np.sum(key[:t] == key[t]))
                     for t in range(T)])
    prio = (T - rank).astype(f32)
    if not place:
        return prio
    order_t = np.argsort(rank)
    ins = lists(e_task)
    xfer = np.zeros(E, f32)
    xfer[ok] = (size[e_obj[ok]] / bw).astype(f32)
    slots = np.where(np.arange(C)[None, :] < cores[:, None], f32(0.0),
                     f32(INF)).astype(f32)
    aw = np.zeros(T, np.int64)
    fin = np.zeros(T, f32)
    for t in order_t:
        ct = min(max(int(cpus[t]), 1), C)
        acc = np.full(W, start(len(ins[t])), f32)
        for e in ins[t]:
            p = prod_e[e]
            r0, rx = f32(fin[p] + f32(0.0)), f32(fin[p] + xfer[e])
            acc = np.maximum(acc, np.where(np.arange(W) == aw[p], r0, rx))
        est = np.maximum(slots[:, ct - 1], acc)
        est = np.where(cores >= ct, est, f32(INF)).astype(f32)
        w = int(np.flatnonzero(est == est.min())[0])
        finish = f32(est[w] + dur[t])
        old = slots[w].copy()
        below = int(np.sum(old[ct:] < finish))
        slots[w, :below] = old[ct:ct + below]
        slots[w, below:below + ct] = finish
        slots[w, below + ct:] = old[below + ct:]
        aw[t], fin[t] = w, finish
    return aw, prio


# ---------------------------------------------------------------- tests

CASES = {f"{d}_{c}": (GRAPHS[d], CLUSTERS[c])
         for d in GRAPHS for c in CLUSTERS}


@pytest.mark.parametrize("order", LIST_ORDERS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_route_equals_the_seed_scheduler(case, order):
    graphs, clusters = CASES[case]
    g, args = schedule_inputs(graphs, clusters, 6, seed=len(case))
    *tensors, C = args
    est_dur, est_size, bw, cores = tensors[5:]
    want = seed_schedule(order, g, est_dur, est_size, bw, cores, C)
    got = list_schedule(order, *tensors, C)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    via = make_bucket_scheduler(cores.shape[1], None, order, max_cores=C)(
        g, est_dur, est_size, bw, None, cores)
    assert torch.equal(via[0], want[0]) and torch.equal(via[1], want[1])
    if order == "blevel":       # greedy's priorities are blevel's
        assert torch.equal(blevel_priorities(g.e_task, g.prod_e,
                                             g.edge_valid, est_dur), want[1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_priorities_equal_greedys(case):
    graphs, clusters = CASES[case]
    g, args = schedule_inputs(graphs, clusters, 6, seed=3 + len(case))
    est_dur = args[5]
    want = seed_rank_priorities(seed_blevel(g, est_dur))
    got = blevel_priorities(g.e_task, g.prod_e, g.edge_valid, est_dur)
    assert torch.equal(got, want)


EDGE_CASES = {
    "zero_durations": dict(zero_dur=True),
    "no_worker_fits": dict(tiny_cores=True),
    "bandwidth_tiny": dict(bandwidths=(1e-30, 1e-3)),
    "bandwidth_huge": dict(bandwidths=(1e30, INF)),
}


@pytest.mark.parametrize("order", LIST_ORDERS)
@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_plain_route_on_edge_cases(case, order):
    g, args = schedule_inputs(GRAPHS["pegasus"] + GRAPHS["irw"],
                              CLUSTERS["32x16"], 5, seed=11,
                              **EDGE_CASES[case])
    *tensors, C = args
    est_dur, est_size, bw, cores = tensors[5:]
    want = seed_schedule(order, g, est_dur, est_size, bw, cores, C)
    got = list_schedule(order, *tensors, C)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if case == "no_worker_fits":
        # a task of 2+ cores fits no worker: +inf everywhere, worker 0
        big = (g.cpus > 1) & g.task_valid
        assert bool(big.any()) and bool((got[0][big] == 0).all())


def test_plain_route_without_edges():
    g, args = schedule_inputs(GRAPHS["pegasus"], CLUSTERS["8x4"], 3, seed=2)
    *tensors, C = args
    for i in range(4):      # e_task, prod_e, e_obj, edge_valid: E = 0
        tensors[i] = tensors[i][:, :0]
    g0 = dataclasses.replace(g, E=0, e_task=tensors[0], prod_e=tensors[1],
                             e_obj=tensors[2], edge_valid=tensors[3])
    est_dur, est_size, bw, cores = tensors[5:]
    for order in LIST_ORDERS:
        want = seed_schedule(order, g0, est_dur, est_size, bw, cores, C)
        got = list_schedule(order, *tensors, C)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("order", LIST_ORDERS)
@pytest.mark.parametrize("case", ["irw_32x16", "pegasus_8x4",
                                  "zero_durations", "no_worker_fits"])
def test_the_kernels_algorithm_per_row_equals_the_plain_route(case, order):
    kw = EDGE_CASES.get(case, {})
    graphs, clusters = CASES.get(case, (GRAPHS["pegasus"],
                                        CLUSTERS["32x16"]))
    g, args = schedule_inputs(graphs, clusters, 3, seed=7, **kw)
    *tensors, C = args
    aw, prio = list_schedule(order, *tensors, C)
    np_args = [t.numpy() for t in tensors]
    for r in range(3):
        row = [a[r] for a in np_args]
        m_aw, m_prio = row_model(order, *row, C)
        assert np.array_equal(m_aw, aw[r].numpy()), r
        assert np.array_equal(m_prio, prio[r].numpy()), r
        assert np.array_equal(row_model(order, *row, C, place=False),
                              prio[r].numpy())


def test_wrapper_checks_its_inputs_and_counts_no_cpu_launch():
    g, args = schedule_inputs(GRAPHS["pegasus"], CLUSTERS["8x4"], 2, seed=1)
    *tensors, C = args
    before = (LIST_SCHEDULE_LAUNCHES.count,
              dict(LIST_SCHEDULE_LAUNCHES.routes))
    list_schedule("blevel", *tensors, C)
    blevel_priorities(*tensors[:2], tensors[3], tensors[5])
    assert (LIST_SCHEDULE_LAUNCHES.count,
            LIST_SCHEDULE_LAUNCHES.routes) == before
    with pytest.raises(ValueError, match="order"):
        list_schedule("etf", *tensors, C)
    bad = list(tensors)
    bad[5] = tensors[5].double()
    with pytest.raises(TypeError, match="est_dur"):
        list_schedule("blevel", *bad, C)
    bad = list(tensors)
    bad[8] = tensors[8][:1]
    with pytest.raises(ValueError, match="cores"):
        list_schedule("blevel", *bad, C)
    bad = list(tensors)
    bad[1] = tensors[1][:, :-1]
    with pytest.raises(ValueError, match="prod_e"):
        blevel_priorities(bad[0], bad[1], bad[3], bad[5])
    meta = [t.to("meta") for t in tensors]
    with pytest.raises(ValueError, match="no kernel"):
        list_schedule("tlevel", *meta, C)
    mixed = list(tensors)
    mixed[7] = tensors[7].to("meta")
    with pytest.raises(ValueError, match="several devices"):
        list_schedule("blevel", *mixed, C)


@pytest.mark.parametrize("sched", ["blevel", "greedy"])
def test_drive_records_count_no_schedule_launch_on_the_cpu(sched):
    gs = [make_graph("montage", seed=0)]
    runner = make_grid_runner([(x, encode_graph(x)) for x in gs], sched, 4,
                              [2, 2, 1, 1], device="cpu")
    t0 = time.perf_counter()
    runner([dict(bandwidth=100 * 2 ** 20)])
    recs, _ = _spans.span_log(t0, time.perf_counter())
    drives = [r for r in recs if r["name"] == "drive"]
    assert drives and all(r["counters"]["schedule_launches"] == 0
                          for r in drives)
    assert any(r["name"] == "schedule" for r in recs)
