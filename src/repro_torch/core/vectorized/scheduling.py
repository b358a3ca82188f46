"""In-loop vectorized schedulers of the port's dynamic simulator —
the counterpart of ``repro.core.vectorized.scheduling``, batched over
rows.

Every function takes a ``BucketedGraphSpec`` whose leaves are tensors
with a leading row axis ``[R, ...]`` (one simulation per row) and
per-row estimates, bandwidths, seeds and cluster vectors.  The
sequential sweeps of the reference (``fori_loop`` over the T tasks)
become Python loops over tensor operations on all rows at once; on the
card the list schedules (``blevel``, ``tlevel``, ``mcp``) and greedy's
priorities are one kernel instead (``repro_torch.kernels.list_schedule``,
whose plain versions are ``list_schedule_plain`` and
``blevel_priorities_plain`` here).

``VEC_SCHEDULERS`` maps each name to its kind:

* ``"static"`` — one ``task -> worker`` map plus priorities from the
  t=0 estimates: ``blevel``, ``tlevel``, ``mcp`` (list schedulers over
  an earliest-start timeline), ``etf`` (earliest-finish placer) and
  ``random`` (a counter hash of ``(seed, task)``; no RNG state);
* ``"dynamic"`` — ``greedy`` runs at every MSD-gated invocation; inside
  the dynamic simulator's step its placement is one call,
  ``greedy_place_plain`` here and a kernel on the card
  (``repro_torch.kernels.greedy_place``).

Decisions equal the reference's exactly: sorts are stable (ties go to
the smaller index), ``argmin``/``argmax`` return the first extreme, the
uint32 hash is computed in int64 masked to 32 bits, and the transfer
cost segment sum adds each task's edges in edge order on every device.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from ...device import resolve_device
from ._ops import NEG, take
from ._spans import GRAPH_EVENTS
from .specs import BucketedGraphSpec, as_bucketed, spec_rows

# name -> kind; membership == "has a vectorized in-loop implementation"
VEC_SCHEDULERS = {
    "blevel": "static",
    "tlevel": "static",
    "mcp": "static",
    "etf": "static",
    "random": "static",
    "greedy": "dynamic",
}

INF = float("inf")
M32 = 0xFFFFFFFF
BIG = int(np.iinfo(np.int32).max)


@dataclasses.dataclass(frozen=True)
class GraphView:
    """A row-batched spec with index fields widened to int64 (what
    ``gather``/``scatter`` take) and the derived per-edge producer."""
    T: int
    O: int
    E: int
    e_task: torch.Tensor       # i64[R, E]
    e_obj: torch.Tensor        # i64[R, E]
    producer: torch.Tensor     # i64[R, O]
    prod_e: torch.Tensor       # i64[R, E] producing task of each edge
    cpus: torch.Tensor         # i64[R, T]
    n_inputs: torch.Tensor     # i64[R, T]
    durations: torch.Tensor    # f32[R, T]
    sizes: torch.Tensor        # f32[R, O]
    task_valid: torch.Tensor   # bool[R, T]
    obj_valid: torch.Tensor    # bool[R, O]
    edge_valid: torch.Tensor   # bool[R, E]

    @property
    def R(self):
        return self.cpus.shape[0]

    @property
    def device(self):
        return self.cpus.device


def graph_view(bspec) -> GraphView:
    """``GraphView`` of a row-batched tensor spec (passes views through)."""
    if isinstance(bspec, GraphView):
        return bspec
    if not isinstance(bspec, BucketedGraphSpec) or bspec.B is None:
        raise ValueError("expected a row-batched BucketedGraphSpec of "
                         "tensors ([R, ...] leaves)")
    e_task = bspec.edge_task.long()
    e_obj = bspec.edge_obj.long()
    producer = bspec.producer.long()
    return GraphView(
        T=bspec.T, O=bspec.O, E=bspec.E, e_task=e_task, e_obj=e_obj,
        producer=producer, prod_e=take(producer, e_obj),
        cpus=bspec.cpus.long(), n_inputs=bspec.n_inputs.long(),
        durations=bspec.durations.float(), sizes=bspec.sizes.float(),
        task_valid=bspec.task_valid.bool(), obj_valid=bspec.obj_valid.bool(),
        edge_valid=bspec.edge_valid.bool())


def _resolve_cores(n_workers, cores):
    """Per-worker core vector: broadcast a scalar, pass vectors through.
    Zero-core entries are inert padding (no task fits, no slot opens).
    ``None`` passes through — the cluster then arrives at call time."""
    if cores is None:
        return None
    return np.broadcast_to(np.asarray(cores, np.int32), (n_workers,)).copy()


def _static_max_cores(cores_default, max_cores):
    """The static core-count bound (python int) that sizes per-worker
    slot timelines and start loops."""
    if max_cores is not None:
        return max(int(max_cores), 1)
    if cores_default is None:
        raise ValueError("max_cores is required when cores is None (the "
                         "call-time cores binding has no values to bound "
                         "at build time)")
    return max(int(cores_default.max()), 1)


def _cores_arg(cores, cores_default, R, device):
    """The clusters of one call as ``i64[R, W]``: the runtime ``cores``
    argument (``[W]`` or ``[R, W]``), else the build-time vector."""
    if cores is None:
        if cores_default is None:
            raise ValueError("built without a cluster: pass cores at call "
                             "time")
        cores = cores_default
    c = torch.as_tensor(np.asarray(cores) if not torch.is_tensor(cores)
                        else cores, device=device).long()
    if c.dim() == 1:
        c = c.unsqueeze(0).expand(R, -1)
    return c


def bucket_blevel(bspec, est_dur):
    """b-level from *estimated* durations (``f32[R, T]``); task ids are a
    topological order by construction, so one reverse sweep suffices.
    Invalid edges are masked out, so padded tasks keep b-level 0."""
    g = graph_view(bspec)
    return _blevel(g.e_task, g.prod_e, g.edge_valid, est_dur.float())


def _blevel(e_task, prod_e, edge_valid, est_dur):
    R, T = est_dur.shape
    bl = torch.zeros(R, T, dtype=torch.float32, device=est_dur.device)
    if e_task.shape[1] == 0:
        return bl + est_dur
    for t in range(T - 1, -1, -1):
        mask = (prod_e == t) & edge_valid
        child = torch.where(mask, take(bl, e_task), 0.0).amax(dim=1)
        bl[:, t] = est_dur[:, t] + child
    return bl


def bucket_tlevel(bspec, est_dur):
    """t-level (earliest possible start ignoring comm costs) from
    estimated durations; forward sweep over the id-topological order."""
    g = graph_view(bspec)
    return _tlevel(g.e_task, g.prod_e, g.edge_valid, est_dur.float())


def _tlevel(e_task, prod_e, edge_valid, est_dur):
    R, T = est_dur.shape
    tl = torch.zeros(R, T, dtype=torch.float32, device=est_dur.device)
    if e_task.shape[1] == 0:
        return tl
    par_dur = take(est_dur, prod_e)
    for t in range(T):
        mask = (e_task == t) & edge_valid
        tl[:, t] = torch.where(mask, take(tl, prod_e) + par_dur,
                               0.0).amax(dim=1)
    return tl


def rank_priorities(bl):
    """priority = T - rank in decreasing-b-level order (ties: smaller id).
    Padded tasks (b-level 0, largest ids) rank last."""
    R, T = bl.shape
    order = torch.sort(-bl, dim=1, stable=True).indices
    ranks = (T - torch.arange(T, device=bl.device)).float()
    return torch.zeros(R, T, dtype=torch.float32, device=bl.device) \
        .scatter_(1, order, ranks.expand(R, T).contiguous())


# the orders of the static list schedulers, each named by the level its
# ascending sort key is made of (ties go to the smaller id)
LIST_ORDERS = ("blevel", "tlevel", "mcp")


def _order_key(order, e_task, prod_e, edge_valid, est_dur):
    """``f32[R, T]``: the sort key of ``order``: -b-level (blevel/HLFET),
    t-level (tlevel/SCFET), ALAP = CP - b-level (simplified MCP)."""
    if order == "tlevel":
        return _tlevel(e_task, prod_e, edge_valid, est_dur)
    bl = _blevel(e_task, prod_e, edge_valid, est_dur)
    if order == "blevel":
        return -bl
    # padded tasks have b-level 0, so the unmasked max is the true CP
    return bl.amax(dim=1, keepdim=True) - bl


def blevel_priorities_plain(e_task, prod_e, edge_valid, est_dur):
    """The plain version of ``kernels.list_schedule.blevel_priorities``:
    greedy's priorities, ``rank_priorities(bucket_blevel(...))``, from
    the edges' consumers and producers (``i64[R, E]``), their validity
    (``bool[R, E]``) and the estimated durations (``f32[R, T]``)."""
    return rank_priorities(_blevel(e_task, prod_e, edge_valid, est_dur))


def _initial_slots(cores, C):
    """Per-worker core free times ``f32[R, W, C]``, ascending; slots past
    a worker's core count are pinned at +inf."""
    ar = torch.arange(C, device=cores.device)
    return torch.where(ar[None, None, :] < cores[:, :, None], 0.0,
                       INF).float()


def _commit(slots, rows, w, ct, finish):
    """Occupy the ``ct`` earliest core slots of worker ``w`` until
    ``finish`` and keep the row sorted."""
    C = slots.shape[2]
    ar = torch.arange(C, device=slots.device)
    row = torch.where(ar[None, :] < ct[:, None], finish[:, None],
                      slots[rows, w])
    slots[rows, w] = torch.sort(row, dim=1).values


def list_schedule_plain(order, e_task, prod_e, e_obj, edge_valid, cpus,
                        est_dur, est_size, bandwidth, cores, max_cores):
    """The plain version of ``kernels.list_schedule.list_schedule``: the
    static list schedule of ``order`` (``LIST_ORDERS``).  Tasks are
    committed in ascending order of its key (ties: smaller id), each to
    the earliest-start worker over per-core free times (``max_cores``
    slots a worker) with uncontended transfer costs (the estimated size
    of the edge's object over the row's bandwidth).

    Inputs: the edges' consumers, producers and objects (``i64[R, E]``)
    and validity (``bool[R, E]``), the tasks' cores (``i64[R, T]``) and
    estimated durations (``f32[R, T]``), the objects' estimated sizes
    (``f32[R, O]``), the rows' bandwidths (``f32[R]``) and the workers'
    cores (``i64[R, W]``).  Returns ``(assignment i64[R, T], priority
    f32[R, T])``, the priority being T - the task's rank."""
    R, T = est_dur.shape
    W = cores.shape[1]
    dev = est_dur.device
    by_rank = torch.sort(_order_key(order, e_task, prod_e, edge_valid,
                                    est_dur), dim=1, stable=True).indices
    slots = _initial_slots(cores, max_cores)
    xfer = take(est_size, e_obj) / bandwidth[:, None]
    w_ids = torch.arange(W, device=dev)
    rows = torch.arange(R, device=dev)
    aw = torch.zeros(R, T, dtype=torch.int64, device=dev)
    fin = torch.zeros(R, T, dtype=torch.float32, device=dev)
    prio = torch.zeros(R, T, dtype=torch.float32, device=dev)
    for r in range(T):
        t = by_rank[:, r]
        ct = cpus[rows, t]
        if e_task.shape[1]:
            pw = take(aw, prod_e)                  # parents placed earlier
            pf = take(fin, prod_e)
            ready_ew = pf[:, :, None] + torch.where(
                pw[:, :, None] == w_ids, 0.0, xfer[:, :, None])
            mine = (e_task == t[:, None]) & edge_valid
            data_ready = torch.where(mine[:, :, None], ready_ew,
                                     0.0).amax(dim=1)
        else:
            data_ready = torch.zeros(R, W, device=dev)
        core_ready = slots[rows, :, ct - 1]        # cpus-th smallest
        est = torch.maximum(core_ready, data_ready)
        est = torch.where(cores >= ct[:, None], est, INF)
        w = est.argmin(dim=1)                      # ties: smallest id
        finish = est[rows, w] + est_dur[rows, t]
        _commit(slots, rows, w, ct, finish)
        aw[rows, t] = w
        fin[rows, t] = finish
        prio[rows, t] = float(T - r)
    return aw, prio


def _make_bucket_list_scheduler(n_workers, cores, order, max_cores=None):
    """Shared static list-scheduling machinery: commit tasks in
    ``order`` (``LIST_ORDERS``), each to the earliest-start worker over
    per-core free times with uncontended transfer costs, in one call of
    ``kernels.list_schedule.list_schedule`` (a kernel launch on the card,
    ``list_schedule_plain`` on the CPU).

    Returns ``schedule(bspec, est_durations, est_sizes, bandwidth, seed,
    cores) -> (assignment i64[R, T], priority f32[R, T])``."""
    from ...kernels import list_schedule as kernel
    cores_default = _resolve_cores(n_workers, cores)
    C = _static_max_cores(cores_default, max_cores)

    def schedule(bspec, est_dur, est_size, bandwidth, seed=None,
                 cores=None):
        del seed
        g = graph_view(bspec)
        R, dev = g.R, g.device
        cores_t = _cores_arg(cores, cores_default, R, dev)
        bandwidth = torch.as_tensor(bandwidth, device=dev).float()
        bandwidth = bandwidth.expand(R) if bandwidth.dim() == 0 else bandwidth
        return kernel.list_schedule(order, g.e_task, g.prod_e, g.e_obj,
                                    g.edge_valid, g.cpus, est_dur.float(),
                                    est_size.float(), bandwidth, cores_t, C)

    return schedule


def make_bucket_blevel_scheduler(n_workers, cores, max_cores=None):
    """blevel/HLFET: decreasing estimated b-level (ties: smaller id)."""
    return _make_bucket_list_scheduler(n_workers, cores, "blevel",
                                       max_cores)


def make_bucket_tlevel_scheduler(n_workers, cores, max_cores=None):
    """tlevel/SCFET: ascending estimated t-level (ties: smaller id)."""
    return _make_bucket_list_scheduler(n_workers, cores, "tlevel",
                                       max_cores)


def make_bucket_mcp_scheduler(n_workers, cores, max_cores=None):
    """Simplified MCP: ascending ALAP = CP - blevel (ties: smaller id)."""
    return _make_bucket_list_scheduler(n_workers, cores, "mcp", max_cores)


def make_bucket_etf_scheduler(n_workers, cores, max_cores=None):
    """ETF/DLS-style earliest-finish placer: at every step commit, over
    all frontier tasks and eligible workers, the pair with the
    lexicographically smallest (estimated start, -b-level, task id,
    worker id).  Padded tasks are permanent zero-cost frontier members
    whose commits leave the timeline unchanged."""
    W = n_workers
    cores_default = _resolve_cores(n_workers, cores)
    C = _static_max_cores(cores_default, max_cores)

    def schedule(bspec, est_dur, est_size, bandwidth, seed=None,
                 cores=None):
        del seed
        g = graph_view(bspec)
        R, T, E, dev = g.R, g.T, g.E, g.device
        cores_t = _cores_arg(cores, cores_default, R, dev)
        est_dur = est_dur.float()
        bandwidth = torch.as_tensor(bandwidth, device=dev).float()
        bandwidth = bandwidth.expand(R) if bandwidth.dim() == 0 else bandwidth
        bl = bucket_blevel(g, est_dur)
        slots = _initial_slots(cores_t, C)
        xfer = take(est_size.float(), g.e_obj) / bandwidth[:, None]
        eligible_tw = cores_t[:, None, :] >= g.cpus[:, :, None]   # [R,T,W]
        w_ids = torch.arange(W, device=dev)
        rows = torch.arange(R, device=dev)
        flat_bl = bl[:, :, None].expand(R, T, W).reshape(R, T * W)
        cpu_idx = (g.cpus - 1)[:, None, :].expand(R, W, T)
        e_task3 = g.e_task[:, :, None].expand(R, E, W)
        aw = torch.zeros(R, T, dtype=torch.int64, device=dev)
        fin = torch.zeros(R, T, dtype=torch.float32, device=dev)
        done = torch.zeros(R, T, dtype=torch.bool, device=dev)
        prio = torch.zeros(R, T, dtype=torch.float32, device=dev)
        for r in range(T):
            data_ready = torch.zeros(R, T, W, device=dev)
            if E:
                par_done = take(done, g.prod_e) & g.edge_valid
                cnt = torch.zeros(R, T, dtype=torch.int64, device=dev) \
                    .scatter_add_(1, g.e_task, par_done.long())
                pw, pf = take(aw, g.prod_e), take(fin, g.prod_e)
                ready_ew = pf[:, :, None] + torch.where(
                    pw[:, :, None] == w_ids, 0.0, xfer[:, :, None])
                ready_ew = torch.where(g.edge_valid[:, :, None], ready_ew,
                                       0.0)
                data_ready.scatter_reduce_(1, e_task3, ready_ew, "amax",
                                           include_self=True)
            else:
                cnt = torch.zeros(R, T, dtype=torch.int64, device=dev)
            frontier = ~done & (cnt >= g.n_inputs)
            core_ready = slots.gather(2, cpu_idx).transpose(1, 2)
            est = torch.maximum(core_ready, data_ready)
            est = torch.where(frontier[:, :, None] & eligible_tw, est, INF)
            flat_est = est.reshape(R, T * W)
            cand = flat_est == flat_est.amin(dim=1, keepdim=True)
            key = torch.where(cand, flat_bl, NEG)
            cand = cand & (key == key.amax(dim=1, keepdim=True))
            idx = cand.int().argmax(dim=1)         # first = smallest (t, w)
            t, w = idx // W, idx % W
            finish = flat_est[rows, idx] + est_dur[rows, t]
            _commit(slots, rows, w, g.cpus[rows, t], finish)
            aw[rows, t] = w
            fin[rows, t] = finish
            done[rows, t] = True
            prio[rows, t] = float(T - r)
        return aw, prio

    return schedule


def _mul32(x, c: int):
    """``(x * c) mod 2**32`` for ``x`` in ``[0, 2**32)`` held in int64,
    split in 16-bit halves so no intermediate leaves int64."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & M32


def _mix32(x):
    """splitmix-style 32-bit finalizer on int64 tensors holding uint32
    values; the same constants as the reference's uint32 ``_mix32``."""
    x = x & M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def make_bucket_random_scheduler(n_workers, cores, max_cores=None):
    """Counter-based random static scheduler: task t goes to the
    ``hash(seed, t) mod n_eligible``-th eligible worker (id order).
    Priorities are the decreasing-estimated-b-level ranks."""
    del max_cores                    # no per-core timeline to bound
    cores_default = _resolve_cores(n_workers, cores)

    def schedule(bspec, est_dur, est_size, bandwidth, seed=0, cores=None):
        del est_size, bandwidth
        g = graph_view(bspec)
        R, T, dev = g.R, g.T, g.device
        cores_t = _cores_arg(cores, cores_default, R, dev)
        seed_t = torch.as_tensor(seed, device=dev).long()
        seed_u = (seed_t.expand(R) if seed_t.dim() == 0 else seed_t) & M32
        elig = cores_t[:, None, :] >= g.cpus[:, :, None]      # [R, T, W]
        n_cand = elig.sum(dim=2)                              # >= 1
        t_ids = torch.arange(T, device=dev, dtype=torch.int64)
        h = _mix32(_mul32(seed_u, 0x9E3779B9)[:, None] + t_ids + 1)
        k = h % n_cand.clamp(min=1)
        cum = torch.cumsum(elig.long(), dim=2)
        pick = elig & (cum == (k + 1)[:, :, None])
        aw = pick.int().argmax(dim=2)
        return aw, rank_priorities(bucket_blevel(g, est_dur))

    return schedule


_BUCKET_FACTORIES = {
    "blevel": make_bucket_blevel_scheduler,
    "tlevel": make_bucket_tlevel_scheduler,
    "mcp": make_bucket_mcp_scheduler,
    "etf": make_bucket_etf_scheduler,
    "random": make_bucket_random_scheduler,
}


def make_bucket_scheduler(n_workers, cores, name, max_cores=None):
    """Factory for the *static* bucket schedulers: returns
    ``schedule(bspec, est_durations, est_sizes, bandwidth, seed, cores)
    -> (assignment i64[R, T], priority f32[R, T])``.  Raises for dynamic
    entries (``greedy`` has no one-shot schedule)."""
    if name not in _BUCKET_FACTORIES:
        raise KeyError(
            f"no static vectorized scheduler {name!r} "
            f"(have {sorted(_BUCKET_FACTORIES)}; "
            f"dynamic: {sorted(k for k, v in VEC_SCHEDULERS.items() if v == 'dynamic')})")
    return _BUCKET_FACTORIES[name](n_workers, cores, max_cores)


def _float_rows(x, device):
    """``x`` (numpy, list or tensor) as a float32 tensor on ``device``."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def rows_schedule(fn, device):
    """A row-batched static scheduler ``fn`` (``make_bucket_scheduler``'s
    form) as ``schedule(bspec, est_durations, est_sizes, bandwidth,
    seed=0, cores=None)`` on ``device``: the spec may be unbatched
    (shared by the rows), and unbatched estimates give an unbatched
    ``(assignment, priority)``."""
    def schedule(bspec, est_dur, est_size, bandwidth, seed=0, cores=None):
        est_dur = _float_rows(est_dur, device)
        est_size = _float_rows(est_size, device)
        unbatched = est_dur.dim() == 1
        if unbatched:
            est_dur, est_size = est_dur[None], est_size[None]
        rows = spec_rows(bspec, est_dur.shape[0], device)
        aw, prio = fn(rows, est_dur, est_size, bandwidth, seed, cores)
        return (aw[0], prio[0]) if unbatched else (aw, prio)
    return schedule


def _bound(spec, device, fn):
    """``fn(rows_spec, *args)`` bound to one graph's spec on ``device``.
    The arguments keep their dtypes (floats become float32); unbatched
    arguments (``args[0]`` one-dimensional) gain a row axis, and the
    result loses it again."""
    b = as_bucketed(spec)
    dev = resolve_device(device)

    def call(*args):
        args = [a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
                for a in args]
        args = [(a.float() if a.is_floating_point() else a).to(dev)
                for a in args]
        unbatched = args[0].dim() == 1
        if unbatched:
            args = [a[None] for a in args]
        out = fn(spec_rows(b, args[0].shape[0], dev), *args)
        return out[0] if unbatched else out
    return call


def make_vec_scheduler(spec, n_workers, cores, name, *, device="cuda"):
    """Deprecated per-graph factory — use
    ``repro_torch.core.vectorized.api.build(spec, scheduler=name)``.
    Binds ``spec`` now and returns ``schedule(est_durations, est_sizes,
    bandwidth, seed) -> (assignment, priority)`` on ``device``."""
    warnings.warn(
        "make_vec_scheduler is deprecated; use "
        "repro_torch.core.vectorized.api.build(spec, scheduler=...)",
        DeprecationWarning, stacklevel=2)
    return _bind(lambda W, c: make_bucket_scheduler(W, c, name))(
        spec, n_workers, cores, device=device)


def _bind(bucket_factory):
    """The per-graph binding of a static bucket scheduler factory:
    ``make(spec, n_workers, cores, device=) -> schedule(est_durations,
    est_sizes, bandwidth, seed=0)``."""
    def make(spec, n_workers, cores, *, device="cuda"):
        b = as_bucketed(spec)
        schedule = rows_schedule(bucket_factory(n_workers, cores),
                                 resolve_device(device))
        return lambda est_dur, est_size, bandwidth, seed=0: \
            schedule(b, est_dur, est_size, bandwidth, seed)
    return make


make_static_blevel_scheduler = _bind(make_bucket_blevel_scheduler)
make_static_tlevel_scheduler = _bind(make_bucket_tlevel_scheduler)
make_static_mcp_scheduler = _bind(make_bucket_mcp_scheduler)
make_etf_scheduler = _bind(make_bucket_etf_scheduler)
make_random_scheduler = _bind(make_bucket_random_scheduler)


def make_blevel_fn(spec, *, device="cuda"):
    """Legacy binding: close over one graph, return ``blevel(est_dur)``
    (``f32[T]`` or ``[R, T]``)."""
    return _bound(spec, device, bucket_blevel)


def make_tlevel_fn(spec, *, device="cuda"):
    """Legacy binding: close over one graph, return ``tlevel(est_dur)``."""
    return _bound(spec, device, bucket_tlevel)


def frontier_mask(frontier, n):
    """Expand a bounded frontier (``i64[R, C]``, ``-1`` = empty slot) into
    a dense ``bool[R, n]`` membership mask."""
    from ._ops import scatter_or
    return scatter_or(n, frontier.clamp(min=0).long(), frontier >= 0)


def bucket_ready_tasks(bspec, t_done=None, t_started=None, frontier=None):
    """Mask-aware ready set: valid tasks whose produced-input count
    meets ``n_inputs`` (and that haven't started, when ``t_started`` is
    given).  Fed a ``frontier`` the count collapses to expanding the
    bounded list; otherwise it is recomputed from ``t_done``."""
    g = graph_view(bspec)
    if frontier is not None:
        ready = frontier_mask(frontier, g.T)
    else:
        if t_done is None:
            raise ValueError("bucket_ready_tasks needs t_done when no "
                             "frontier is given")
        prod = take(t_done, g.prod_e) & g.edge_valid
        cnt = torch.zeros(g.R, g.T, dtype=torch.int64, device=g.device) \
            .scatter_add_(1, g.e_task, prod.long())
        ready = cnt >= g.n_inputs
    if t_started is not None:
        ready = ready & ~t_started
    return ready & g.task_valid


def edge_table(bspec):
    """``i64[R, T, D]``: each task's valid input edges in edge order,
    ``-1``-padded (``D`` = the largest in-degree).  The order the
    reference's scatter-add visits them, so segment sums over the table
    reproduce its float sums bit for bit, deterministically."""
    g = graph_view(bspec)
    R, T, E, dev = g.R, g.T, g.E, g.device
    if E == 0:
        return torch.full((R, T, 0), -1, dtype=torch.int64, device=dev)
    key = torch.where(g.edge_valid, g.e_task, T)
    sk, order = torch.sort(key, dim=1, stable=True)
    first = torch.searchsorted(sk, sk, right=False)
    pos = torch.arange(E, device=dev)[None, :] - first
    D = int(torch.where(sk < T, pos + 1, 0).amax())  # host read, once
    table = torch.full((R, T + 1, max(D, 1)), -1, dtype=torch.int64,
                       device=dev)
    rows = torch.arange(R, device=dev)[:, None].expand(R, E)
    table[rows, sk, pos.clamp(max=max(D, 1) - 1)] = order
    return table[:, :T, :D]


def bucket_transfer_costs(bspec, size_now, missing_ow, table=None):
    """``f32[R, T, W]``: estimated bytes to move so task t could run on
    worker w (one segment sum).  ``missing_ow``: bool[R, O, W], object
    neither present at nor downloading to the worker.  Invalid edges
    contribute nothing.  The sum adds each task's edges in edge order
    (``edge_table``; pass a precomputed ``table`` inside loops), so it
    is deterministic and equals the reference's sequential scatter-add
    exactly."""
    g = graph_view(bspec)
    if g.E == 0:
        W = missing_ow.shape[-1]
        return torch.zeros(g.R, g.T, W, dtype=torch.float32,
                           device=g.device)
    if table is None:
        table = edge_table(g)
    return table_transfer_costs(table, g.e_obj, size_now, missing_ow)


def table_transfer_costs(table, e_obj, size_now, missing_ow):
    """``bucket_transfer_costs`` from an ``edge_table`` (``i64[R, T,
    D]``) and the edges' objects (``i64[R, E]``): ``0 + size * missing``
    over each task's table entries in order.  The table lists valid
    edges only, so an invalid edge's term is never read."""
    R, T, D = table.shape
    E = e_obj.shape[1]
    W = missing_ow.shape[-1]
    out = torch.zeros(R, T, W, dtype=torch.float32, device=table.device)
    if E == 0:
        return out
    miss_e = missing_ow.gather(1, e_obj[:, :, None].expand(R, E, W))
    contrib = take(size_now.float(), e_obj)[:, :, None] * miss_e  # [R,E,W]
    for k in range(D):
        ids = table[:, :, k]
        v = contrib.gather(1, ids.clamp(min=0)[:, :, None].expand(R, T, W))
        out = out + torch.where((ids >= 0)[:, :, None], v, 0.0)
    return out


def make_transfer_costs(spec, n_workers, *, device="cuda"):
    """Legacy binding of ``bucket_transfer_costs`` for one graph:
    ``costs(size_now f32[O], missing_ow bool[O, W]) -> f32[T, W]`` (or
    all with a leading row axis)."""
    del n_workers
    return _bound(spec, device, bucket_transfer_costs)


def make_bucket_greedy_placer(n_workers, cores):
    """Returns ``place(bspec, ready_unassigned, cost_tw, load0, cores) ->
    i64[R, T]`` (proposed worker per task, -1 where none).

    Tasks are processed in id order; each goes to the worker minimising
    (transfer cost, queued load, worker id), and placing a task bumps
    the load its successors see — the reference's sequential rule.  The
    loop runs over the ready tasks only, compacted per row in id order;
    its length (the largest ready count over the rows) is read on the
    host once per call and added to ``GRAPH_EVENTS["place_iters"]``."""
    cores_default = _resolve_cores(n_workers, cores)

    def place(bspec, ready_unassigned, cost_tw, load0, cores=None):
        g = graph_view(bspec)
        cores_t = _cores_arg(cores, cores_default, g.R, g.device)
        n = int(ready_unassigned.sum(dim=1).amax()) if g.R else 0
        GRAPH_EVENTS["place_iters"] += n
        return _greedy_loop(ready_unassigned, cost_tw, g.cpus, cores_t,
                            load0, n)

    return place


def _greedy_loop(placing, cost_tw, cpus, cores, load0, n):
    """The sequential placement of ``make_bucket_greedy_placer``: the
    ``placing`` tasks of each row in id order, ``n`` of them at most (the
    largest count over the rows, read on the host: the loop runs over
    the tasks compacted per row)."""
    R, T = placing.shape
    dev = placing.device
    pw = torch.full((R, T + 1), -1, dtype=torch.int64, device=dev)
    if n == 0 or T == 0:
        return pw[:, :T]
    t_ids = torch.arange(T, device=dev)
    order = torch.sort(torch.where(placing, t_ids, T), dim=1).values[:, :n]
    load = load0.clone().long()
    rows = torch.arange(R, device=dev)
    for k in range(n):
        t = order[:, k]
        tc = t.clamp(max=T - 1)
        act = (t < T) & placing[rows, tc]
        elig = cores >= cpus[rows, tc][:, None]
        c = torch.where(elig, cost_tw[rows, tc], INF)
        cand = c == c.amin(dim=1, keepdim=True)
        ld = torch.where(cand, load, BIG)
        cand = cand & (ld == ld.amin(dim=1, keepdim=True))
        w = cand.int().argmax(dim=1)           # first = smallest id
        pw[rows, torch.where(act, t, T)] = torch.where(act, w, -1)
        load[rows, w] += act.long()
    return pw[:, :T]


def greedy_place_plain(placing, table, e_obj, size_now, missing, cpus,
                       cores, load0, tally):
    """The plain version of greedy's placement in the dynamic
    simulator's event step (``kernels.greedy_place``'s kernel computes
    the same, bit for bit): ``bucket_transfer_costs`` of the ``placing``
    tasks (``bool[R, T]``) from the edge table (``i64[R, T, D]``), the
    edges' objects (``i64[R, E]``), ``size_now`` (``f32[R, O]``) and
    ``missing`` (``bool[R, O, W]``), then ``make_bucket_greedy_placer``'s
    loop over them with ``cpus`` (``i64[R, T]``), ``cores`` and ``load0``
    (``i64[R, W]``).  Returns ``i64[R, T]``: the proposed worker of each
    placing task, -1 elsewhere.

    The placer's loop length, the largest placing count over the rows,
    is read on the host (it sets the loop's length, and no row placing
    returns at once) and added to ``tally[0]`` (an int64 counter)."""
    R, T = placing.shape
    n = int(placing.sum(dim=1).amax()) if R and T else 0
    tally[0] += n
    if n == 0:
        return torch.full((R, T), -1, dtype=torch.int64,
                          device=placing.device)
    cost_tw = table_transfer_costs(table, e_obj, size_now, missing)
    return _greedy_loop(placing, cost_tw, cpus, cores, load0, n)


def make_greedy_placer(spec, n_workers, cores, *, device="cuda"):
    """Legacy binding of ``make_bucket_greedy_placer`` for one graph:
    ``place(ready_unassigned bool[T], cost_tw f32[T, W], load0 i64[W])
    -> i64[T]`` (or all with a leading row axis)."""
    return _bound(spec, device, make_bucket_greedy_placer(n_workers, cores))
