"""The port's dynamic discrete-event simulator, batched over rows — the
counterpart of ``repro.core.vectorized.sim.make_bucket_dynamic_simulator``
and ``BucketedGridRunner``.

The reference runs one simulation inside ``jax.lax.while_loop`` and
lifts it to a grid with ``jax.vmap``.  PyTorch has no vmap over a
data-dependent loop, so here every carry has a leading row axis
``[R, ...]`` — one row per (cluster, graph, grid point) — and one Python
loop advances all rows together.  Each row has a ``live`` mask; a row
that has finished is frozen with ``torch.where``, never branched on,
which is exactly what vmap of ``while_loop`` does, so ``n_steps`` and
``n_events`` per row equal the reference's.  The host reads
``live.any()`` every ``check_every`` steps, not per event.

Semantics are the reference's default configuration (flow slots on and
the ready frontiers on; ``maxmin`` and ``simple`` netmodels):

* MSD-gated scheduler invocations with event batching, a
  ``decision_delay`` before assignments reach the workers, and imode
  estimates (``est_durations``/``est_sizes``, true values once
  finished);
* static schedules (``blevel``/``tlevel``/``mcp``/``etf``/``random``)
  computed once from the t=0 estimates, or the dynamic ``greedy``
  placer at every invocation;
* downloads from the producing worker, deduplicated per (object,
  destination) with the representative edge pinned when the key first
  becomes wanted; Appendix-A slot limits (``DOWNLOAD_SLOTS`` per
  destination, ``PAIR_SLOTS`` per pair) on the max-min model;
* max-min rates over the bounded flow-slot pool (``S =
  DOWNLOAD_SLOTS * W``), recomputed at every event through
  ``waterfill_impl``: ``"auto"`` launches the CUDA kernel for tensors
  on the card and runs the plain PyTorch version on the CPU,
  ``"torch"`` forces the plain version, ``"cuda"`` requires the kernel.

Mask semantics (padding is inert): invalid tasks are born
started+finished with ``t_finish`` excluded from the makespan; invalid
edges never satisfy inputs, never carry flows, never claim a dedup key;
invalid objects have zero size; zero-core workers never receive tasks.

Scatters of the reference that drop out-of-range indices write into a
buffer one entry wider whose last entry is sliced off; float sums that
decide schedules use a fixed order (``scheduling.bucket_transfer_costs``)
so two runs on the card give bitwise the same result.
"""
from __future__ import annotations

import typing

import numpy as np
import torch

from ...device import resolve_device
from ._ops import (NEG, as_rows, fma32, scatter_count, scatter_max,
                   scatter_min, scatter_or, take)
from .scheduling import (VEC_SCHEDULERS, _cores_arg, _resolve_cores,
                         bucket_blevel, bucket_transfer_costs, edge_table,
                         graph_view, make_bucket_greedy_placer,
                         make_bucket_scheduler, rank_priorities)
from .specs import (BucketedGraphSpec, bucket_shape, encode_graph,
                    frontier_caps_for, pad_spec, pad_to, stack_specs)
from .waterfill import waterfill as waterfill_plain, waterfill_simple

READY_BOOST = 1_000_000.0
TIME_EPS = 1e-6
BYTES_EPS = 1e-3
NEG_TIME = -1e30
INF = float("inf")

# Appendix-A download-slot limits (shared with the reference worker):
# at most DOWNLOAD_SLOTS concurrent downloads per destination worker and
# PAIR_SLOTS per (source, destination) pair under the max-min model.
# They also bound the flow-slot pool: at any instant at most
# S = DOWNLOAD_SLOTS * W flows are in flight.
DOWNLOAD_SLOTS = 4
PAIR_SLOTS = 2


class SimResult(typing.NamedTuple):
    """Result of the dynamic simulator, one entry per row.

    ``makespan`` is NaN whenever ``ok`` is False.  ``overflow`` is the
    honest-failure flag of the bounded carries (flow-slot pool or ready
    frontier): capacity was exceeded and ``ok`` is already poisoned.
    ``n_events`` counts processed completions (tasks + flows);
    ``n_steps`` counts loop iterations (same-timestamp completions are
    batched into one step)."""
    makespan: torch.Tensor      # f32
    transferred: torch.Tensor   # f32 — bytes moved across workers
    ok: torch.Tensor            # bool
    overflow: torch.Tensor      # bool
    n_events: torch.Tensor      # i32
    n_steps: torch.Tensor       # i32


def _frontier_append(fr, new_mask, ids):
    """Append ``ids[new_mask]`` into the free (``-1``) slots of each
    row's bounded frontier ``fr: [R, C]``; returns ``(fr, overflowed)``.
    Candidates fill free slots in index order, both sides ranked by
    cumsum; each free slot binary-searches the candidates' running
    count for its own rank.  ``overflowed[r]`` is True when row r's
    candidates outnumbered its free slots."""
    R, C = fr.shape
    N = new_mask.shape[1]
    if C == 0 or N == 0:                         # degenerate axis
        return fr, new_mask.any(dim=1)
    free = fr < 0
    free_rank = torch.cumsum(free.long(), dim=1)             # 1-based
    cs = torch.cumsum(new_mask.long(), dim=1)                # 1-based
    total_new = cs[:, -1:]
    src = torch.searchsorted(cs, free_rank, right=False)
    take_it = free & (free_rank <= total_new)
    src_c = src.clamp(0, N - 1)
    ids_r = ids.expand(R, N) if ids.dim() == 1 else ids
    fr = torch.where(take_it, take(ids_r, src_c), fr)
    overflowed = total_new[:, 0] > free_rank[:, -1]
    return fr, overflowed


def _resolve_frontier(frontier) -> bool:
    """The ``frontier`` option: ``None``/``True`` select the frontier
    path, the only one the port carries.  ``frontier=False`` (the
    reference's per-edge escape hatch) is not ported."""
    if frontier is False:
        raise NotImplementedError(
            "frontier=False (the per-edge escape hatch) is not ported to "
            "repro_torch; the port runs the default frontier path")
    return True


def _resolve_waterfill_impl(waterfill_impl: str) -> str:
    if waterfill_impl not in ("auto", "torch", "cuda"):
        raise ValueError(f"waterfill_impl must be 'auto'|'torch'|'cuda', "
                         f"got {waterfill_impl!r}")
    return waterfill_impl


def _make_waterfill(waterfill_impl: str, device):
    """The batched max-min solver ``wf(src, dst, active, caps) ->
    rates``.  ``"auto"`` routes through the kernel wrapper, which
    launches the CUDA kernel for tensors on the card and runs the plain
    version for CPU tensors; ``"torch"`` is the plain version on any
    device; ``"cuda"`` requires the kernel (raises for a CPU device)."""
    impl = _resolve_waterfill_impl(waterfill_impl)
    if impl == "torch":
        return lambda src, dst, active, caps: waterfill_plain(
            src, dst, active, caps, caps)
    if impl == "cuda" and torch.device(device).type != "cuda":
        raise ValueError(f"waterfill_impl='cuda' needs a CUDA device, the "
                         f"simulator runs on {device}")
    from ...kernels.waterfill import waterfill as kernel_waterfill
    return lambda src, dst, active, caps: kernel_waterfill(
        src, dst, active, caps, caps)


def _bucket_max(bucket, n_buckets, values):
    """Per-bucket max of ``values`` per row, ``NEG`` where a bucket is
    empty (float max is order-independent, so the scatter is exact)."""
    return scatter_max(n_buckets, bucket, values, NEG)


def _pick_per_bucket(bucket, n_buckets, eligible, *keys):
    """Lexicographic argmax per bucket.  ``keys`` are f32 ``[R, N]``
    (higher wins); the final tie goes to the smallest element index.
    Returns bool[R, N] with at most one True per (row, bucket)."""
    cand = eligible
    for k in keys:
        kk = torch.where(cand, k, NEG)
        mb = take(_bucket_max(bucket, n_buckets, kk), bucket)
        cand = cand & (kk == mb) & (mb > NEG)
    idx = torch.arange(bucket.shape[1], device=bucket.device,
                       dtype=torch.float32)
    ii = torch.where(cand, -idx, NEG)
    mb = take(_bucket_max(bucket, n_buckets, ii), bucket)
    return cand & (ii == mb)


def _acquire_slots(st, pick, dst_e, src_e, bytes_e, W, ids):
    """Move this round's picked flows (<= 1 per destination worker per
    row) into the flow-slot pool: each destination worker owns
    ``DOWNLOAD_SLOTS`` consecutive slots, and a picked flow takes the
    first free one.  ``ids`` is the real edge id per candidate.  A pick
    that finds no free slot sets ``overflow`` (poisons ``ok``)."""
    R, N = pick.shape
    e_ids = torch.arange(N, device=pick.device)
    pe = scatter_max(W, dst_e, torch.where(pick, e_ids, -1), -1)
    occ_w = (st["slot_edge"] >= 0).view(R, W, DOWNLOAD_SLOTS)
    first_free = occ_w.int().argmin(dim=2)
    has_free = ~occ_w.all(dim=2)
    taken = (pe >= 0) & has_free
    pe_c = pe.clamp(min=0)
    put = ((torch.arange(DOWNLOAD_SLOTS, device=pick.device)[None, None, :]
            == first_free[:, :, None]) & taken[:, :, None]).view(R, -1)

    def spread(v):
        return v[:, :, None].expand(R, W, DOWNLOAD_SLOTS).reshape(R, -1)

    st["slot_edge"] = torch.where(put, spread(take(ids, pe_c)),
                                  st["slot_edge"])
    st["slot_src"] = torch.where(put, spread(take(src_e, pe_c)).int(),
                                 st["slot_src"])
    st["slot_rem"] = torch.where(put, spread(take(bytes_e, pe_c)),
                                 st["slot_rem"])
    st["overflow"] = st["overflow"] | ((pe >= 0) & ~has_free).any(dim=1)
    return st


def _check_ok(ok, context: str, overflow=None):
    """Raise instead of letting NaN makespans leak into result tables."""
    ok = np.asarray(ok.cpu() if torch.is_tensor(ok) else ok)
    if not ok.all():
        bad = int(ok.size - ok.sum())
        if overflow is not None:
            ov = np.asarray(overflow.cpu() if torch.is_tensor(overflow)
                            else overflow)
            if ov.any():
                raise RuntimeError(
                    f"{context}: {int(ov.sum())}/{ok.size} simulation(s) "
                    f"overflowed a bounded ready frontier — widen "
                    f"`frontier_caps`")
        raise RuntimeError(
            f"{context}: {bad}/{ok.size} simulation(s) exhausted their "
            f"max_steps event budget before all tasks finished (makespan "
            f"would be NaN) — the schedule likely leaves tasks unable to "
            f"start; raise max_steps only if the graph is genuinely that "
            f"deep")


def _check_cpus_fit(specs, cores, context: str):
    """Host-side guard shared by the runners: every task must fit the
    largest worker."""
    max_cores = int(np.max(cores)) if np.size(cores) else 0
    for spec in specs:
        cpus = np.asarray(spec.cpus if not torch.is_tensor(spec.cpus)
                          else spec.cpus.cpu())
        if cpus.size and int(cpus.max()) > max_cores:
            raise ValueError(
                f"{context}: a task needs {int(cpus.max())} cores but "
                f"the largest worker has {max_cores}")


def _rows_spec(bspec, R, device) -> BucketedGraphSpec:
    """The spec as tensors on ``device`` with exactly ``R`` rows (an
    unbatched spec is repeated)."""
    if not all(torch.is_tensor(v) and v.device == device
               for v in bspec.fields().values()):
        bspec = bspec.to(device)
    if bspec.B is None:
        return bspec.map(lambda x: x.unsqueeze(0).expand(R, -1).contiguous())
    if bspec.B != R:
        raise ValueError(f"spec has {bspec.B} rows but the estimates have "
                         f"{R}")
    return bspec


def make_bucket_dynamic_simulator(n_workers: int, cores,
                                  scheduler: str = "blevel",
                                  netmodel: str = "maxmin",
                                  flow_rounds: int = 4,
                                  max_steps: int | None = None, *,
                                  max_cores: int | None = None,
                                  flow_slots=None, frontier=None,
                                  frontier_caps=None,
                                  waterfill_impl: str = "auto",
                                  device="cuda", check_every: int = 16):
    """Returns ``run(bspec, est_durations, est_sizes, msd,
    decision_delay, bandwidth, seed, cores) -> SimResult``, a batched
    mirror of the reference simulator's event loop with its
    dynamic-scheduling machinery (see the module docstring).

    Every argument of ``run`` may carry a leading row axis: the spec
    ``[R, ...]`` (or one unbatched spec shared by all rows), estimates
    ``f32[R, T]`` / ``f32[R, O]`` padded to the bucket shape, ``msd``,
    ``decision_delay``, ``bandwidth``, ``seed`` as scalars or ``[R]``,
    and ``cores`` as ``[W]`` or ``[R, W]`` (zero-core entries are inert
    padded workers).  Unbatched estimates give unbatched results.

    ``device`` (default ``"cuda"``) is where the rows run; it raises
    when CUDA is requested and no card is present.  ``check_every`` is
    how many steps pass between the host's reads of "is any row still
    live".  ``flow_slots=False`` and ``frontier=False`` (the reference's
    per-edge escape hatches) are not ported and raise."""
    if scheduler not in VEC_SCHEDULERS:
        raise KeyError(f"unknown vectorized scheduler {scheduler!r} "
                       f"(have {sorted(VEC_SCHEDULERS)})")
    if netmodel not in ("maxmin", "simple"):
        raise ValueError(f"unknown netmodel {netmodel!r} (have 'maxmin', "
                         f"'simple')")
    if flow_slots is False:
        raise NotImplementedError(
            "flow_slots=False (the per-edge escape hatch) is not ported to "
            "repro_torch; the port runs the default flow-slot path")
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    dev = resolve_device(device)
    W = n_workers
    cores_default = _resolve_cores(n_workers, cores)
    if max_cores is None:
        if cores_default is None:
            raise ValueError("max_cores is required when cores is None")
        max_cores = max(int(cores_default.max()), 1)
    max_cores = max(int(max_cores), 1)
    simple = netmodel == "simple"
    use_slots_cfg = not simple
    _resolve_frontier(frontier)
    wf = None if simple else _make_waterfill(waterfill_impl, dev)
    S = W * DOWNLOAD_SLOTS
    dynamic_sched = VEC_SCHEDULERS[scheduler] == "dynamic"
    if dynamic_sched:
        static_schedule = None
        greedy_place = make_bucket_greedy_placer(W, cores_default)
    else:
        static_schedule = make_bucket_scheduler(W, cores_default, scheduler,
                                                max_cores)
        greedy_place = None

    def run(bspec, est_durations, est_sizes, msd=0.0, decision_delay=0.0,
            bandwidth=100 * 1024 * 1024.0, seed=0, cores=None):
        est_d = torch.as_tensor(np.asarray(est_durations)
                                if not torch.is_tensor(est_durations)
                                else est_durations, device=dev).float()
        est_s = torch.as_tensor(np.asarray(est_sizes)
                                if not torch.is_tensor(est_sizes)
                                else est_sizes, device=dev).float()
        unbatched = est_d.dim() == 1
        if unbatched:
            est_d, est_s = est_d.unsqueeze(0), est_s.unsqueeze(0)
        R = est_d.shape[0]
        spec = _rows_spec(bspec, R, dev)
        g = graph_view(spec)
        T, O, E = g.T, g.O, g.E
        F = O * W
        steps_cap = (max_steps if max_steps is not None
                     else 10 * (T + E) + 8 * W + 1024)
        cores_t = _cores_arg(cores, cores_default, R, dev)
        use_slots = use_slots_cfg and E > 0
        e_task, e_obj, prod_e = g.e_task, g.e_obj, g.prod_e
        producer, n_inputs, cpus = g.producer, g.n_inputs, g.cpus
        task_valid, edge_valid = g.task_valid, g.edge_valid
        durations_true, sizes_true = g.durations, g.sizes
        e_ids = torch.arange(E, device=dev)
        t_ids = torch.arange(T, device=dev)
        w_ids = torch.arange(W, device=dev)
        e_bytes = torch.where(edge_valid, take(sizes_true, e_obj), 0.0)
        # estimates are defensively masked: padded entries always 0
        est_dur = torch.where(task_valid, est_d, 0.0)
        est_size = torch.where(g.obj_valid, est_s, 0.0)
        msd_ = as_rows(msd, R, torch.float32, dev)
        delay = as_rows(decision_delay, R, torch.float32, dev)
        bandwidth_ = as_rows(bandwidth, R, torch.float32, dev)
        seed_ = as_rows(seed, R, torch.int64, dev)
        slot_dst = (torch.arange(S, device=dev) // DOWNLOAD_SLOTS)
        slot_dst_k = slot_dst.int().expand(R, S).contiguous()
        caps = bandwidth_[:, None].expand(R, W).contiguous()
        c_gran = torch.tensor(6e-7, dtype=torch.float32, device=dev)
        c_eps = torch.tensor(TIME_EPS, dtype=torch.float32, device=dev)

        if dynamic_sched:
            greedy_prio = rank_priorities(bucket_blevel(g, est_dur))
            p_worker0 = torch.full((R, T), -1, dtype=torch.int64, device=dev)
            p_prio0 = torch.zeros(R, T, device=dev)
            p_time0 = torch.full((R, T), INF, device=dev)
            table = edge_table(g) if E else None
        else:
            # static schedule == the single invocation at t=0, computed
            # from pure estimates; it reaches workers after the delay
            aw0, prio0 = static_schedule(g, est_dur, est_size, bandwidth_,
                                         seed_, cores_t)
            p_worker0 = torch.where(task_valid, aw0, -1)
            p_prio0 = prio0
            p_time0 = torch.where(task_valid, delay[:, None], INF)

        if frontier_caps is None:
            CF, CT = frontier_caps_for((T, O, E))
        else:
            # an explicit override never exceeds the axis itself
            CF, CT = min(frontier_caps[0], E), min(frontier_caps[1], T)

        def zf(*shape):
            return torch.zeros(*shape, dtype=torch.float32, device=dev)

        def zb(*shape):
            return torch.zeros(*shape, dtype=torch.bool, device=dev)

        def zl(*shape):
            return torch.zeros(*shape, dtype=torch.int64, device=dev)

        st = dict(
            now=zf(R),
            last=torch.full((R,), NEG_TIME, device=dev),
            events=torch.ones(R, dtype=torch.bool, device=dev),
            aw=torch.full((R, T), -1, dtype=torch.int64, device=dev),
            ap=zf(R, T),
            pw=p_worker0, pp=p_prio0, pt=p_time0,
            t_started=~task_valid,
            t_done=~task_valid,
            t_finish=torch.full((R, T), INF, device=dev),
            free=cores_t.clone(),
            steps=zl(R),
            n_events=zl(R),
            overflow=zb(R),
            enq_t=zb(R, T),
            in_cnt=zl(R, T),
            fr_task=torch.full((R, CT), -1, dtype=torch.int64, device=dev),
        )
        if use_slots:
            st.update(
                slot_edge=torch.full((R, S), -1, dtype=torch.int64,
                                     device=dev),
                slot_src=torch.zeros(R, S, dtype=torch.int32, device=dev),
                slot_rem=zf(R, S),
                fr_flow=torch.full((R, CF), -1, dtype=torch.int64,
                                   device=dev),
                transferred=zf(R),
            )
        else:
            # simple netmodel (or no edges): flows are the input edges
            st.update(f_started=zb(R, E), f_done=zb(R, E),
                      f_rem=e_bytes.clone())
        if E > 0:
            st.update(key_q=zb(R, F), key_done=zb(R, F))

        # --------------------------------------------------- scheduler
        def apply_due(st):
            due = (st["pw"] >= 0) & (st["pt"] <= st["now"][:, None]
                                     + TIME_EPS)
            st["aw"] = torch.where(due, st["pw"], st["aw"])
            st["ap"] = torch.where(due, st["pp"], st["ap"])
            st["pw"] = torch.where(due, -1, st["pw"])
            st["pt"] = torch.where(due, INF, st["pt"])
            return st

        def invoke(st, live):
            due = st["events"] & (st["last"] + msd_ <= st["now"] + TIME_EPS)
            ready_t = st["in_cnt"] >= n_inputs
            ready_un = (ready_t & (st["aw"] < 0) & (st["pw"] < 0)
                        & ~st["t_done"])
            # only rows that invoke now (and are live) place anything; the
            # placements of the others are discarded, so skip them
            placing = ready_un & (due & live)[:, None]
            if bool(placing.any()):
                if E == 0:
                    cost_tw = zf(R, T, W)
                else:
                    prod = take(st["t_done"], producer)          # [R, O]
                    prod_w = take(st["aw"], producer)
                    done_ow = st["key_done"].view(R, O, W)
                    if use_slots:
                        sk = take(e_obj, st["slot_edge"].clamp(min=0)) * W \
                            + slot_dst
                        dl_ow = scatter_or(F, sk, st["slot_edge"] >= 0)
                    else:
                        key_e = e_obj * W + take(st["aw"], e_task).clamp(
                            min=0)
                        done_ow = scatter_or(F, key_e, st["f_done"])
                        dl_ow = scatter_or(F, key_e,
                                           st["f_started"] & ~st["f_done"])
                        done_ow = done_ow.view(R, O, W)
                    dl_ow = dl_ow.view(R, O, W)
                    local_ow = (prod_w[:, :, None] == w_ids) \
                        & prod[:, :, None]
                    missing = ~(local_ow | done_ow | dl_ow)
                    size_now = torch.where(prod, sizes_true, est_size)
                    cost_tw = bucket_transfer_costs(g, size_now, missing,
                                                    table)
                queued = (((st["aw"] >= 0) | (st["pw"] >= 0))
                          & ~st["t_started"] & ~st["t_done"])
                qworker = torch.where(st["aw"] >= 0, st["aw"], st["pw"])
                load0 = scatter_count(W, qworker.clamp(min=0), queued)
                new_pw = greedy_place(g, placing, cost_tw, load0, cores_t)
                newly = due[:, None] & (new_pw >= 0)
                st["pw"] = torch.where(newly, new_pw, st["pw"])
                st["pp"] = torch.where(newly, greedy_prio, st["pp"])
                st["pt"] = torch.where(newly, (st["now"] + delay)[:, None],
                                       st["pt"])
            st["events"] = st["events"] & ~due
            st["last"] = torch.where(due, st["now"], st["last"])
            return st

        # ----------------------------------------------------- workers
        def start_flows_frontier(st, keymax):
            """Max-min flow picks over the pinned candidate list; the
            slot pool holds in-flight state and Appendix-A occupancy.
            ``-edge_id`` reproduces the reference's tie-break."""
            fr = st["fr_flow"]
            cid = fr.clamp(min=0)
            alive = fr >= 0
            c_dst = take(st["aw"], take(e_task, cid)).clamp(min=0)
            c_src = take(st["aw"], take(prod_e, cid)).clamp(min=0)
            c_pair = c_src * W + c_dst
            c_prio = take(keymax, take(e_obj, cid) * W + c_dst)
            c_bytes = take(e_bytes, cid)
            neg_id = -fr.float()
            occ = st["slot_edge"] >= 0
            dcnt = occ.view(R, W, DOWNLOAD_SLOTS).sum(dim=2)
            pair_s = st["slot_src"].long() * W + slot_dst
            pcnt = scatter_count(W * W, pair_s, occ)
            alive0 = alive
            for _ in range(flow_rounds):
                eligible = (alive & (take(dcnt, c_dst) < DOWNLOAD_SLOTS)
                            & (take(pcnt, c_pair) < PAIR_SLOTS))
                pick = _pick_per_bucket(c_dst, W, eligible, c_prio, neg_id)
                st = _acquire_slots(st, pick, c_dst, c_src, c_bytes, W,
                                    ids=fr)
                # occupancy moves only by this round's own picks: at
                # most one per destination worker
                pw_pair = scatter_max(W, c_dst, torch.where(pick, c_pair,
                                                            -1), -1)
                picked_w = pw_pair >= 0
                dcnt = dcnt + picked_w.long()
                pcnt = pcnt + scatter_count(W * W, pw_pair.clamp(min=0),
                                            picked_w)
                alive = alive & ~pick
            st["fr_flow"] = torch.where(alive0 & ~alive, -1, fr)
            return st

        def start_tasks_frontier(st):
            """Appendix-A start rounds over the bounded enabled list —
            invariantly exactly the enabled & assigned & not-started
            tasks, so blocking matches the full [T] scan."""
            fr = st["fr_task"]
            tid = fr.clamp(min=0)
            alive = fr >= 0
            c_w = take(st["aw"], tid).clamp(min=0)
            c_cpus = take(cpus, tid)
            c_prio = take(st["ap"], tid)
            c_fin = take(durations_true, tid)
            neg_id = -fr.float()
            alive0 = alive
            free = st["free"]
            for _ in range(max_cores):
                free_at = take(free, c_w)
                blocked = alive & (c_cpus > free_at)
                maxblk = _bucket_max(c_w, W, torch.where(blocked, c_prio,
                                                         NEG))
                cand = alive & (c_cpus <= free_at) \
                    & (c_prio >= take(maxblk, c_w))
                pick = _pick_per_bucket(c_w, W, cand, c_prio, neg_id)
                # <= 1 pick per worker, so the core delta is a max
                free = free - scatter_max(W, c_w, torch.where(pick, c_cpus,
                                                              0), 0)
                alive = alive & ~pick
            newly = alive0 & ~alive
            dest = torch.where(newly, fr, T)
            started = torch.cat([st["t_started"], zb(R, 1)], dim=1)
            started.scatter_(1, dest, True)
            fin_now = (st["now"][:, None] + c_fin)
            t_finish = torch.cat([st["t_finish"], zf(R, 1)], dim=1)
            t_finish.scatter_(1, dest, fin_now)
            st["t_started"] = started[:, :T]
            st["t_finish"] = t_finish[:, :T]
            st["free"] = free
            st["fr_task"] = torch.where(newly, -1, fr)
            return st

        def rates_of(st):
            if not use_slots:
                return waterfill_simple(st["f_started"] & ~st["f_done"],
                                        bandwidth_)
            occ = st["slot_edge"] >= 0
            return wf(st["slot_src"], slot_dst_k, occ, caps)

        # -------------------------------------------------------- body
        def body(st, live):
            st = dict(st)
            st = apply_due(st)
            if dynamic_sched:
                st = invoke(st, live)
                st = apply_due(st)           # decision_delay == 0
            # fused O(E) detection pass: new (producer-done,
            # consumer-assigned) pairs become flow candidates (dedup rep
            # pinned per key) and satisfied edges
            ready_t = st["in_cnt"] >= n_inputs
            keymax = None
            key_e = None
            if E > 0:
                aw_e = take(st["aw"], e_task)
                src_e = take(st["aw"], prod_e)
                key_e = e_obj * W + aw_e.clamp(min=0)
                assigned = (aw_e >= 0) & edge_valid
                prod_done = take(st["t_done"], prod_e)
                cross = assigned & (src_e >= 0) & (src_e != aw_e)
                raw = take(st["ap"], e_task) + READY_BOOST \
                    * take(ready_t, e_task).float()
                raw = torch.where(assigned, raw, NEG)
                keymax = scatter_max(F, key_e, raw, NEG)
                want = cross & prod_done & ~take(st["key_q"], key_e)
                rep = scatter_min(F, key_e, torch.where(want, e_ids, E), E)
                new_flow = want & (take(rep, key_e) == e_ids)
                st["key_q"] = st["key_q"] | (rep < E)
                sat = assigned & ((prod_done & (src_e == aw_e))
                                  | take(st["key_done"], key_e))
                sat_cnt = scatter_count(T, e_task, sat)
                enabled = ((sat_cnt >= n_inputs) & (st["aw"] >= 0)
                           & ~st["t_started"])
                if use_slots:
                    fr_flow, ov = _frontier_append(st["fr_flow"], new_flow,
                                                   e_ids)
                    st["fr_flow"] = fr_flow
                    st["overflow"] = st["overflow"] | ov
                else:
                    # simple netmodel: no slot limits — pinned reps
                    # start the moment they become wanted
                    st["f_started"] = st["f_started"] | new_flow
            else:
                enabled = (st["aw"] >= 0) & ~st["t_started"]
            new_en = enabled & ~st["enq_t"]
            fr_task, ov_t = _frontier_append(st["fr_task"], new_en, t_ids)
            st["fr_task"] = fr_task
            st["enq_t"] = st["enq_t"] | new_en
            st["overflow"] = st["overflow"] | ov_t
            if use_slots:
                st = start_flows_frontier(st, keymax)
            st = start_tasks_frontier(st)
            rates = rates_of(st)
            running = st["t_started"] & ~st["t_done"]
            now = st["now"]
            t_next = torch.where(running, st["t_finish"], INF).amin(dim=1)
            # the reference's compiler contracts both multiply-adds of the
            # time advance into FMAs; fma32 rounds them the same way
            gran = fma32(now, c_gran, c_eps)
            if use_slots:
                active = st["slot_edge"] >= 0
                rem = st["slot_rem"]
            else:
                active = st["f_started"] & ~st["f_done"]
                rem = st["f_rem"]
            # double-where: rate-0 lanes must not divide
            safe_rates = torch.where(rates > 0, rates, 1.0)
            f_eta = torch.where(active & (rates > 0), rem / safe_rates, INF)
            f_eta = torch.where(f_eta <= gran[:, None], 0.0, f_eta)
            if f_eta.shape[1]:
                f_next = now + f_eta.amin(dim=1)
            else:
                f_next = torch.full_like(now, INF)
            nxt = torch.minimum(t_next, f_next)
            nxt = torch.minimum(nxt, st["pt"].amin(dim=1))
            if dynamic_sched:
                sched_next = torch.where(
                    st["events"], torch.maximum(now, st["last"] + msd_), INF)
                nxt = torch.minimum(nxt, sched_next)
            nxt = torch.maximum(nxt, now)              # never go back
            finite = torch.isfinite(nxt)
            dt = torch.where(finite, nxt - now, 0.0)
            now = torch.where(finite, nxt, now)
            rem = torch.where(active, fma32(-rates, dt[:, None], rem), rem)
            done_now = active & ((rem <= BYTES_EPS)
                                 | (rem <= rates * gran[:, None]))
            t_newly = running & (st["t_finish"] <= now[:, None] + TIME_EPS)
            # finished tasks all have aw >= 0
            st["free"] = st["free"] + torch.zeros(
                R, W, dtype=torch.int64, device=dev).scatter_add_(
                    1, st["aw"].clamp(min=0), torch.where(t_newly, cpus, 0))
            if E > 0:
                st["in_cnt"] = st["in_cnt"] + scatter_count(
                    T, e_task, take(t_newly, prod_e) & edge_valid)
            st["now"] = now
            st["t_done"] = st["t_done"] | t_newly
            st["events"] = st["events"] | t_newly.any(dim=1)
            st["steps"] = st["steps"] + 1
            st["n_events"] = (st["n_events"] + t_newly.sum(dim=1)
                              + done_now.sum(dim=1))
            if use_slots:
                se = st["slot_edge"]
                sec = se.clamp(min=0)
                # a finished slot completes its whole (obj, dst) key
                sk = take(e_obj, sec) * W + slot_dst
                st["slot_rem"] = rem
                st["slot_edge"] = torch.where(done_now, -1, se)
                st["key_done"] = st["key_done"] | scatter_or(F, sk, done_now)
                st["transferred"] = st["transferred"] + torch.where(
                    done_now, take(e_bytes, sec), 0.0).sum(dim=1)
                return st
            st["f_rem"] = rem
            st["f_done"] = st["f_done"] | done_now
            if E > 0:
                st["key_done"] = st["key_done"] | scatter_or(F, key_e,
                                                             done_now)
            return st

        def cond(st):
            # an overflowed frontier is no longer sound — stop and report
            return ((~st["t_done"].all(dim=1)) & (st["steps"] < steps_cap)
                    & ~st["overflow"])

        live = cond(st)
        step = 0
        while True:
            if step % check_every == 0 and not bool(live.any()):
                break
            new = body(st, live)
            st = {k: torch.where(live.view((R,) + (1,) * (v.dim() - 1)),
                                 new[k], v) for k, v in st.items()}
            live = cond(st)
            step += 1

        makespan = torch.where(st["t_done"] & task_valid, st["t_finish"],
                               0.0).amax(dim=1)
        if use_slots:
            transferred = st["transferred"]
        else:
            transferred = torch.where(st["f_done"], e_bytes, 0.0).sum(dim=1)
        overflow = st["overflow"]
        ok = st["t_done"].all(dim=1) & ~overflow
        makespan = torch.where(ok, makespan, float("nan"))
        res = SimResult(makespan, transferred, ok, overflow,
                        st["n_events"].int(), st["steps"].int())
        if unbatched:
            res = SimResult(*(x[0] for x in res))
        return res

    return run


def _points_arrays(points):
    points = list(points)
    if not points:
        raise ValueError("dynamic grid needs at least one point "
                         "(got an empty points iterable)")
    M = np.array([p.get("msd", 0.0) for p in points], np.float32)
    DD = np.array([p.get("decision_delay", 0.0) for p in points],
                  np.float32)
    BW = np.array([p.get("bandwidth", 100 * 1024 * 1024.0)
                   for p in points], np.float32)
    SD = np.array([p.get("seed", 0) for p in points], np.int32)
    return points, M, DD, BW, SD


class DynamicGridRunner:
    """Reusable dynamic-grid executor for one (graph, scheduler, cluster,
    netmodel) — the counterpart of the reference's ``DynamicGridRunner``.

    Built once on ``build(spec, dynamic=True, device=...)`` with the
    graph's own spec, so its frontier caps are the spec-derived ones the
    reference uses (it overflows where the reference does).  Each call
    runs one row per grid point; the per-imode estimate encodings are
    cached across calls.  Pass a prebuilt ``spec`` (``encode_graph``) to
    share the encoding when many runners sweep the same graph; ``cores``
    may be a scalar or a per-worker list.  For whole graph sets in one
    call, see ``BucketedGridRunner``."""

    def __init__(self, graph, scheduler, n_workers, cores,
                 netmodel="maxmin", max_steps=None, spec=None, *,
                 device="cuda"):
        self.device = resolve_device(device)
        self.graph = graph
        self.scheduler = scheduler
        if spec is None:
            spec = encode_graph(graph)
        from .api import build
        self.run = build(spec, n_workers=n_workers, cores=cores,
                         scheduler=scheduler, netmodel=netmodel,
                         dynamic=True, max_steps=max_steps,
                         device=self.device)
        self._est = {}

    def _estimates(self, name):
        if name not in self._est:
            from ..imodes import encode_imode
            self._est[name] = encode_imode(self.graph, name)
        return self._est[name]

    def __call__(self, points):
        """``points``: iterable of dicts with keys ``msd``,
        ``decision_delay``, ``imode``, ``bandwidth`` and ``seed``
        (missing keys default to 0 / "exact" / 100 MiB/s / 0).  Returns
        numpy ``(makespans f32[N], transferred f32[N])`` in point order;
        raises if any grid point failed."""
        points, M, DD, BW, SD = _points_arrays(points)
        D = np.stack([self._estimates(p.get("imode", "exact"))[0]
                      for p in points])
        S = np.stack([self._estimates(p.get("imode", "exact"))[1]
                      for p in points])
        res = self.run(D, S, M, DD, BW, SD.astype(np.int64))
        _check_ok(res.ok, f"simulate_dynamic_grid({self.graph.name!r}, "
                          f"{self.scheduler!r})", res.overflow)
        return res.makespan.cpu().numpy(), res.transferred.cpu().numpy()


class BucketedGridRunner:
    """One batched simulator call for a whole *shape bucket* of graphs on
    a group of same-W clusters for one (scheduler, netmodel).

    ``entries`` is ``[(graph, spec), ...]`` (or ``{name: (graph,
    spec)}``); every member is padded to the common bucket shape and
    stacked, so ``__call__(points)`` runs the full [clusters x graphs x
    points] grid as ``R = K * B * N`` rows of one simulator call.
    Rows are flattened graph-major, then point, then cluster — row
    ``(b * N + n) * K + k``.

    ``cores`` is a scalar, a per-worker list, or a stacked ``[K, W]``
    matrix of K same-W cluster signatures (shorter clusters padded with
    zero-core workers).  ``__call__`` returns a ``SimResult`` of numpy
    arrays shaped ``[K, B, N]`` and raises if any simulation failed.
    """

    def __init__(self, entries, scheduler, n_workers, cores,
                 netmodel="maxmin", max_steps=None, shape=None,
                 batch=None, est_cache=None, *, device="cuda",
                 waterfill_impl="auto", flow_rounds=4, frontier_caps=None,
                 check_every=16):
        self.device = resolve_device(device)
        if isinstance(entries, dict):
            entries = list(entries.values())
        entries = [(g, encode_graph(g) if s is None else s)
                   for g, s in entries]
        self.graphs = [g for g, _ in entries]
        self.specs = [s for _, s in entries]
        self.names = [g.name for g in self.graphs]
        self.scheduler = scheduler
        arr = np.asarray(cores)
        if arr.ndim <= 1:
            clusters = _resolve_cores(n_workers, cores)[None, :]
        else:
            clusters = arr.astype(np.int32)
        if clusters.shape[-1] != n_workers:
            raise ValueError(f"cores matrix is {clusters.shape[-1]} wide "
                             f"but n_workers={n_workers}")
        self.clusters = clusters
        for k in range(clusters.shape[0]):
            _check_cpus_fit(self.specs, clusters[k],
                            f"BucketedGridRunner({scheduler!r})")
        self.shape = tuple(shape) if shape is not None \
            else bucket_shape(self.specs)
        if batch is not None:
            if batch.shape != self.shape or batch.B != len(self.specs):
                raise ValueError(
                    f"prebuilt batch {batch.shape}xB{batch.B} does not "
                    f"match {self.shape}xB{len(self.specs)}")
            self.bspec = batch
        else:
            self.bspec = stack_specs([pad_spec(s, self.shape)
                                      for s in self.specs])
        self._bspec_dev = self.bspec.to(self.device)
        self.run = make_bucket_dynamic_simulator(
            n_workers, None, scheduler, netmodel, flow_rounds, max_steps,
            max_cores=max(int(clusters.max()), 1),
            frontier_caps=frontier_caps, waterfill_impl=waterfill_impl,
            device=self.device, check_every=check_every)
        self._est = {} if est_cache is None else est_cache

    @property
    def B(self):
        return len(self.graphs)

    @property
    def K(self):
        return self.clusters.shape[0]

    def _estimates(self, name):
        """Padded, stacked estimates for one imode: (f32[B, T], f32[B, O])."""
        if name not in self._est:
            from ..imodes import encode_imode
            T, O, _ = self.shape
            ds, ss = [], []
            for g in self.graphs:
                d, s = encode_imode(g, name)
                ds.append(pad_to(d, T))
                ss.append(pad_to(s, O))
            self._est[name] = (np.stack(ds), np.stack(ss))
        return self._est[name]

    def row_inputs(self, points):
        """The flattened ``R = K * B * N`` row arguments of one grid call:
        ``(spec, est_durations, est_sizes, msd, decision_delay,
        bandwidth, seed, cores)`` as tensors on the runner's device."""
        points, M, DD, BW, SD = _points_arrays(points)
        K, B, N = self.K, self.B, len(points)
        D = np.stack([self._estimates(p.get("imode", "exact"))[0]
                      for p in points], axis=1)          # [B, N, T]
        Sz = np.stack([self._estimates(p.get("imode", "exact"))[1]
                       for p in points], axis=1)         # [B, N, O]
        b_of = np.repeat(np.arange(B), N * K)
        n_of = np.tile(np.repeat(np.arange(N), K), B)
        k_of = np.tile(np.arange(K), B * N)
        dev = self.device
        b_idx = torch.as_tensor(b_of, device=dev)
        spec = self._bspec_dev.map(lambda x: x.index_select(0, b_idx))

        def put(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=dev)

        return (spec, put(D[b_of, n_of]), put(Sz[b_of, n_of]),
                put(M[n_of]), put(DD[n_of]), put(BW[n_of]),
                put(SD[n_of].astype(np.int64)),
                put(self.clusters[k_of].astype(np.int64)))

    def __call__(self, points):
        """Run the grid; returns ``SimResult`` of numpy ``[K, B, N]``
        arrays with the graph axis in ``self.names`` order."""
        points = list(points)
        K, B, N = self.K, self.B, len(points)
        res = self.run(*self.row_inputs(points))
        out = SimResult(*(x.cpu().numpy().reshape(B, N, K)
                          .transpose(2, 0, 1) for x in res))
        _check_ok(out.ok, f"{type(self).__name__}({self.names!r}, "
                          f"{self.scheduler!r})", out.overflow)
        return out


def simulate_dynamic_grid(graph, scheduler, n_workers, cores, points,
                          netmodel="maxmin", max_steps=None, *,
                          device="cuda"):
    """One-shot convenience wrapper around ``DynamicGridRunner``."""
    return DynamicGridRunner(graph, scheduler, n_workers, cores, netmodel,
                             max_steps, device=device)(points)
