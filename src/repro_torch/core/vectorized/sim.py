"""The port's discrete-event simulators, batched over rows — the
counterparts of ``repro.core.vectorized.sim``: the static simulator
(``make_bucket_simulator``: the caller's ``task -> worker`` schedule),
the dynamic one (``make_bucket_dynamic_simulator``: an in-loop
scheduler) and the dynamic grid runner ``BucketedGridRunner``.

The reference runs one simulation inside ``jax.lax.while_loop`` and
lifts it to a grid with ``jax.vmap``.  PyTorch has no vmap over a
data-dependent loop, so here every carry has a leading row axis
``[R, ...]`` — one row per (cluster, graph, grid point, schedule) — and
one Python loop advances all rows together (``_drive``).  Each row has a
``live`` mask; a row that has finished is frozen with ``torch.where``,
never branched on, which is exactly what vmap of ``while_loop`` does, so
``n_steps`` and ``n_events`` per row equal the reference's.  The host
reads ``live.any()`` every ``check_every`` steps, not per event.

A step writes into the carry's own tensors (``_step_into``), so the
carry keeps its addresses and, on a card, each simulator call captures
one step in a CUDA graph and replays it for every later step
(``step_graph``; the counterpart of the reference's one compiled
program): once captured, a step costs the host one launch.  ``greedy``
places tasks on the device too (``kernels.greedy_place``: one kernel, no
host read), so its whole step replays from the graph as well.

Semantics are the reference's: by default flow slots on for ``maxmin``
and none for ``simple``, the ready frontiers on, and its per-edge escape
hatches ``flow_slots=False`` (one flow per input edge) and
``frontier=False`` (every edge and task scanned at every event):

* the static simulator takes a fixed schedule with msd 0 and no
  decision delay;
* the dynamic one adds MSD-gated scheduler invocations with event
  batching, a ``decision_delay`` before assignments reach the workers,
  and imode estimates (``est_durations``/``est_sizes``, true values once
  finished); static schedules (``blevel``/``tlevel``/``mcp``/``etf``/
  ``random``) are computed once from the t=0 estimates (on a card the
  list schedules ``blevel``/``tlevel``/``mcp``, and greedy's priorities,
  in one launch of ``kernels.list_schedule`` a call), the dynamic
  ``greedy`` placer runs at every invocation;
* downloads come from the producing worker, deduplicated per (object,
  destination) (the static path knows every key's representative edge
  up front; the dynamic one pins it when the key first becomes wanted);
  Appendix-A slot limits (``DOWNLOAD_SLOTS`` per destination,
  ``PAIR_SLOTS`` per pair) on the max-min model;
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

import contextlib
import typing
import warnings

import numpy as np
import torch

from ...device import resolve_device
from ._ops import (NEG, as_rows, fma32, scatter_count, scatter_max,
                   scatter_min, scatter_or, take)
from ._spans import (GRAPH_EVENTS, PLACE, POLL, REPLAY, STEP, count,
                     drive, prepared, span)
from .scheduling import (VEC_SCHEDULERS, _cores_arg, _resolve_cores,
                         edge_table, graph_view, make_bucket_scheduler)
from .specs import (as_bucketed, bucket_shape, encode_graph,
                    frontier_caps_for, pad_spec, pad_to, spec_rows,
                    stack_specs)
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


def _resolve_frontier(frontier, *, simple: bool, use_slots: bool,
                      dynamic: bool) -> bool:
    """The ``frontier`` tri-state of the reference: ``None`` selects the
    frontier path wherever it is supported, ``False`` the per-edge scan.
    The dynamic max-min frontier derives in-flight state from the slot
    pool, so it needs flow slots: asking for both ``frontier=True`` and
    ``flow_slots=False`` there raises, while ``None`` quietly stays on
    the per-edge path."""
    if frontier is False:
        return False
    if dynamic and not simple and not use_slots:
        if frontier is True:
            raise ValueError(
                "frontier=True requires flow_slots on the dynamic max-min "
                "path (in-flight flow state is derived from the slot "
                "pool); drop flow_slots=False or pass frontier=False")
        return False
    return True


def _resolve_waterfill_impl(waterfill_impl: str) -> str:
    if waterfill_impl not in ("auto", "torch", "cuda"):
        raise ValueError(f"waterfill_impl must be 'auto'|'torch'|'cuda', "
                         f"got {waterfill_impl!r}")
    return waterfill_impl


def _make_waterfill(waterfill_impl: str, device, graph: bool = False):
    """The batched max-min solver ``wf(src, dst, active, caps) ->
    rates``.  ``"auto"`` routes through the kernel wrapper, which
    launches the CUDA kernel for tensors on the card and runs the plain
    version for CPU tensors; ``"torch"`` is the plain version on any
    device; ``"cuda"`` requires the kernel (raises for a CPU device).
    In a step run from a CUDA graph (``graph``) the plain version cannot
    read the host, so it runs all of its rounds."""
    impl = _resolve_waterfill_impl(waterfill_impl)
    if impl == "torch":
        return lambda src, dst, active, caps: waterfill_plain(
            src, dst, active, caps, caps, sync=not graph)
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


def _rows_arg(x, R, dtype, device):
    """A per-task/object argument as ``[R, n]`` on ``device``: ``[n]`` is
    shared by every row."""
    t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                        device=device).to(dtype)
    return t.unsqueeze(0).expand(R, -1) if t.dim() == 1 else t


def _frontier_caps(frontier_caps, T, O, E):
    """``(CF, CT)``: the shape-derived caps, or the override."""
    if frontier_caps is None:
        return frontier_caps_for((T, O, E))
    # an explicit override never exceeds the axis itself
    return min(frontier_caps[0], E), min(frontier_caps[1], T)


def _slot_counts(st, W, slot_dst):
    """Appendix-A occupancy from the flow-slot pool: in-flight downloads
    per destination worker ``[R, W]`` and per (source, destination) pair
    ``[R, W*W]``."""
    occ = st["slot_edge"] >= 0
    R = occ.shape[0]
    dcnt = occ.view(R, W, DOWNLOAD_SLOTS).sum(dim=2)
    pcnt = scatter_count(W * W, st["slot_src"].long() * W + slot_dst, occ)
    return dcnt, pcnt


def _flow_rounds(st, c_dst, c_src, c_prio, c_bytes, W, flow_rounds,
                 slot_dst, edge_counts=None):
    """The max-min flow picks of one event over the candidate frontier
    ``st["fr_flow"]`` (``c_*``: each candidate's destination, source,
    download priority and bytes): ``flow_rounds`` rounds of at most one
    pick per destination worker under the Appendix-A slot limits.  With
    the slot pool each pick moves into it; with per-edge flows
    (``edge_counts``: the occupancy ``(dcnt, pcnt)`` of the in-flight
    edges) every pick starts its edge in ``st["f_started"]``.
    ``-edge_id`` reproduces the reference's tie-break."""
    fr = st["fr_flow"]
    alive = fr >= 0
    c_pair = c_src * W + c_dst
    neg_id = -fr.float()
    if edge_counts is None:
        dcnt, pcnt = _slot_counts(st, W, slot_dst)
    else:
        dcnt, pcnt = edge_counts
    alive0 = alive
    for _ in range(flow_rounds):
        eligible = (alive & (take(dcnt, c_dst) < DOWNLOAD_SLOTS)
                    & (take(pcnt, c_pair) < PAIR_SLOTS))
        pick = _pick_per_bucket(c_dst, W, eligible, c_prio, neg_id)
        if edge_counts is None:
            st = _acquire_slots(st, pick, c_dst, c_src, c_bytes, W, ids=fr)
        # occupancy moves only by this round's own picks: at most one
        # per destination worker
        pw_pair = scatter_max(W, c_dst, torch.where(pick, c_pair, -1), -1)
        picked_w = pw_pair >= 0
        dcnt = dcnt + picked_w.long()
        pcnt = pcnt + scatter_count(W * W, pw_pair.clamp(min=0), picked_w)
        alive = alive & ~pick
    picked = alive0 & ~alive
    if edge_counts is not None:
        # one deferred write for all rounds' starts
        st["f_started"] = _set_where(st["f_started"], picked, fr)
    st["fr_flow"] = torch.where(picked, -1, fr)
    return st


def _set_where(flags, mask, idx):
    """``flags`` (bool ``[R, n]``) with True written at ``idx[r, j]``
    wherever ``mask[r, j]``: the reference's ``.at[where(mask, idx,
    n)].set(True, mode="drop")``, through a buffer one entry wider."""
    R, n = flags.shape
    out = torch.cat([flags, torch.zeros(R, 1, dtype=torch.bool,
                                        device=flags.device)], dim=1)
    out.scatter_(1, torch.where(mask, idx, n), True)
    return out[:, :n]


def _task_rounds(st, c_w, c_cpus, c_prio, c_fin, W, max_cores):
    """Appendix-A start rounds over the enabled-task frontier
    ``st["fr_task"]`` (``c_*``: each candidate's worker, cores, priority
    and duration).  The frontier holds exactly the enabled, assigned,
    not-started tasks, so blocking matches a full scan; ``-task_id`` is
    the reference's tie-break.  Every round shares ``st["now"]``, so the
    starts of all rounds land in one write."""
    R, T = st["t_started"].shape
    fr = st["fr_task"]
    alive = fr >= 0
    neg_id = -fr.float()
    alive0 = alive
    free = st["free"]
    for _ in range(max_cores):
        free_at = take(free, c_w)
        blocked = alive & (c_cpus > free_at)
        maxblk = _bucket_max(c_w, W, torch.where(blocked, c_prio, NEG))
        cand = alive & (c_cpus <= free_at) & (c_prio >= take(maxblk, c_w))
        pick = _pick_per_bucket(c_w, W, cand, c_prio, neg_id)
        # <= 1 pick per worker, so the core delta is a max
        free = free - scatter_max(W, c_w, torch.where(pick, c_cpus, 0), 0)
        alive = alive & ~pick
    newly = alive0 & ~alive
    dest = torch.where(newly, fr, T)
    started = torch.cat([st["t_started"], torch.zeros(
        R, 1, dtype=torch.bool, device=fr.device)], dim=1)
    started.scatter_(1, dest, True)
    t_finish = torch.cat([st["t_finish"], torch.zeros(
        R, 1, dtype=torch.float32, device=fr.device)], dim=1)
    t_finish.scatter_(1, dest, st["now"][:, None] + c_fin)
    st["t_started"] = started[:, :T]
    st["t_finish"] = t_finish[:, :T]
    st["free"] = free
    st["fr_task"] = torch.where(newly, -1, fr)
    return st


def _granule(device):
    """The float32 constants of the time granule ``now * 6e-7 + 1e-6``
    on ``device`` (made once per run, not per step)."""
    return (torch.tensor(6e-7, dtype=torch.float32, device=device),
            torch.tensor(TIME_EPS, dtype=torch.float32, device=device))


def _advance(st, rates, active, rem, granule, next_extra=None):
    """One event step's time advance: the next task finish or flow
    completion (or ``next_extra``, another ``[R]`` candidate time), with
    the flows' remaining bytes integrated to it.  ETAs below the float32
    time granule at ``now`` (``granule``: ``_granule``'s constants)
    complete at once.  Returns ``(running, now, rem, done_now,
    t_newly)``.  The reference's compiler contracts the granule and
    ``rem - rates * dt`` into fused multiply-adds; ``fma32`` rounds them
    the same way."""
    now = st["now"]
    running = st["t_started"] & ~st["t_done"]
    t_next = torch.where(running, st["t_finish"], INF).amin(dim=1)
    gran = fma32(now, *granule)
    # double-where: rate-0 lanes must not divide
    safe_rates = torch.where(rates > 0, rates, 1.0)
    f_eta = torch.where(active & (rates > 0), rem / safe_rates, INF)
    f_eta = torch.where(f_eta <= gran[:, None], 0.0, f_eta)
    if f_eta.shape[1]:
        # inactive and rate-0 lanes are inf (the where above), so the
        # unmasked min is exact
        f_next = now + f_eta.amin(dim=1)  # simlint: disable=PY205
    else:
        f_next = torch.full_like(now, INF)
    nxt = torch.minimum(t_next, f_next)
    if next_extra is not None:
        nxt = torch.minimum(nxt, next_extra)
    nxt = torch.maximum(nxt, now)                  # never go back
    finite = torch.isfinite(nxt)
    dt = torch.where(finite, nxt - now, 0.0)
    now = torch.where(finite, nxt, now)
    rem = torch.where(active, fma32(-rates, dt[:, None], rem), rem)
    done_now = active & ((rem <= BYTES_EPS) | (rem <= rates * gran[:, None]))
    t_newly = running & (st["t_finish"] <= now[:, None] + TIME_EPS)
    return running, now, rem, done_now, t_newly


def _resolve_step_graph(step_graph: str, device) -> bool:
    """Whether the event step runs from a CUDA graph: ``"auto"`` on a
    card, never on the CPU; ``"graph"`` requires a card (raises on the
    CPU); ``"eager"`` issues every op of every step from the host."""
    if step_graph not in ("auto", "graph", "eager"):
        raise ValueError(f"step_graph must be 'auto'|'graph'|'eager', got "
                         f"{step_graph!r}")
    on_card = torch.device(device).type == "cuda"
    if step_graph == "graph" and not on_card:
        raise ValueError(f"step_graph='graph' needs a CUDA device, the "
                         f"simulator runs on {device}")
    return step_graph == "graph" or (step_graph == "auto" and on_card)


# a private hook of the step checks (``repro_torch.analysis``): when
# set, ``_drive`` hands it ``(st, live, body, cond)`` once per call,
# before the first step
_DRIVE_OBSERVER = None

# ``GRAPH_EVENTS`` (``_spans``): the process-wide odometers of the event
# loops (``calls``, ``captures``, ``replays``, ``polls``, and the
# counters of a call's flows and placements), read as scoped deltas by
# ``engine.capture_counter``; a step's own device counters
# (``place_iters``, ``slot_busy``, ``frontier_peak``) reach them through
# ``_drive``'s ``tallies``, read once a call.
# Beside them every runner call leaves one tree of spans (``grid_call``
# down to ``_drive``'s step 0, capture, replays and polls) in
# ``_spans.LOG``: timestamps and sums always on, ``record_function``
# ranges only while a profiler runs.


def _capture(step, device):
    """Record one call of ``step`` into a CUDA graph on ``device``
    (``torch.cuda.graph``: a side stream and a private memory pool) and
    return ``(replay, free)``; ``free`` releases the graph and its pool.
    The capture runs nothing, so the kernel launches it recorded (K1's
    and greedy's placement) are taken off their ``LAUNCHES`` and every
    replay adds them back: a graph run counts the launches an eager run
    of the same call counts.  A capture that fails raises."""
    from ...kernels._launch import on_device
    from ...kernels.greedy_place import LAUNCHES as PLACE_LAUNCHES
    from ...kernels.waterfill import LAUNCHES as WATERFILL_LAUNCHES
    counters = (WATERFILL_LAUNCHES, PLACE_LAUNCHES)
    marks = [c.mark() for c in counters]
    graph = torch.cuda.CUDAGraph()
    with on_device(device), torch.cuda.graph(graph):
        step()
    recorded = [c.take_since(m) for c, m in zip(counters, marks)]
    GRAPH_EVENTS["captures"] += 1

    def replay():
        with on_device(device):
            graph.replay()
        for c, r in zip(counters, recorded):
            c.add_recorded(r)
        GRAPH_EVENTS["replays"] += 1

    return replay, graph.reset


def _step_into(st, live, fn, cond=None):
    """One step written into the carry: ``fn(st, live)`` gives the new
    values, and each changed entry is frozen where a row is not live
    (what vmap of ``while_loop`` does) and written into the carry's own
    tensor, so the carry keeps its addresses from step to step (a CUDA
    graph replays on them).  With ``cond`` the ``live`` mask is then
    recomputed in place."""
    new = fn(st, live)
    R = live.shape[0]
    for k, v in st.items():
        if new[k] is not v:
            torch.where(live.view((R,) + (1,) * (v.dim() - 1)), new[k], v,
                        out=v)
    if cond is not None:
        live.copy_(cond(st))


def _drive(st, body, cond, check_every, graph=False, device=None,
           tallies=None):
    """Advance every row until none is live and return the carry.
    ``body(st, live)`` is one event step of all rows, run by
    ``_step_into``: a row that is no longer live is frozen, so its
    ``n_steps`` and ``n_events`` equal the reference's.  The host reads
    "any row live" every ``check_every`` steps.

    ``graph=False`` runs every step eagerly.  With ``graph=True`` step 0
    runs eagerly (a real step, and the warm-up that loads every kernel
    before capture); then one step is captured on the carry into a CUDA
    graph on ``device`` and replayed for every later step, and the graph
    and its pool are freed when the loop ends.  ``tallies`` (``{name:
    tensor or int}``) are the call's counters: the tensors, which the
    step adds to on the device, are read together once after the loop,
    and each value is counted into ``GRAPH_EVENTS[name]``
    (``_spans.count``).

    The call is one ``drive`` span (``_spans``): ``loop`` around every
    step and poll, once-records ``step0``, ``capture`` and ``free``, and
    the per-step spans summed into the drive record (``replay`` each
    replayed step, ``step`` each later eager step, ``poll`` each read of
    ``live``, so ``polls`` = steps / ``check_every`` + 1).  The spans
    take timestamps around work that is there; only greedy's ``place``
    sits inside the step, and it times the step's eager runs and the
    capture's recording, never a replay."""
    with drive():
        # the carry's own tensors
        st = {k: v.clone() for k, v in st.items()}
        live = cond(st)
        if _DRIVE_OBSERVER is not None:
            _DRIVE_OBSERVER(st, live, body, cond)
        GRAPH_EVENTS["calls"] += 1
        replay = free = None
        try:
            with span("loop"):
                step = 0
                while True:
                    if step % check_every == 0:
                        GRAPH_EVENTS["polls"] += 1
                        with POLL:
                            more = bool(live.any())
                        if not more:
                            break
                    if step == 0:
                        with span("step0"):
                            _step_into(st, live, body, cond)
                    elif not graph:
                        with STEP:
                            _step_into(st, live, body, cond)
                    else:
                        if replay is None:
                            with span("capture"):
                                replay, free = _capture(
                                    lambda: _step_into(st, live, body, cond),
                                    device)
                        with REPLAY:
                            replay()
                    step += 1
        finally:
            if free is not None:
                with span("free"):
                    free()
        tallies = dict(tallies or {})
        on_device = [k for k, v in tallies.items() if torch.is_tensor(v)]
        if on_device:
            tallies.update(zip(on_device, torch.stack(
                [tallies[k] for k in on_device]).tolist()))
        for name, value in tallies.items():
            count(name, value)
    return st


def _count_flows(tally, live, occupied, frontier=None):
    """The flow path's device counters, kept inside the step with no
    host read: ``tally[0]`` gains the download slots ``occupied`` in
    live rows, and ``tally[1]`` rises to the fullest candidate-flow
    ``frontier`` (ids, ``-1`` where free) of a live row."""
    tally[0].add_((occupied & live[:, None]).sum())
    if frontier is not None:
        live_fill = ((frontier >= 0) & live[:, None]).sum(dim=1)
        torch.maximum(tally[1], live_fill.amax(), out=tally[1])


def _live(steps_cap, stop_on_overflow=True):
    """The loop condition.  On the frontier path an overflowed frontier
    is no longer sound, so its row stops and reports; the per-edge path
    runs on, as the reference's does (``ok`` is poisoned either way)."""
    def cond(st):
        live = (~st["t_done"].all(dim=1)) & (st["steps"] < steps_cap)
        return live & ~st["overflow"] if stop_on_overflow else live
    return cond


def _result(st, task_valid, transferred, unbatched):
    makespan = torch.where(st["t_done"] & task_valid, st["t_finish"],
                           0.0).amax(dim=1)
    overflow = st["overflow"]
    ok = st["t_done"].all(dim=1) & ~overflow
    makespan = torch.where(ok, makespan, float("nan"))
    res = SimResult(makespan, transferred, ok, overflow,
                    st["n_events"].int(), st["steps"].int())
    if unbatched:
        res = SimResult(*(x[0] for x in res))
    return res


def _check_netmodel_options(netmodel, check_every):
    if netmodel not in ("maxmin", "simple"):
        raise ValueError(f"unknown netmodel {netmodel!r} (have 'maxmin', "
                         f"'simple')")
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")


def _max_cores(cores_default, max_cores):
    if max_cores is None:
        if cores_default is None:
            raise ValueError("max_cores is required when cores is None")
        max_cores = max(int(cores_default.max()), 1)
    return max(int(max_cores), 1)


def make_bucket_simulator(n_workers: int, cores, netmodel: str = "maxmin",
                          flow_rounds: int = 4, max_steps: int | None = None,
                          *, max_cores: int | None = None, flow_slots=None,
                          frontier=None, frontier_caps=None,
                          waterfill_impl: str = "auto", device="cuda",
                          check_every: int = 16, step_graph: str = "auto"):
    """Returns ``run(bspec, assignment, priority, durations, sizes,
    bandwidth, cores) -> SimResult``: the static simulator, a batched
    mirror of the reference's ``make_bucket_simulator``.  The schedule
    is the caller's (``task -> worker`` and priorities), msd and the
    decision delay are 0.

    Every argument of ``run`` may carry a leading row axis: the spec
    ``[R, ...]`` (or one unbatched spec shared by all rows),
    ``assignment`` ``i32[R, T]``, ``priority`` ``f32[R, T]`` (or ``[T]``
    shared by the rows), ``durations`` ``[R, T]`` and ``sizes`` ``[R,
    O]`` (``None``: the spec's own), ``bandwidth`` a scalar or ``[R]``,
    and ``cores`` ``[W]`` or ``[R, W]`` (build with ``cores=None`` and
    ``max_cores`` to pass it at call time).  An unbatched assignment
    gives an unbatched result.

    The default is the reference's: the ready frontiers on, flow slots
    on for ``maxmin`` and none for ``simple``.  Its per-edge escape
    hatches are the reference's too: ``flow_slots=False`` keeps one
    ``[R, E]`` flow per input edge (the max-min solve then runs over
    ``F = E`` flows), ``frontier=False`` scans every edge and task at
    every event in place of the bounded frontiers.  ``device``,
    ``check_every``, ``waterfill_impl`` and ``step_graph`` are as for
    ``make_bucket_dynamic_simulator``; the whole step is captured in
    every mode."""
    _check_netmodel_options(netmodel, check_every)
    simple = netmodel == "simple"
    use_slots_cfg = flow_slots is not False and not simple
    use_frontier = _resolve_frontier(frontier, simple=simple,
                                     use_slots=use_slots_cfg, dynamic=False)
    dev = resolve_device(device)
    graph = _resolve_step_graph(step_graph, dev)
    W = n_workers
    cores_default = _resolve_cores(n_workers, cores)
    max_cores = _max_cores(cores_default, max_cores)
    wf = None if simple else _make_waterfill(waterfill_impl, dev, graph)
    S = W * DOWNLOAD_SLOTS

    @prepared
    def run(bspec, assignment, priority, durations=None, sizes=None,
            bandwidth=100 * 1024 * 1024.0, cores=None):
        a = torch.as_tensor(np.asarray(assignment)
                            if not torch.is_tensor(assignment)
                            else assignment, device=dev).long()
        unbatched = a.dim() == 1
        if unbatched:
            a = a.unsqueeze(0)
        R = a.shape[0]
        spec = spec_rows(bspec, R, dev)
        g = graph_view(spec)
        T, O, E = g.T, g.O, g.E
        steps_cap = max_steps if max_steps is not None else 4 * (T + E) + 64
        cores_t = _cores_arg(cores, cores_default, R, dev)
        assignment = a.clamp(0, W - 1)
        priority = _rows_arg(priority, R, torch.float32, dev)
        durations = (g.durations if durations is None
                     else _rows_arg(durations, R, torch.float32, dev))
        sizes = (g.sizes if sizes is None
                 else _rows_arg(sizes, R, torch.float32, dev))
        bandwidth_ = as_rows(bandwidth, R, torch.float32, dev)
        use_slots = use_slots_cfg and E > 0
        # the frontier's own flow list: max-min flows, slots or per edge
        flow_frontier = use_frontier and not simple and E > 0
        e_task, e_obj, prod_e = g.e_task, g.e_obj, g.prod_e
        n_inputs, cpus = g.n_inputs, g.cpus
        task_valid, edge_valid = g.task_valid, g.edge_valid
        e_ids = torch.arange(E, device=dev)
        t_ids = torch.arange(T, device=dev)
        # the schedule is fixed, so every flow's ends are known up front
        f_dst = take(assignment, e_task)           # flow = input edge
        f_src = take(take(assignment, g.producer), e_obj)
        f_pair = f_src * W + f_dst
        prio_e = take(priority, e_task)
        cross = (f_src != f_dst) & edge_valid
        # dedup: one flow per (object, destination) key, carried by the
        # key's smallest valid edge id
        key = e_obj * W + f_dst
        rep = take(scatter_min(O * W, key, torch.where(edge_valid, e_ids, E),
                               E), key)
        needed = cross & (rep == e_ids) & edge_valid
        rep_c = rep.clamp(max=max(E - 1, 0))       # in range for gathers
        f_bytes = torch.where(edge_valid, take(sizes, e_obj), 0.0)
        CF, CT = _frontier_caps(frontier_caps, T, O, E)
        slot_dst = torch.arange(S, device=dev) // DOWNLOAD_SLOTS
        slot_dst_k = slot_dst.int().expand(R, S).contiguous()
        caps = bandwidth_[:, None].expand(R, W).contiguous()
        granule = _granule(dev)
        e_ids_r = e_ids.expand(R, E)
        # the per-edge max-min solve reads the flows' ends as int32
        f_src_k, f_dst_k = f_src.int(), f_dst.int()

        st = dict(
            now=torch.zeros(R, device=dev),
            t_started=~task_valid,
            t_done=~task_valid,
            t_finish=torch.full((R, T), INF, device=dev),
            free=cores_t.clone(),
            steps=torch.zeros(R, dtype=torch.int64, device=dev),
            n_events=torch.zeros(R, dtype=torch.int64, device=dev),
            overflow=torch.zeros(R, dtype=torch.bool, device=dev),
        )
        if use_frontier:
            st["fr_task"], st["overflow"] = _frontier_append(
                torch.full((R, CT), -1, dtype=torch.int64, device=dev),
                (n_inputs <= 0) & task_valid, t_ids)
            st["sat_cnt"] = torch.zeros(R, T, dtype=torch.int64, device=dev)
        if flow_frontier:
            st.update(in_cnt=torch.zeros(R, T, dtype=torch.int64,
                                         device=dev),
                      fr_flow=torch.full((R, CF), -1, dtype=torch.int64,
                                         device=dev))
        if use_slots:
            st.update(
                slot_edge=torch.full((R, S), -1, dtype=torch.int64,
                                     device=dev),
                slot_src=torch.zeros(R, S, dtype=torch.int32, device=dev),
                slot_rem=torch.zeros(R, S, device=dev),
            )
        if use_frontier and use_slots:
            # flow identity lives in the slot pool, satisfaction in
            # sat_cnt: no per-edge carry at all
            st["transferred"] = torch.zeros(R, device=dev)
        elif E > 0:
            st.update(f_started=torch.zeros(R, E, dtype=torch.bool,
                                            device=dev),
                      f_done=torch.zeros(R, E, dtype=torch.bool, device=dev))
            if not use_slots:
                st["f_rem"] = f_bytes.clone()

        def edge_counts(st):
            """Appendix-A occupancy of the in-flight per-edge flows."""
            act = st["f_started"] & ~st["f_done"] & needed
            return scatter_count(W, f_dst, act), scatter_count(W * W, f_pair,
                                                               act)

        def rates_of(st):
            """``(active, rem, rates)`` of this event's flows."""
            if use_slots:
                active = st["slot_edge"] >= 0
                return active, st["slot_rem"], wf(st["slot_src"], slot_dst_k,
                                                  active, caps)
            if E == 0:
                active = torch.zeros(R, 0, dtype=torch.bool, device=dev)
                rem = torch.zeros(R, 0, device=dev)
                return active, rem, rem
            active = st["f_started"] & ~st["f_done"] & needed
            if simple:
                return active, st["f_rem"], waterfill_simple(active,
                                                              bandwidth_)
            return active, st["f_rem"], wf(f_src_k, f_dst_k, active, caps)

        def advance(st):
            """The time advance and the completions of this event."""
            active, rem, rates = rates_of(st)
            _, now, rem, done_now, t_newly = _advance(st, rates, active, rem,
                                                      granule)
            st["free"] = st["free"] + torch.zeros(
                R, W, dtype=torch.int64, device=dev).scatter_add_(
                    1, assignment, torch.where(t_newly, cpus, 0))
            st["now"] = now
            st["t_done"] = st["t_done"] | t_newly
            st["steps"] = st["steps"] + 1
            st["n_events"] = (st["n_events"] + t_newly.sum(dim=1)
                              + done_now.sum(dim=1))
            return st, rem, done_now, t_newly

        def body(st, live):
            """One event of the frontier path."""
            st = dict(st)
            if flow_frontier:
                # the download priority stays exact: one scatter-max over
                # all edges into the (object, destination) key space per
                # event, gathered at the candidates
                ready_t = st["in_cnt"] >= n_inputs
                raw = torch.where(edge_valid, prio_e + READY_BOOST
                                  * take(ready_t, e_task).float(), NEG)
                keymax = scatter_max(O * W, key, raw, NEG)
                cid = st["fr_flow"].clamp(min=0)
                st = _flow_rounds(st, take(f_dst, cid), take(f_src, cid),
                                  take(keymax, take(key, cid)),
                                  take(f_bytes, cid), W, flow_rounds,
                                  slot_dst, None if use_slots
                                  else edge_counts(st))
            tid = st["fr_task"].clamp(min=0)
            st = _task_rounds(st, take(assignment, tid), take(cpus, tid),
                              take(priority, tid), take(durations, tid), W,
                              max_cores)
            st, rem, done_now, t_newly = advance(st)
            if E == 0:
                return st
            t_newly_e = take(t_newly, prod_e)
            if use_slots:
                se = st["slot_edge"]
                sec = se.clamp(min=0)
                # this event's completions per edge; satisfaction folds
                # into sat_cnt, so no per-edge carry survives
                newly_done_e = scatter_or(E, sec, done_now)
                st["slot_rem"] = rem
                st["slot_edge"] = torch.where(done_now, -1, se)
                st["transferred"] = st["transferred"] + torch.where(
                    done_now, take(f_bytes, sec), 0.0).sum(dim=1)
            else:
                newly_done_e = done_now
                st["f_rem"] = rem
                st["f_done"] = st["f_done"] | done_now
                if simple:
                    # no slot limits: produced flows start at once
                    # (active from the next event on)
                    st["f_started"] = st["f_started"] | (needed & t_newly_e)
            # frontier maintenance: fold this event's completions into
            # the incremental counts, then append the new candidates
            moved_sat = cross & take(newly_done_e, rep_c)
            local_sat = t_newly_e & ~cross & edge_valid
            sat_cnt = st["sat_cnt"] + scatter_count(T, e_task,
                                                    moved_sat | local_sat)
            newly_en = ((sat_cnt >= n_inputs) & (st["sat_cnt"] < n_inputs)
                        & task_valid)
            st["sat_cnt"] = sat_cnt
            st["fr_task"], ov = _frontier_append(st["fr_task"], newly_en,
                                                 t_ids)
            if flow_frontier:
                st["in_cnt"] = st["in_cnt"] + scatter_count(
                    T, e_task, t_newly_e & edge_valid)
                st["fr_flow"], ov_f = _frontier_append(
                    st["fr_flow"], needed & t_newly_e, e_ids)
                ov = ov | ov_f
            st["overflow"] = st["overflow"] | ov
            return st

        def start_flows_edges(st):
            """Flow starts of the per-edge scan: every produced, needed,
            not-started edge is a candidate."""
            produced = take(st["t_done"], prod_e)
            cnt = scatter_count(T, e_task, produced & edge_valid)
            raw = torch.where(edge_valid, prio_e + READY_BOOST * take(
                cnt >= n_inputs, e_task).float(), NEG)
            f_prio = take(scatter_max(O * W, key, raw, NEG), key)
            base = needed & ~st["f_started"] & produced
            if simple:
                st["f_started"] = st["f_started"] | base
                return st
            for _ in range(flow_rounds):
                dcnt, pcnt = (_slot_counts(st, W, slot_dst) if use_slots
                              else edge_counts(st))
                eligible = (base & (take(dcnt, f_dst) < DOWNLOAD_SLOTS)
                            & (take(pcnt, f_pair) < PAIR_SLOTS))
                pick = _pick_per_bucket(f_dst, W, eligible, f_prio)
                base = base & ~pick
                st["f_started"] = st["f_started"] | pick
                if use_slots:
                    st = _acquire_slots(st, pick, f_dst, f_src, f_bytes, W,
                                        ids=e_ids_r)
            return st

        def start_tasks_edges(st):
            """Appendix-A start rounds over every task: enabled once each
            input edge is satisfied at the consumer's worker."""
            if E > 0:
                local = take(st["t_done"], prod_e) & ~cross & edge_valid
                moved = take(st["f_done"], rep_c) & cross
                cnt = scatter_count(T, e_task, local | moved)
            else:
                cnt = torch.zeros(R, T, dtype=torch.int64, device=dev)
            enabled = (cnt >= n_inputs) & ~st["t_started"]
            for _ in range(max_cores):
                free_at = take(st["free"], assignment)
                waiting = enabled & ~st["t_started"]
                blocked = waiting & (cpus > free_at)
                maxblk = _bucket_max(assignment, W,
                                     torch.where(blocked, priority, NEG))
                cand = (waiting & (cpus <= free_at)
                        & (priority >= take(maxblk, assignment)))
                pick = _pick_per_bucket(assignment, W, cand, priority)
                st["t_started"] = st["t_started"] | pick
                st["t_finish"] = torch.where(
                    pick, st["now"][:, None] + durations, st["t_finish"])
                st["free"] = st["free"] - torch.zeros(
                    R, W, dtype=torch.int64, device=dev).scatter_add_(
                        1, assignment, torch.where(pick, cpus, 0))
            return st

        def body_edges(st, live):
            """One event of the per-edge path (``frontier=False``)."""
            st = dict(st)
            if E > 0:
                st = start_flows_edges(st)
            st = start_tasks_edges(st)
            st, rem, done_now, _ = advance(st)
            if use_slots:
                se = st["slot_edge"]
                st["slot_rem"] = rem
                st["slot_edge"] = torch.where(done_now, -1, se)
                st["f_done"] = st["f_done"] | scatter_or(
                    E, se.clamp(min=0), done_now)
            elif E > 0:
                st["f_rem"] = rem
                st["f_done"] = st["f_done"] | done_now
            return st

        st = _drive(st, body if use_frontier else body_edges,
                    _live(steps_cap, use_frontier), check_every, graph, dev)
        if use_frontier and use_slots:
            transferred = st["transferred"]
        elif E > 0:
            transferred = torch.where(needed & st["f_done"], f_bytes,
                                      0.0).sum(dim=1)
        else:
            transferred = torch.zeros(R, device=dev)
        return _result(st, task_valid, transferred, unbatched)

    return run


def make_simulator(spec, n_workers: int, cores, netmodel: str = "maxmin",
                   flow_rounds: int = 4, max_steps: int | None = None,
                   **kwargs):
    """Deprecated per-graph binding of ``make_bucket_simulator`` — use
    ``repro_torch.core.vectorized.api.build(spec, ...)``.  Returns
    ``run(assignment, priority, durations, sizes, bandwidth) ->
    SimResult`` with ``spec`` bound; ``kwargs`` (``device`` among them)
    go to ``make_bucket_simulator``."""
    warnings.warn(
        "make_simulator is deprecated; use "
        "repro_torch.core.vectorized.api.build(spec, n_workers=..., "
        "cores=...)", DeprecationWarning, stacklevel=2)
    bspec = as_bucketed(spec)
    brun = make_bucket_simulator(n_workers, cores, netmodel, flow_rounds,
                                 max_steps, **kwargs)

    def run(assignment, priority, durations=None, sizes=None,
            bandwidth=100 * 1024 * 1024.0):
        return brun(bspec, assignment, priority, durations, sizes, bandwidth)

    return run


def simulate_batch(graph, assignments, priorities, n_workers, cores,
                   netmodel="maxmin", bandwidth=100 * 1024 * 1024.0, *,
                   device="cuda"):
    """The rows of ``(assignments [R, T], priorities [R, T])`` on one
    graph in one batched call.  Returns ``(makespans, transferred)`` as
    ``[R]`` tensors on ``device``; raises if any simulation failed."""
    bspec = as_bucketed(encode_graph(graph))
    brun = make_bucket_simulator(n_workers, cores, netmodel, device=device)
    res = brun(bspec, assignments, priorities, bandwidth=bandwidth)
    _check_ok(res.ok, f"simulate_batch({graph.name!r})", res.overflow)
    return res.makespan, res.transferred


def make_bucket_dynamic_simulator(n_workers: int, cores,
                                  scheduler: str = "blevel",
                                  netmodel: str = "maxmin",
                                  flow_rounds: int = 4,
                                  max_steps: int | None = None, *,
                                  max_cores: int | None = None,
                                  flow_slots=None, frontier=None,
                                  frontier_caps=None,
                                  waterfill_impl: str = "auto",
                                  device="cuda", check_every: int = 16,
                                  step_graph: str = "auto"):
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
    live".  ``flow_slots=False`` and ``frontier=False`` are the
    reference's per-edge escape hatches: one ``[R, E]`` flow per input
    edge, every edge and task scanned at every event.  The max-min
    frontier needs the slot pool, so ``flow_slots=False`` also turns the
    frontier off there (``frontier=True`` with it raises).

    ``step_graph`` (``_resolve_step_graph``): ``"auto"`` replays each
    call's event step from a CUDA graph on a card and runs it eagerly on
    the CPU; ``"graph"`` requires the graph, ``"eager"`` never uses one.
    The whole step is captured, ``greedy``'s invocation with it: its
    placement is one kernel (``kernels.greedy_place``) on the card, and
    its plain version on the CPU, which reads the host except in a step
    run as if from a graph."""
    if scheduler not in VEC_SCHEDULERS:
        raise KeyError(f"unknown vectorized scheduler {scheduler!r} "
                       f"(have {sorted(VEC_SCHEDULERS)})")
    _check_netmodel_options(netmodel, check_every)
    simple = netmodel == "simple"
    use_slots_cfg = flow_slots is not False and not simple
    use_frontier = _resolve_frontier(frontier, simple=simple,
                                     use_slots=use_slots_cfg, dynamic=True)
    dev = resolve_device(device)
    graph = _resolve_step_graph(step_graph, dev)
    W = n_workers
    cores_default = _resolve_cores(n_workers, cores)
    max_cores = _max_cores(cores_default, max_cores)
    wf = None if simple else _make_waterfill(waterfill_impl, dev, graph)
    S = W * DOWNLOAD_SLOTS
    dynamic_sched = VEC_SCHEDULERS[scheduler] == "dynamic"
    from ...kernels import list_schedule as schedule_kernel
    if dynamic_sched:
        from ...kernels import greedy_place as placement
        static_schedule = None
    else:
        static_schedule = make_bucket_scheduler(W, cores_default, scheduler,
                                                max_cores)

    @prepared
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
        spec = spec_rows(bspec, R, dev)
        g = graph_view(spec)
        T, O, E = g.T, g.O, g.E
        F = O * W
        steps_cap = (max_steps if max_steps is not None
                     else 10 * (T + E) + 8 * W + 1024)
        cores_t = _cores_arg(cores, cores_default, R, dev)
        use_slots = use_slots_cfg and E > 0
        # flow identity in the slot pool and per-key bools: no per-edge
        # flow carry at all
        carried_keys = use_frontier and use_slots
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
        granule = _granule(dev)

        # the schedule's launches, counted into this call's drive record
        schedules = schedule_kernel.LAUNCHES.count
        if dynamic_sched:
            with span("schedule", dev):
                greedy_prio = schedule_kernel.blevel_priorities(
                    e_task, prod_e, edge_valid, est_dur)
            p_worker0 = torch.full((R, T), -1, dtype=torch.int64, device=dev)
            p_prio0 = torch.zeros(R, T, device=dev)
            p_time0 = torch.full((R, T), INF, device=dev)
            # the placement's fixed inputs, contiguous once a call, and
            # its device counter of placer iterations (and scratch)
            place_in = (edge_table(g).contiguous(), e_obj.contiguous(),
                        g.cpus.contiguous(), cores_t.contiguous())
            tally = torch.zeros(3, dtype=torch.int64, device=dev)
            place_span = contextlib.nullcontext() if graph else PLACE
        else:
            # static schedule == the single invocation at t=0, computed
            # from pure estimates; it reaches workers after the delay
            with span("schedule", dev):
                aw0, prio0 = static_schedule(g, est_dur, est_size,
                                             bandwidth_, seed_, cores_t)
            p_worker0 = torch.where(task_valid, aw0, -1)
            p_prio0 = prio0
            p_time0 = torch.where(task_valid, delay[:, None], INF)
        schedules = schedule_kernel.LAUNCHES.count - schedules

        CF, CT = _frontier_caps(frontier_caps, T, O, E)
        # the flow path's counters (``_count_flows``): occupied slots
        # summed over the steps, the fullest candidate-flow frontier
        flow_tally = torch.zeros(2, dtype=torch.int64, device=dev)

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
        )
        if use_frontier:
            st.update(enq_t=zb(R, T), in_cnt=zl(R, T),
                      fr_task=torch.full((R, CT), -1, dtype=torch.int64,
                                         device=dev))
            if E > 0:
                st.update(key_q=zb(R, F), key_done=zb(R, F))
        if use_slots:
            st.update(
                slot_edge=torch.full((R, S), -1, dtype=torch.int64,
                                     device=dev),
                slot_src=torch.zeros(R, S, dtype=torch.int32, device=dev),
                slot_rem=zf(R, S),
            )
        if carried_keys:
            st.update(fr_flow=torch.full((R, CF), -1, dtype=torch.int64,
                                         device=dev),
                      transferred=zf(R))
        else:
            # flows are the input edges
            st.update(f_started=zb(R, E), f_done=zb(R, E))
            if not use_slots:
                st["f_rem"] = e_bytes.clone()

        def edge_views(st):
            """Per input edge: the consumer's and the producer's worker
            and the (object, destination) dedup key (meaningful for
            assigned consumers of valid edges only)."""
            aw_e = take(st["aw"], e_task)
            src_e = take(st["aw"], prod_e)
            return aw_e, src_e, e_obj * W + aw_e.clamp(min=0)

        def inputs_produced(st):
            if use_frontier:
                return st["in_cnt"] >= n_inputs
            return scatter_count(T, e_task, take(st["t_done"], prod_e)
                                 & edge_valid) >= n_inputs

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
            ready_t = inputs_produced(st)
            ready_un = (ready_t & (st["aw"] < 0) & (st["pw"] < 0)
                        & ~st["t_done"])
            # only rows that invoke now (and are live) place anything
            placing = ready_un & (due & live)[:, None]
            prod = take(st["t_done"], producer)                  # [R, O]
            size_now = torch.where(prod, sizes_true, est_size)
            if E == 0:
                missing = zb(R, O, W)
            else:
                prod_w = take(st["aw"], producer)
                if carried_keys:
                    # per-key views straight from the carried key bools
                    # and the slot pool
                    done_ow = st["key_done"]
                    sk = take(e_obj, st["slot_edge"].clamp(min=0)) * W \
                        + slot_dst
                    dl_ow = scatter_or(F, sk, st["slot_edge"] >= 0)
                else:
                    key_e = edge_views(st)[2]
                    done_ow = scatter_or(F, key_e, st["f_done"])
                    dl_ow = scatter_or(F, key_e,
                                       st["f_started"] & ~st["f_done"])
                local_ow = (prod_w[:, :, None] == w_ids) & prod[:, :, None]
                missing = ~(local_ow | done_ow.view(R, O, W)
                            | dl_ow.view(R, O, W))
            queued = (((st["aw"] >= 0) | (st["pw"] >= 0))
                      & ~st["t_started"] & ~st["t_done"])
            qworker = torch.where(st["aw"] >= 0, st["aw"], st["pw"])
            load0 = scatter_count(W, qworker.clamp(min=0), queued)
            table, e_obj_c, cpus_c, cores_c = place_in
            # timed on eager steps only: no span sits inside a capture
            with place_span:
                new_pw = placement.greedy_place(
                    placing, table, e_obj_c, size_now, missing, cpus_c,
                    cores_c, load0, tally)
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
            """Max-min flow picks over the pinned candidate list."""
            cid = st["fr_flow"].clamp(min=0)
            c_dst = take(st["aw"], take(e_task, cid)).clamp(min=0)
            c_src = take(st["aw"], take(prod_e, cid)).clamp(min=0)
            return _flow_rounds(st, c_dst, c_src,
                                take(keymax, take(e_obj, cid) * W + c_dst),
                                take(e_bytes, cid), W, flow_rounds, slot_dst)

        def start_tasks_frontier(st):
            tid = st["fr_task"].clamp(min=0)
            return _task_rounds(st, take(st["aw"], tid).clamp(min=0),
                                take(cpus, tid), take(st["ap"], tid),
                                take(durations_true, tid), W, max_cores)

        def start_flows_edges(st):
            """Flow starts of the per-edge scan: the smallest wanted edge
            of an (object, destination) key claims it when it starts."""
            aw_e, src_e, key_e = edge_views(st)
            prod_done = take(st["t_done"], prod_e)
            cross = ((aw_e >= 0) & (src_e >= 0) & (src_e != aw_e)
                     & edge_valid)
            raw = take(st["ap"], e_task) + READY_BOOST * take(
                inputs_produced(st), e_task).float()
            raw = torch.where((aw_e >= 0) & edge_valid, raw, NEG)
            f_prio = take(scatter_max(F, key_e, raw, NEG), key_e)
            handled = take(scatter_or(F, key_e, st["f_started"]), key_e)
            if simple:
                eligible = cross & prod_done & ~handled
                rep = scatter_min(F, key_e, torch.where(eligible, e_ids, E), E)
                st["f_started"] = st["f_started"] | (
                    eligible & (take(rep, key_e) == e_ids))
                return st
            bucket = aw_e.clamp(min=0)
            src_c = src_e.clamp(min=0)
            pair = src_c * W + bucket
            base = cross & prod_done & ~handled
            for _ in range(flow_rounds):
                if use_slots:
                    dcnt, pcnt = _slot_counts(st, W, slot_dst)
                else:
                    act = st["f_started"] & ~st["f_done"]
                    dcnt = scatter_count(W, bucket, act)
                    pcnt = scatter_count(W * W, pair, act)
                eligible = (base & (take(dcnt, bucket) < DOWNLOAD_SLOTS)
                            & (take(pcnt, pair) < PAIR_SLOTS))
                # same key => same bucket, so one pick also dedups; all
                # same-key edges leave the base once one of them starts
                pick = _pick_per_bucket(bucket, W, eligible, f_prio)
                base = base & ~take(scatter_or(F, key_e, pick), key_e)
                st["f_started"] = st["f_started"] | pick
                if use_slots:
                    st = _acquire_slots(st, pick, bucket, src_c, e_bytes, W,
                                        ids=e_ids.expand(R, E))
            return st

        def start_tasks_edges(st):
            """Appendix-A start rounds over every task: enabled once each
            input edge is satisfied at the consumer's worker."""
            if E == 0:
                enabled = ~st["t_started"] & (st["aw"] >= 0)
            else:
                aw_e, src_e, key_e = edge_views(st)
                local = take(st["t_done"], prod_e) & (src_e == aw_e)
                moved = take(scatter_or(F, key_e, st["f_done"]), key_e)
                sat = (aw_e >= 0) & (local | moved) & edge_valid
                enabled = ((scatter_count(T, e_task, sat) >= n_inputs)
                           & ~st["t_started"] & (st["aw"] >= 0))
            bucket = st["aw"].clamp(min=0)
            for _ in range(max_cores):
                free_at = take(st["free"], bucket)
                waiting = enabled & ~st["t_started"]
                blocked = waiting & (cpus > free_at)
                maxblk = _bucket_max(bucket, W,
                                     torch.where(blocked, st["ap"], NEG))
                cand = (waiting & (cpus <= free_at)
                        & (st["ap"] >= take(maxblk, bucket)))
                pick = _pick_per_bucket(bucket, W, cand, st["ap"])
                st["t_started"] = st["t_started"] | pick
                st["t_finish"] = torch.where(
                    pick, st["now"][:, None] + durations_true,
                    st["t_finish"])
                st["free"] = st["free"] - torch.zeros(
                    R, W, dtype=torch.int64, device=dev).scatter_add_(
                        1, bucket, torch.where(pick, cpus, 0))
            return st

        def rates_of(st):
            """``(active, rem, rates)`` of this event's flows."""
            if use_slots:
                active = st["slot_edge"] >= 0
                return active, st["slot_rem"], wf(st["slot_src"], slot_dst_k,
                                                  active, caps)
            active = st["f_started"] & ~st["f_done"]
            if simple or E == 0:
                return active, st["f_rem"], waterfill_simple(active,
                                                              bandwidth_)
            aw_e, src_e, _ = edge_views(st)
            return active, st["f_rem"], wf(src_e.clamp(min=0).int(),
                                           aw_e.clamp(min=0).int(), active,
                                           caps)

        def advance(st):
            """The time advance and the completions of this event."""
            active, rem, rates = rates_of(st)
            # pending applies: the times are inf when unset and padded
            # tasks never get a pending slot, so the unmasked min is exact
            next_extra = st["pt"].amin(dim=1)  # simlint: disable=PY205
            if dynamic_sched:
                now = st["now"]
                next_extra = torch.minimum(next_extra, torch.where(
                    st["events"], torch.maximum(now, st["last"] + msd_),
                    INF))
            _, now, rem, done_now, t_newly = _advance(st, rates, active, rem,
                                                      granule, next_extra)
            # finished tasks all have aw >= 0
            st["free"] = st["free"] + torch.zeros(
                R, W, dtype=torch.int64, device=dev).scatter_add_(
                    1, st["aw"].clamp(min=0), torch.where(t_newly, cpus, 0))
            if use_frontier and E > 0:
                st["in_cnt"] = st["in_cnt"] + scatter_count(
                    T, e_task, take(t_newly, prod_e) & edge_valid)
            st["now"] = now
            st["t_done"] = st["t_done"] | t_newly
            st["events"] = st["events"] | t_newly.any(dim=1)
            st["steps"] = st["steps"] + 1
            st["n_events"] = (st["n_events"] + t_newly.sum(dim=1)
                              + done_now.sum(dim=1))
            return st, rem, done_now

        # -------------------------------------------------------- body
        def invoke_due(st, live):
            """Greedy's part of the step: pending assignments that fall
            due, the scheduler invocation, and what it made due at once
            (``decision_delay == 0``)."""
            st = apply_due(dict(st))
            st = invoke(st, live)
            return apply_due(st)

        def body(st, live):
            """The frontier step."""
            st = (invoke_due(st, live) if dynamic_sched
                  else apply_due(dict(st)))
            # fused O(E) detection pass: new (producer-done,
            # consumer-assigned) pairs become flow candidates (dedup rep
            # pinned per key) and satisfied edges
            ready_t = st["in_cnt"] >= n_inputs
            keymax = None
            key_e = None
            if E > 0:
                aw_e, src_e, key_e = edge_views(st)
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
                _count_flows(flow_tally, live, st["slot_edge"] >= 0, fr_flow)
            st = start_tasks_frontier(st)
            st, rem, done_now = advance(st)
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

        def body_edges(st, live):
            """The per-edge step (``frontier=False``)."""
            st = (invoke_due(st, live) if dynamic_sched
                  else apply_due(dict(st)))
            if E > 0:
                st = start_flows_edges(st)
            if use_slots:
                _count_flows(flow_tally, live, st["slot_edge"] >= 0)
            st = start_tasks_edges(st)
            st, rem, done_now = advance(st)
            if use_slots:
                se = st["slot_edge"]
                st["slot_rem"] = rem
                st["slot_edge"] = torch.where(done_now, -1, se)
                st["f_done"] = st["f_done"] | scatter_or(
                    E, se.clamp(min=0), done_now)
            else:
                st["f_rem"] = rem
                st["f_done"] = st["f_done"] | done_now
            return st

        tallies = dict(slot_busy=flow_tally[0], frontier_peak=flow_tally[1],
                       flow_cap=CF if carried_keys else 0,
                       edge_lanes=R * E, valid_edges=edge_valid.sum(),
                       schedule_launches=schedules)
        if dynamic_sched:
            tallies["place_iters"] = tally[0]
        st = _drive(st, body if use_frontier else body_edges,
                    _live(steps_cap, use_frontier), check_every, graph, dev,
                    tallies)
        if carried_keys:
            transferred = st["transferred"]
        else:
            transferred = torch.where(st["f_done"], e_bytes, 0.0).sum(dim=1)
        return _result(st, task_valid, transferred, unbatched)

    return run


def make_dynamic_simulator(spec, n_workers: int, cores,
                           scheduler: str = "blevel",
                           netmodel: str = "maxmin", flow_rounds: int = 4,
                           max_steps: int | None = None, **kwargs):
    """Deprecated per-graph binding of ``make_bucket_dynamic_simulator``
    — use ``repro_torch.core.vectorized.api.build(spec, scheduler=...,
    dynamic=True)``.  Returns ``run(est_durations, est_sizes, msd,
    decision_delay, bandwidth, seed) -> SimResult`` with ``spec`` bound;
    ``kwargs`` (``device`` among them) go to the bucket form."""
    warnings.warn(
        "make_dynamic_simulator is deprecated; use "
        "repro_torch.core.vectorized.api.build(spec, scheduler=..., "
        "dynamic=True)", DeprecationWarning, stacklevel=2)
    cores_v = _resolve_cores(n_workers, cores)
    _check_cpus_fit([spec], cores_v, "make_dynamic_simulator")
    bspec = as_bucketed(spec)
    brun = make_bucket_dynamic_simulator(n_workers, cores_v, scheduler,
                                         netmodel, flow_rounds, max_steps,
                                         **kwargs)

    def run(est_durations, est_sizes, msd=0.0, decision_delay=0.0,
            bandwidth=100 * 1024 * 1024.0, seed=0):
        return brun(bspec, est_durations, est_sizes, msd, decision_delay,
                    bandwidth, seed)

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
    ``ShardedGridRunner`` (``engine.py``) streams the same rows in
    chunks.
    """

    def __init__(self, entries, scheduler, n_workers, cores,
                 netmodel="maxmin", max_steps=None, shape=None,
                 batch=None, est_cache=None, *, device="cuda",
                 waterfill_impl="auto", flow_rounds=4, flow_slots=None,
                 frontier=None, frontier_caps=None, check_every=16,
                 step_graph="auto"):
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
            flow_slots=flow_slots, frontier=frontier,
            frontier_caps=frontier_caps, waterfill_impl=waterfill_impl,
            device=self.device, check_every=check_every,
            step_graph=step_graph)
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

    def _row_index(self, points):
        """``(b_of, host_args)`` of one grid call: the graph of
        each of the ``R = K * B * N`` rows, and the other row arguments
        ``(est_durations, est_sizes, msd, decision_delay, bandwidth,
        seed, cores)`` as host arrays."""
        points, M, DD, BW, SD = _points_arrays(points)
        K, B, N = self.K, self.B, len(points)
        D = np.stack([self._estimates(p.get("imode", "exact"))[0]
                      for p in points], axis=1)          # [B, N, T]
        Sz = np.stack([self._estimates(p.get("imode", "exact"))[1]
                       for p in points], axis=1)         # [B, N, O]
        b_of = np.repeat(np.arange(B), N * K)
        n_of = np.tile(np.repeat(np.arange(N), K), B)
        k_of = np.tile(np.arange(K), B * N)
        return b_of, (D[b_of, n_of], Sz[b_of, n_of], M[n_of],
                              DD[n_of], BW[n_of], SD[n_of].astype(np.int64),
                              self.clusters[k_of].astype(np.int64))

    def row_inputs(self, points):
        """The flattened ``R = K * B * N`` row arguments of one grid call:
        ``(spec, est_durations, est_sizes, msd, decision_delay,
        bandwidth, seed, cores)`` as tensors on the runner's device."""
        with span("rows_in"):
            b_of, args = self._row_index(points)
            dev = self.device
            b_idx = torch.as_tensor(b_of, device=dev)
            spec = self._bspec_dev.map(lambda x: x.index_select(0, b_idx))
            return (spec, *(torch.as_tensor(np.ascontiguousarray(a),
                                            device=dev) for a in args))

    def _execute(self, points):
        """One simulator call over all rows: a ``SimResult`` of ``[R]``
        tensors on the device.  ``ShardedGridRunner`` streams the rows
        in chunks instead, and returns the same."""
        return self.run(*self.row_inputs(points))

    def __call__(self, points):
        """Run the grid; returns ``SimResult`` of numpy ``[K, B, N]``
        arrays with the graph axis in ``self.names`` order.  The call is
        one ``grid_call`` span tree (``_spans``)."""
        points = list(points)
        K, B, N = self.K, self.B, len(points)
        with span("grid_call"):
            res = self._execute(points)
            with span("results_out"):
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
