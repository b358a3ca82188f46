"""The reference simulator: estee's dynamic event loop, batched over
rows in plain PyTorch, run eagerly.

A frozen copy of the semantics the program implements (the ready
frontiers, the flow-slot pool of the max-min model, the MSD-gated
scheduler invocations with their decision delay, imode estimates that
turn true once a task finished), written without CUDA graphs, kernels
or host-side shortcuts: every step issues every operation, max-min
rates come from progressive filling in plain PyTorch.  Rows never
interact, so any subset of a grid's rows gives the same answers as the
whole grid.

``simulate(..., fdt=torch.float32)`` is the reference.  ``fdt`` is the
precision of the graph's durations and sizes, their estimates, the
bandwidths, the max-min rates and the bytes left and moved; the control
of the benchmark's check runs it in ``torch.bfloat16``.  Times (the
clock, finish times, b-levels, the scheduler's timelines), ids and
ranks stay float32 either way.
"""
from __future__ import annotations

import torch

READY_BOOST = 1_000_000.0
TIME_EPS = 1e-6
BYTES_EPS = 1e-3
NEG_TIME = -1e30
NEG = -3e38
INF = float("inf")
DOWNLOAD_SLOTS = 4
PAIR_SLOTS = 2
FLOW_ROUNDS = 4
BIG = 2 ** 31 - 1
F32 = torch.float32


# ------------------------------------------------------------------ ops
def take(x, idx):
    return torch.gather(x, 1, idx)


def scatter_or(n, idx, mask):
    R = idx.shape[0]
    out = torch.zeros(R, n + 1, dtype=torch.bool, device=idx.device)
    out.scatter_(1, torch.where(mask, idx, n), True)
    return out[:, :n]


def scatter_max(n, idx, values, init):
    R = idx.shape[0]
    out = torch.full((R, n), init, dtype=values.dtype, device=idx.device)
    return out.scatter_reduce_(1, idx, values, "amax", include_self=True)


def scatter_min(n, idx, values, init):
    R = idx.shape[0]
    out = torch.full((R, n), init, dtype=values.dtype, device=idx.device)
    return out.scatter_reduce_(1, idx, values, "amin", include_self=True)


def scatter_count(n, idx, mask):
    R = idx.shape[0]
    out = torch.zeros(R, n, dtype=torch.int64, device=idx.device)
    return out.scatter_add_(1, idx, mask.long())


def fma(a, b, c):
    """``a * b + c`` rounded once to ``c``'s dtype: the fused
    multiply-add of the simulator's time advance, granule and capacity
    update.  In float32 the product is exact in float64 and a sum that
    lands on a rounding midpoint is settled by its exact TwoSum error."""
    dt = c.dtype
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    if dt != F32:
        return s.to(dt)
    bv = s - p
    err = (p - (s - bv)) + (cd - bv)
    r = s.float()
    d = s - r.double()
    other = torch.nextafter(r, torch.where(d > 0, INF, -INF).float())
    mid = (d != 0) & ((r.double() + other.double()) * 0.5 == s)
    fix = mid & (err != 0) & ((err > 0) == (d > 0))
    return torch.where(fix, other, r)


# ------------------------------------------------------------ max-min
def maxmin_rates(src, dst, active, caps):
    """Max-min fair rates by progressive filling.  Flow f uses the
    upload of worker ``src[f]`` and the download of worker ``dst[f]``,
    each of capacity ``caps`` (``[R, W]``).  Every round freezes the
    live flows of the resources with the smallest share at that share;
    at most 2W rounds."""
    R, F = src.shape
    W = caps.shape[1]
    dt = caps.dtype
    res_u, res_d = src.long(), dst.long() + W
    cap = torch.cat([caps, caps], dim=1)
    rates = torch.zeros(R, F, dtype=dt, device=src.device)
    frozen = ~active
    row_live = active.any(dim=1)
    for _ in range(2 * W):
        if not bool(row_live.any()):
            break
        live = active & ~frozen
        livef = live.to(dt)
        counts = torch.zeros(R, 2 * W, dtype=dt, device=src.device)
        counts.scatter_add_(1, res_u, livef).scatter_add_(1, res_d, livef)
        share = torch.where(counts > 0, cap / counts.clamp(min=1.0), INF)
        min_share = share.amin(dim=1, keepdim=True)
        is_bn = (share <= min_share) & (counts > 0)
        freeze = live & (is_bn.gather(1, res_u) | is_bn.gather(1, res_d))
        freezef = freeze.to(dt)
        used = torch.zeros(R, 2 * W, dtype=dt, device=src.device)
        used.scatter_add_(1, res_u, freezef).scatter_add_(1, res_d, freezef)
        rl = row_live.unsqueeze(1)
        rates = torch.where(freeze & rl, min_share, rates)
        cap = torch.where(rl, fma(-min_share, used, cap).clamp(min=0.0), cap)
        frozen = frozen | (freeze & rl)
        row_live = (active & ~frozen).any(dim=1)
    return rates


# ---------------------------------------------------------- schedulers
def blevel(g, est_dur):
    """b-level from estimated durations; task ids are topological."""
    bl = torch.zeros(est_dur.shape, dtype=F32, device=est_dur.device)
    if g["E"] == 0:
        return bl + est_dur
    for t in range(g["T"] - 1, -1, -1):
        mask = (g["prod_e"] == t) & g["edge_valid"]
        child = torch.where(mask, take(bl, g["e_task"]), 0.0).amax(dim=1)
        bl[:, t] = est_dur[:, t] + child
    return bl


def rank_priorities(bl):
    """Priority T - rank in decreasing b-level (ties: smaller id)."""
    R, T = bl.shape
    order = torch.sort(-bl, dim=1, stable=True).indices
    ranks = (T - torch.arange(T, device=bl.device)).to(F32)
    return torch.zeros(R, T, dtype=F32, device=bl.device).scatter_(
        1, order, ranks.expand(R, T).contiguous())


def blevel_schedule(g, est_dur, est_size, bandwidth, cores, W, C):
    """HLFET: tasks in decreasing b-level, each to the worker where it
    could start first over per-core free times, with uncontended
    transfer costs.  Returns ``(worker i64[R, T], priority f32[R, T])``."""
    R, T, dev = g["R"], g["T"], est_dur.device
    dt = F32
    order = torch.sort(-blevel(g, est_dur), dim=1, stable=True).indices
    ar = torch.arange(C, device=dev)
    slots = torch.where(ar[None, None, :] < cores[:, :, None], 0.0,
                        INF).to(dt)
    xfer = take(est_size, g["e_obj"]) / bandwidth[:, None]
    w_ids = torch.arange(W, device=dev)
    rows = torch.arange(R, device=dev)
    aw = torch.zeros(R, T, dtype=torch.int64, device=dev)
    fin = torch.zeros(R, T, dtype=dt, device=dev)
    prio = torch.zeros(R, T, dtype=F32, device=dev)
    for r in range(T):
        t = order[:, r]
        ct = g["cpus"][rows, t]
        if g["E"]:
            pw = take(aw, g["prod_e"])
            pf = take(fin, g["prod_e"])
            ready_ew = pf[:, :, None] + torch.where(
                pw[:, :, None] == w_ids, 0.0, xfer[:, :, None])
            mine = (g["e_task"] == t[:, None]) & g["edge_valid"]
            data_ready = torch.where(mine[:, :, None], ready_ew,
                                     0.0).amax(dim=1)
        else:
            data_ready = torch.zeros(R, W, dtype=dt, device=dev)
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


def edge_table(g):
    """``i64[R, T, D]``: each task's valid input edges in edge order."""
    R, T, E, dev = g["R"], g["T"], g["E"], g["e_task"].device
    key = torch.where(g["edge_valid"], g["e_task"], T)
    sk, order = torch.sort(key, dim=1, stable=True)
    first = torch.searchsorted(sk, sk, right=False)
    pos = torch.arange(E, device=dev)[None, :] - first
    D = int(torch.where(sk < T, pos + 1, 0).amax())
    table = torch.full((R, T + 1, max(D, 1)), -1, dtype=torch.int64,
                       device=dev)
    rows = torch.arange(R, device=dev)[:, None].expand(R, E)
    table[rows, sk, pos.clamp(max=max(D, 1) - 1)] = order
    return table[:, :T, :D]


def transfer_costs(g, size_now, missing_ow, table):
    """``[R, T, W]`` bytes task t would have to fetch on worker w, each
    task's edges added in edge order."""
    R, T, E = g["R"], g["T"], g["E"]
    W = missing_ow.shape[-1]
    out = torch.zeros(R, T, W, dtype=size_now.dtype, device=size_now.device)
    miss_e = missing_ow.gather(1, g["e_obj"][:, :, None].expand(R, E, W))
    contrib = torch.where(g["edge_valid"][:, :, None],
                          take(size_now, g["e_obj"])[:, :, None] * miss_e, 0.0)
    for k in range(table.shape[2]):
        ids = table[:, :, k]
        v = contrib.gather(1, ids.clamp(min=0)[:, :, None].expand(R, T, W))
        out = out + torch.where((ids >= 0)[:, :, None], v, 0.0)
    return out


def greedy_place(g, ready_un, cost_tw, load0, cores):
    """Ready tasks in id order, each to the worker with the least
    (transfer cost, queued load, id); a placement bumps the load."""
    R, T, dev = g["R"], g["T"], ready_un.device
    pw = torch.full((R, T + 1), -1, dtype=torch.int64, device=dev)
    n = int(ready_un.sum(dim=1).amax()) if R else 0
    if n == 0:
        return pw[:, :T]
    t_ids = torch.arange(T, device=dev)
    order = torch.sort(torch.where(ready_un, t_ids, T), dim=1).values[:, :n]
    load = load0.clone().long()
    rows = torch.arange(R, device=dev)
    for k in range(n):
        t = order[:, k]
        act = t < T
        tc = t.clamp(max=T - 1)
        elig = cores >= g["cpus"][rows, tc][:, None]
        c = torch.where(elig, cost_tw[rows, tc], INF)
        cand = c == c.amin(dim=1, keepdim=True)
        ld = torch.where(cand, load, BIG)
        cand = cand & (ld == ld.amin(dim=1, keepdim=True))
        w = cand.int().argmax(dim=1)
        pw[rows, t] = torch.where(act, w, -1)
        load[rows, w] += act.long()
    return pw[:, :T]


# ----------------------------------------------------------- helpers
def _pick_per_bucket(bucket, n, eligible, *keys):
    """At most one True per (row, bucket): the lexicographic max of
    ``keys``, the final tie to the smallest index."""
    cand = eligible
    for k in keys:
        kk = torch.where(cand, k, NEG)
        mb = take(scatter_max(n, bucket, kk, NEG), bucket)
        cand = cand & (kk == mb) & (mb > NEG)
    idx = torch.arange(bucket.shape[1], device=bucket.device, dtype=F32)
    ii = torch.where(cand, -idx, NEG)
    mb = take(scatter_max(n, bucket, ii, NEG), bucket)
    return cand & (ii == mb)


def _append(fr, new_mask, ids):
    """Append ``ids[new_mask]`` into the free (-1) slots of ``fr``."""
    R, C = fr.shape
    N = new_mask.shape[1]
    if C == 0 or N == 0:
        return fr, new_mask.any(dim=1)
    free = fr < 0
    free_rank = torch.cumsum(free.long(), dim=1)
    cs = torch.cumsum(new_mask.long(), dim=1)
    total = cs[:, -1:]
    src = torch.searchsorted(cs, free_rank, right=False)
    take_it = free & (free_rank <= total)
    fr = torch.where(take_it, take(ids.expand(R, N), src.clamp(0, N - 1)),
                     fr)
    return fr, total[:, 0] > free_rank[:, -1]


def graph_rows(spec, device):
    """Row-batched graph arrays (``{field: [R, ...]}`` numpy) as tensors,
    index fields widened to int64."""
    t = {k: torch.as_tensor(v, device=device) for k, v in spec.items()}
    g = dict(e_task=t["edge_task"].long(), e_obj=t["edge_obj"].long(),
             producer=t["producer"].long(), cpus=t["cpus"].long(),
             n_inputs=t["n_inputs"].long(), durations=t["durations"],
             sizes=t["sizes"], task_valid=t["task_valid"].bool(),
             obj_valid=t["obj_valid"].bool(),
             edge_valid=t["edge_valid"].bool())
    g["prod_e"] = take(g["producer"], g["e_obj"])
    g["R"], g["T"] = g["cpus"].shape
    g["O"], g["E"] = g["sizes"].shape[1], g["e_task"].shape[1]
    return g


# ---------------------------------------------------------- simulator
def simulate(spec, est_dur, est_size, msd, delay, bandwidth, cores, *,
             scheduler, netmodel, max_cores, device, fdt=F32,
             check_every=16):
    """Run every row to its end.  ``spec``: padded graph arrays with a
    row axis; ``est_dur``/``est_size``: ``[R, T]``/``[R, O]``;
    ``msd``, ``delay``, ``bandwidth``: ``[R]``; ``cores``: ``[R, W]``.
    Returns numpy ``makespan``, ``transferred``, ``ok``, ``n_events``,
    ``n_steps`` per row."""
    g = graph_rows(spec, device)
    R, T, O, E = g["R"], g["T"], g["O"], g["E"]
    dev = torch.device(device)
    cores_t = torch.as_tensor(cores, device=dev).long()
    W = cores_t.shape[1]
    S = W * DOWNLOAD_SLOTS
    F = O * W
    simple = netmodel == "simple"
    use_slots = not simple and E > 0

    def f(x):
        return torch.as_tensor(x, device=dev).to(F32).to(fdt)

    dur_true = g["durations"].to(fdt)
    sizes_true = g["sizes"].to(fdt)
    task_valid, edge_valid = g["task_valid"], g["edge_valid"]
    e_task, e_obj, prod_e = g["e_task"], g["e_obj"], g["prod_e"]
    cpus, n_inputs = g["cpus"], g["n_inputs"]
    est_d = torch.where(task_valid, f(est_dur), 0.0)
    est_s = torch.where(g["obj_valid"], f(est_size), 0.0)
    msd_, delay_ = (torch.as_tensor(x, device=dev).to(F32)
                    for x in (msd, delay))
    bw = f(bandwidth)
    steps_cap = 10 * (T + E) + 8 * W + 1024
    e_ids = torch.arange(E, device=dev)
    t_ids = torch.arange(T, device=dev)
    w_ids = torch.arange(W, device=dev)
    e_bytes = torch.where(edge_valid, take(sizes_true, e_obj), 0.0)
    slot_dst = torch.arange(S, device=dev) // DOWNLOAD_SLOTS
    slot_dst_k = slot_dst.expand(R, S)
    caps = bw[:, None].expand(R, W).contiguous()
    g6, g1 = (torch.tensor(x, dtype=F32, device=dev)
              for x in (6e-7, TIME_EPS))
    dynamic = scheduler == "greedy"
    if dynamic:
        greedy_prio = rank_priorities(blevel(g, est_d))
        pw0 = torch.full((R, T), -1, dtype=torch.int64, device=dev)
        pp0 = torch.zeros(R, T, dtype=F32, device=dev)
        pt0 = torch.full((R, T), INF, dtype=F32, device=dev)
        table = edge_table(g) if E else None
    elif scheduler == "blevel":
        aw0, pp0 = blevel_schedule(g, est_d, est_s, bw, cores_t, W,
                                   max(int(max_cores), 1))
        pw0 = torch.where(task_valid, aw0, -1)
        pt0 = torch.where(task_valid, delay_[:, None], INF)
    else:
        raise KeyError(f"the reference has no scheduler {scheduler!r}")

    def zl(*shape):
        return torch.zeros(*shape, dtype=torch.int64, device=dev)

    st = dict(
        now=torch.zeros(R, dtype=F32, device=dev),
        last=torch.full((R,), NEG_TIME, dtype=F32, device=dev),
        events=torch.ones(R, dtype=torch.bool, device=dev),
        aw=torch.full((R, T), -1, dtype=torch.int64, device=dev),
        ap=torch.zeros(R, T, dtype=F32, device=dev),
        pw=pw0, pp=pp0, pt=pt0,
        t_started=~task_valid, t_done=~task_valid,
        t_finish=torch.full((R, T), INF, dtype=F32, device=dev),
        free=cores_t.clone(), steps=zl(R), n_events=zl(R),
        overflow=torch.zeros(R, dtype=torch.bool, device=dev),
        enq_t=torch.zeros(R, T, dtype=torch.bool, device=dev),
        in_cnt=zl(R, T),
        fr_task=torch.full((R, T), -1, dtype=torch.int64, device=dev))
    if E > 0:
        st.update(key_q=torch.zeros(R, F, dtype=torch.bool, device=dev),
                  key_done=torch.zeros(R, F, dtype=torch.bool, device=dev))
    if use_slots:
        st.update(slot_edge=torch.full((R, S), -1, dtype=torch.int64,
                                       device=dev),
                  slot_src=torch.zeros(R, S, dtype=torch.int64, device=dev),
                  slot_rem=torch.zeros(R, S, dtype=fdt, device=dev),
                  fr_flow=torch.full((R, E), -1, dtype=torch.int64,
                                     device=dev),
                  transferred=torch.zeros(R, dtype=fdt, device=dev))
    else:
        st.update(f_started=torch.zeros(R, E, dtype=torch.bool, device=dev),
                  f_done=torch.zeros(R, E, dtype=torch.bool, device=dev),
                  f_rem=e_bytes.clone())

    def apply_due(st):
        due = (st["pw"] >= 0) & (st["pt"] <= st["now"][:, None] + TIME_EPS)
        st["aw"] = torch.where(due, st["pw"], st["aw"])
        st["ap"] = torch.where(due, st["pp"], st["ap"])
        st["pw"] = torch.where(due, -1, st["pw"])
        st["pt"] = torch.where(due, INF, st["pt"])
        return st

    def invoke(st, live):
        """greedy: place the ready unassigned tasks of the rows whose
        minimal scheduling delay has passed since the last invocation."""
        due = st["events"] & (st["last"] + msd_ <= st["now"] + TIME_EPS)
        ready_un = ((st["in_cnt"] >= n_inputs) & (st["aw"] < 0)
                    & (st["pw"] < 0) & ~st["t_done"])
        placing = ready_un & (due & live)[:, None]
        if bool(placing.any()):
            if E == 0:
                cost_tw = torch.zeros(R, T, W, dtype=fdt, device=dev)
            else:
                prod = take(st["t_done"], g["producer"])
                prod_w = take(st["aw"], g["producer"])
                if use_slots:
                    done_ow = st["key_done"]
                    sk = take(e_obj, st["slot_edge"].clamp(min=0)) * W \
                        + slot_dst
                    dl_ow = scatter_or(F, sk, st["slot_edge"] >= 0)
                else:
                    key_e = e_obj * W + take(st["aw"], e_task).clamp(min=0)
                    done_ow = scatter_or(F, key_e, st["f_done"])
                    dl_ow = scatter_or(F, key_e,
                                       st["f_started"] & ~st["f_done"])
                local_ow = (prod_w[:, :, None] == w_ids) & prod[:, :, None]
                missing = ~(local_ow | done_ow.view(R, O, W)
                            | dl_ow.view(R, O, W))
                size_now = torch.where(prod, sizes_true, est_s)
                cost_tw = transfer_costs(g, size_now, missing, table)
            queued = (((st["aw"] >= 0) | (st["pw"] >= 0))
                      & ~st["t_started"] & ~st["t_done"])
            qworker = torch.where(st["aw"] >= 0, st["aw"], st["pw"])
            load0 = scatter_count(W, qworker.clamp(min=0), queued)
            new_pw = greedy_place(g, placing, cost_tw, load0, cores_t)
            newly = due[:, None] & (new_pw >= 0)
            st["pw"] = torch.where(newly, new_pw, st["pw"])
            st["pp"] = torch.where(newly, greedy_prio, st["pp"])
            st["pt"] = torch.where(newly, (st["now"] + delay_)[:, None],
                                   st["pt"])
        st["events"] = st["events"] & ~due
        st["last"] = torch.where(due, st["now"], st["last"])
        return st

    def slot_counts(st):
        occ = st["slot_edge"] >= 0
        dcnt = occ.view(R, W, DOWNLOAD_SLOTS).sum(dim=2)
        pcnt = scatter_count(W * W, st["slot_src"] * W + slot_dst_k, occ)
        return dcnt, pcnt

    def acquire(st, pick, dst_e, src_e, bytes_e, ids):
        """This round's picks (at most one per destination) take the
        first free slot of their destination's pool."""
        N = pick.shape[1]
        pe = scatter_max(W, dst_e, torch.where(
            pick, torch.arange(N, device=dev), -1), -1)
        occ_w = (st["slot_edge"] >= 0).view(R, W, DOWNLOAD_SLOTS)
        first_free = occ_w.int().argmin(dim=2)
        has_free = ~occ_w.all(dim=2)
        taken = (pe >= 0) & has_free
        pe_c = pe.clamp(min=0)
        put = ((torch.arange(DOWNLOAD_SLOTS, device=dev)[None, None, :]
                == first_free[:, :, None]) & taken[:, :, None]).view(R, -1)

        def spread(v):
            return v[:, :, None].expand(R, W, DOWNLOAD_SLOTS).reshape(R, -1)

        st["slot_edge"] = torch.where(put, spread(take(ids, pe_c)),
                                      st["slot_edge"])
        st["slot_src"] = torch.where(put, spread(take(src_e, pe_c)),
                                     st["slot_src"])
        st["slot_rem"] = torch.where(put, spread(take(bytes_e, pe_c)),
                                     st["slot_rem"])
        st["overflow"] = st["overflow"] | ((pe >= 0) & ~has_free).any(dim=1)
        return st

    def start_flows(st, keymax):
        """Up to FLOW_ROUNDS rounds of at most one new download per
        destination, within the per-destination and per-pair slot
        limits; highest priority first, ties to the smaller edge id."""
        fr = st["fr_flow"]
        cid = fr.clamp(min=0)
        c_dst = take(st["aw"], take(e_task, cid)).clamp(min=0)
        c_src = take(st["aw"], take(prod_e, cid)).clamp(min=0)
        c_prio = take(keymax, take(e_obj, cid) * W + c_dst)
        c_bytes = take(e_bytes, cid)
        alive = fr >= 0
        c_pair = c_src * W + c_dst
        neg_id = -fr.to(F32)
        dcnt, pcnt = slot_counts(st)
        alive0 = alive
        for _ in range(FLOW_ROUNDS):
            eligible = (alive & (take(dcnt, c_dst) < DOWNLOAD_SLOTS)
                        & (take(pcnt, c_pair) < PAIR_SLOTS))
            pick = _pick_per_bucket(c_dst, W, eligible, c_prio, neg_id)
            st = acquire(st, pick, c_dst, c_src, c_bytes, fr)
            pw_pair = scatter_max(W, c_dst, torch.where(pick, c_pair, -1), -1)
            picked_w = pw_pair >= 0
            dcnt = dcnt + picked_w.long()
            pcnt = pcnt + scatter_count(W * W, pw_pair.clamp(min=0), picked_w)
            alive = alive & ~pick
        st["fr_flow"] = torch.where(alive0 & ~alive, -1, fr)
        return st

    def start_tasks(st):
        """Up to max_cores rounds of at most one start per worker: the
        highest-priority enabled task that fits the free cores, unless a
        higher-priority one is blocked on cores; ties to the smaller id."""
        fr = st["fr_task"]
        tid = fr.clamp(min=0)
        c_w = take(st["aw"], tid).clamp(min=0)
        c_cpus, c_prio = take(cpus, tid), take(st["ap"], tid)
        c_fin = take(dur_true, tid)
        alive = fr >= 0
        neg_id = -fr.to(F32)
        alive0 = alive
        free = st["free"]
        for _ in range(max(int(max_cores), 1)):
            free_at = take(free, c_w)
            blocked = alive & (c_cpus > free_at)
            maxblk = scatter_max(W, c_w, torch.where(blocked, c_prio, NEG),
                                 NEG)
            cand = alive & (c_cpus <= free_at) & (c_prio >= take(maxblk, c_w))
            pick = _pick_per_bucket(c_w, W, cand, c_prio, neg_id)
            free = free - scatter_max(W, c_w, torch.where(pick, c_cpus, 0), 0)
            alive = alive & ~pick
        newly = alive0 & ~alive
        dest = torch.where(newly, fr, T)
        started = torch.cat([st["t_started"], torch.zeros(
            R, 1, dtype=torch.bool, device=dev)], dim=1)
        started.scatter_(1, dest, True)
        t_finish = torch.cat([st["t_finish"], torch.zeros(
            R, 1, dtype=F32, device=dev)], dim=1)
        t_finish.scatter_(1, dest, st["now"][:, None] + c_fin)
        st["t_started"] = started[:, :T]
        st["t_finish"] = t_finish[:, :T]
        st["free"] = free
        st["fr_task"] = torch.where(newly, -1, fr)
        return st

    def advance(st):
        """Time moves to the next task finish, flow completion, due
        assignment or (greedy) invocation; remaining bytes integrate."""
        if use_slots:
            active = st["slot_edge"] >= 0
            rem = st["slot_rem"]
            rates = maxmin_rates(st["slot_src"], slot_dst_k, active, caps)
        else:
            active = st["f_started"] & ~st["f_done"]
            rem = st["f_rem"]
            rates = torch.where(active, bw[:, None], 0.0)
        now = st["now"]
        next_extra = st["pt"].amin(dim=1)
        if dynamic:
            next_extra = torch.minimum(next_extra, torch.where(
                st["events"], torch.maximum(now, st["last"] + msd_), INF))
        running = st["t_started"] & ~st["t_done"]
        t_next = torch.where(running, st["t_finish"], INF).amin(dim=1)
        gran = fma(now, g6, g1)
        safe = torch.where(rates > 0, rates, 1.0)
        f_eta = torch.where(active & (rates > 0), rem / safe, INF)
        f_eta = torch.where(f_eta <= gran[:, None], 0.0, f_eta)
        f_next = now + f_eta.amin(dim=1) if f_eta.shape[1] \
            else torch.full_like(now, INF)
        nxt = torch.minimum(torch.minimum(t_next, f_next), next_extra)
        nxt = torch.maximum(nxt, now)
        finite = torch.isfinite(nxt)
        dt = torch.where(finite, nxt - now, 0.0)
        now = torch.where(finite, nxt, now)
        rem = torch.where(active, fma(-rates, dt[:, None], rem), rem)
        done_now = active & ((rem <= BYTES_EPS)
                             | (rem <= rates * gran[:, None]))
        t_newly = running & (st["t_finish"] <= now[:, None] + TIME_EPS)
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
        return st, rem, done_now

    def step(st, live):
        st = dict(st)
        st = apply_due(st)
        if dynamic:
            st = apply_due(invoke(st, live))
        ready_t = st["in_cnt"] >= n_inputs
        keymax = key_e = None
        if E > 0:
            aw_e = take(st["aw"], e_task)
            src_e = take(st["aw"], prod_e)
            key_e = e_obj * W + aw_e.clamp(min=0)
            assigned = (aw_e >= 0) & edge_valid
            prod_done = take(st["t_done"], prod_e)
            cross = assigned & (src_e >= 0) & (src_e != aw_e)
            raw = take(st["ap"], e_task) + READY_BOOST \
                * take(ready_t, e_task).to(F32)
            raw = torch.where(assigned, raw, NEG)
            keymax = scatter_max(F, key_e, raw, NEG)
            want = cross & prod_done & ~take(st["key_q"], key_e)
            rep = scatter_min(F, key_e, torch.where(want, e_ids, E), E)
            new_flow = want & (take(rep, key_e) == e_ids)
            st["key_q"] = st["key_q"] | (rep < E)
            sat = assigned & ((prod_done & (src_e == aw_e))
                              | take(st["key_done"], key_e))
            enabled = ((scatter_count(T, e_task, sat) >= n_inputs)
                       & (st["aw"] >= 0) & ~st["t_started"])
            if use_slots:
                st["fr_flow"], ov = _append(st["fr_flow"], new_flow, e_ids)
                st["overflow"] = st["overflow"] | ov
            else:
                st["f_started"] = st["f_started"] | new_flow
        else:
            enabled = (st["aw"] >= 0) & ~st["t_started"]
        new_en = enabled & ~st["enq_t"]
        st["fr_task"], ov_t = _append(st["fr_task"], new_en, t_ids)
        st["enq_t"] = st["enq_t"] | new_en
        st["overflow"] = st["overflow"] | ov_t
        if use_slots:
            st = start_flows(st, keymax)
        st = start_tasks(st)
        st, rem, done_now = advance(st)
        if use_slots:
            sec = st["slot_edge"].clamp(min=0)
            sk = take(e_obj, sec) * W + slot_dst
            st["slot_rem"] = rem
            st["slot_edge"] = torch.where(done_now, -1, st["slot_edge"])
            st["key_done"] = st["key_done"] | scatter_or(F, sk, done_now)
            st["transferred"] = st["transferred"] + torch.where(
                done_now, take(e_bytes, sec), 0.0).sum(dim=1)
        else:
            st["f_rem"] = rem
            st["f_done"] = st["f_done"] | done_now
            if E > 0:
                st["key_done"] = st["key_done"] | scatter_or(F, key_e,
                                                             done_now)
        return st

    def cond(st):
        return (~st["t_done"].all(dim=1) & (st["steps"] < steps_cap)
                & ~st["overflow"])

    live = cond(st)
    n = 0
    while n % check_every or bool(live.any()):
        new = step(st, live)
        for k, v in st.items():
            if new[k] is not v:
                st[k] = torch.where(
                    live.view((R,) + (1,) * (v.dim() - 1)), new[k], v)
        live = cond(st)
        n += 1
    if use_slots:
        transferred = st["transferred"]
    else:
        transferred = torch.where(st["f_done"], e_bytes, 0.0).sum(dim=1)
    ok = st["t_done"].all(dim=1) & ~st["overflow"]
    makespan = torch.where(st["t_done"] & task_valid, st["t_finish"],
                           0.0).amax(dim=1)
    makespan = torch.where(ok, makespan, float("nan"))
    return dict(makespan=makespan.float().cpu().numpy(),
                transferred=transferred.float().cpu().numpy(),
                ok=ok.cpu().numpy(), n_events=st["n_events"].cpu().numpy(),
                n_steps=st["steps"].cpu().numpy())
