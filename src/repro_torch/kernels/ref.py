"""Plain PyTorch versions of the LM kernels K2 (attention) and K3 (SSD).

They compute what the reference package's oracles compute
(``attention_ref``, ``ssd_ref``, ``ssd_chunked``, and the sequential
final-state scan of ``models/ssm.py``), in the same layouts; beside
them, the plain versions of the decode route's two kernels
(``attention_partials``, ``combine_splits``) and of the SSD scan's
three phases (``ssd_chunk_states``, ``ssd_pass_states``,
``ssd_chunk_scan``).  The CPU path and the tests use them; on the card the wrappers in
``flash_attention.py`` and ``ssd.py`` launch the CUDA kernels instead,
and ``chip_smoke.py`` holds each kernel against these.
"""
from __future__ import annotations

import torch

F32 = torch.float32


# ------------------------------------------------------------- attention
def attention_mask(Sq, Skv, *, causal=True, window=0, kv_len=None,
                   device=None):
    """Boolean ``[Sq, Skv]`` mask of ``attention_ref``: key ``k`` is
    visible to query ``i`` (absolute position ``i + kv_len - Sq``) when
    ``k < kv_len``, ``k <= q_pos`` (causal) and ``k > q_pos - window``
    (``window > 0``)."""
    valid = Skv if kv_len is None else int(kv_len)
    q_pos = torch.arange(Sq, device=device)[:, None] + (valid - Sq)
    k_pos = torch.arange(Skv, device=device)[None, :]
    mask = torch.broadcast_to(k_pos < valid, (Sq, Skv))
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window > 0:
        mask = mask & (k_pos > q_pos - int(window))
    return mask


def attention_ref(q, k, v, *, causal=True, window=0, scale=None,
                  kv_len=None):
    """Exact softmax attention with GQA and an optional sliding window.

    q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D]; Hq % Hkv == 0.
    ``window > 0``: query i attends to keys in (i_abs - window, i_abs].
    ``kv_len``: valid key prefix length (decode caches longer than the
    written history); queries are the last Sq positions of that prefix.
    Scores and probabilities in float32; the output in q's dtype.
    """
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    kk = k.repeat_interleave(group, dim=1).to(F32)
    vv = v.repeat_interleave(group, dim=1).to(F32)
    logits = torch.matmul(q.to(F32), kk.transpose(-1, -2)) * scale
    mask = attention_mask(Sq, Skv, causal=causal, window=window,
                          kv_len=kv_len, device=q.device)
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs, vv)
    return out.to(q.dtype)


def attention_partials(q, k, v, bounds, *, causal=True, window=0,
                       scale=None, kv_len=None):
    """Unnormalised float32 partials of ``attention_ref`` over key
    ranges, the plain version of the split route's first kernel.  For
    each ``[start, stop)`` of ``bounds``, over the keys in it that the
    mask shows: ``m`` the largest score (-1e30 when none),
    ``l = sum exp(s - m)`` and ``o = sum exp(s - m) v``.  Returns
    ``(o [S, B, Hq, Sq, D], m [S, B, Hq, Sq], l [S, B, Hq, Sq])``."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    kk = k.repeat_interleave(group, dim=1).to(F32)
    vv = v.repeat_interleave(group, dim=1).to(F32)
    logits = torch.matmul(q.to(F32), kk.transpose(-1, -2)) * scale
    mask = attention_mask(Sq, Skv, causal=causal, window=window,
                          kv_len=kv_len, device=q.device)
    keys = torch.arange(Skv, device=q.device)
    os, ms, ls = [], [], []
    for start, stop in bounds:
        seen = mask & (keys >= start) & (keys < stop)
        s = logits.masked_fill(~seen, -1e30)
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None]) * seen
        os.append(torch.matmul(p, vv))
        ms.append(m)
        ls.append(p.sum(dim=-1))
    return torch.stack(os), torch.stack(ms), torch.stack(ls)


def combine_splits(o_parts, m_parts, l_parts, out_dtype):
    """Attention output from unnormalised partials (leading axis: the
    splits), the plain version of the split route's combine kernel:
    each split rescaled by ``exp(m_s - max m)``, summed, divided by the
    summed ``l`` floored at 1e-30, cast to ``out_dtype``.  A split with
    no visible key (``m = -1e30``, ``l = 0``, ``o = 0``) adds nothing."""
    m = m_parts.to(F32)
    w = torch.exp(m - m.amax(dim=0))
    den = (w * l_parts.to(F32)).sum(dim=0).clamp_min(1e-30)
    out = (w[..., None] * o_parts.to(F32)).sum(dim=0) / den[..., None]
    return out.to(out_dtype)


# ------------------------------------------------------------------ SSD
def _ssd_recurrence(x, dt, A, B, C=None):
    """The sequential SSD recurrence: (``y [Bt, L, H, P]`` float32, or
    None without ``C``; the final state ``f32[Bt, H, N, P]``)."""
    Bt, L, H, P = x.shape
    N = B.shape[-1]
    xf, dtf, Bf, Af = (t.to(F32) for t in (x, dt, B, A))
    h = torch.zeros(Bt, H, N, P, dtype=F32, device=x.device)
    ys = []
    for t in range(L):
        decay = torch.exp(dtf[:, t] * Af[None, :])             # [Bt,H]
        h = h * decay[..., None, None] + torch.einsum(
            "bn,bh,bhp->bhnp", Bf[:, t], dtf[:, t], xf[:, t])
        if C is not None:
            ys.append(torch.einsum("bn,bhnp->bhp", C[:, t].to(F32), h))
    return (torch.stack(ys, dim=1) if C is not None else None), h


def ssd_ref(x, dt, A, B, C, D=None):
    """Naive Mamba-2 SSD recurrence (single group).

    x: [Bt, L, H, P]; dt: [Bt, L, H]; A: [H]; B, C: [Bt, L, N];
    D: [H] or None.  Returns y: [Bt, L, H, P] in x's dtype.

    h_t = exp(dt_t A) h_{t-1} + dt_t * outer(B_t, x_t);  y_t = C_t @ h_t.
    """
    y, _ = _ssd_recurrence(x, dt, A, B, C)                      # [Bt,L,H,P]
    if D is not None:
        y = y + D.to(F32)[None, None, :, None] * x.to(F32)
    return y.to(x.dtype)


def ssd_final_state(x, dt, A, B):
    """SSM state ``f32[Bt, H, N, P]`` after the whole sequence, by the
    sequential recurrence (the prefill -> decode handoff of the
    reference's ``models/ssm.py::_final_state``)."""
    return _ssd_recurrence(x, dt, A, B)[1]


def ssd_chunked(x, dt, A, B, C, D=None, chunk=64):
    """Chunk-parallel SSD (the dual / matmul form).

    The same function as ``ssd_ref``, structured like the kernel:
    within a chunk of Q steps a causally decayed ``[Q, Q]`` product;
    across chunks the carried state ``[N, P]``.  ``L`` must be a
    multiple of ``min(chunk, L)``.  The causal decay Γ is built with a
    select (``where(j <= i, exp(cum_i - cum_j), 0)``), so an ``exp``
    that overflows above the diagonal never meets a zero.
    """
    Bt, L, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, L)
    assert L % Q == 0, (L, Q)
    nc = L // Q
    xf = x.to(F32).reshape(Bt, nc, Q, H, P)
    dtf = dt.to(F32).reshape(Bt, nc, Q, H)
    Bf = B.to(F32).reshape(Bt, nc, Q, N)
    Cf = C.to(F32).reshape(Bt, nc, Q, N)
    Af = A.to(F32)

    da = dtf * Af[None, None, None, :]                  # [b,c,q,h]
    cum = torch.cumsum(da, dim=2)                       # inclusive
    total = cum[:, :, -1, :]                            # [b,c,h]

    # intra-chunk: y_i += sum_{j<=i} C_i.B_j exp(cum_i-cum_j) dt_j x_j
    tril = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [b,c,i,j,h]
    gamma = torch.where(tril[None, None, :, :, None], torch.exp(diff),
                        torch.zeros((), dtype=F32, device=x.device))
    scores = torch.einsum("bcin,bcjn->bcij", Cf, Bf)
    xdt = xf * dtf[..., None]                           # [b,c,q,h,p]
    w_ij = (scores[..., None] * gamma).permute(0, 1, 4, 2, 3)  # [b,c,h,i,j]
    y = torch.matmul(w_ij, xdt.permute(0, 1, 3, 2, 4))  # [b,c,h,i,p]
    y = y.permute(0, 1, 3, 2, 4)                        # [b,c,i,h,p]

    # per-chunk emitted state: S_c = sum_j exp(total-cum_j) B_j (dt x)_j
    w = torch.exp(total[:, :, None, :] - cum)           # [b,c,q,h]
    S = torch.einsum("bcjn,bcjh,bcjhp->bchnp", Bf, w, xdt)
    decay = torch.exp(total)                            # [b,c,h]

    # inter-chunk: the state entering chunk c, carried in chunk order
    h_in = []
    h = torch.zeros(Bt, H, N, P, dtype=F32, device=x.device)
    for c in range(nc):
        h_in.append(h)
        h = h * decay[:, c, :, None, None] + S[:, c]
    h_in = torch.stack(h_in, dim=1)                     # [b,c,h,n,p]
    y = y + torch.einsum("bcin,bcih,bchnp->bcihp", Cf, torch.exp(cum), h_in)

    y = y.reshape(Bt, L, H, P)
    if D is not None:
        y = y + D.to(F32)[None, None, :, None] * x.to(F32)
    return y.to(x.dtype)


# The three phases of the CUDA kernel (``kernels/csrc/ssd.cu``), written
# from ``ssd_chunked``'s own steps: composed, they give its ``y`` and
# the final state.
def _chunk_cum(dt, A, Q):
    """Inclusive cumulative decay ``cum f32[Bt, nc, Q, H]`` of each
    chunk and its total ``f32[Bt, nc, H]``."""
    Bt, L, H = dt.shape
    da = dt.to(F32).reshape(Bt, L // Q, Q, H) * A.to(F32)[None, None, None]
    cum = torch.cumsum(da, dim=2)
    return cum, cum[:, :, -1, :]


def ssd_chunk_states(x, dt, A, B, chunk=64):
    """Phase 1: the state each chunk emits on its own,
    ``S_c = Σ_j exp(total − cum_j) B_j (dt x)_j`` as
    ``f32[Bt, nc, H, N, P]``, and the chunk totals ``f32[Bt, nc, H]``."""
    Bt, L, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, L)
    assert L % Q == 0, (L, Q)
    nc = L // Q
    cum, total = _chunk_cum(dt, A, Q)
    xdt = (x.to(F32) * dt.to(F32)[..., None]).reshape(Bt, nc, Q, H, P)
    w = torch.exp(total[:, :, None, :] - cum)                # [b,c,q,h]
    S = torch.einsum("bcjn,bcjh,bcjhp->bchnp",
                     B.to(F32).reshape(Bt, nc, Q, N), w, xdt)
    return S, total


def ssd_pass_states(S_loc, total):
    """Phase 2: the state entering each chunk, ``h_in f32[Bt, nc, H, N,
    P]`` (zero for the first), and the state after the last, by
    ``h = exp(total_c) h + S_c`` in chunk order."""
    h = torch.zeros_like(S_loc[:, 0])
    decay = torch.exp(total)
    h_in = []
    for c in range(S_loc.shape[1]):
        h_in.append(h)
        h = h * decay[:, c, :, None, None] + S_loc[:, c]
    return torch.stack(h_in, dim=1), h


def ssd_chunk_scan(x, dt, A, B, C, D, h_in, chunk=64):
    """Phase 3: ``y = G (dt x) + (C ⊙ exp(cum)) h_in + D x`` per chunk,
    ``G = C Bᵀ ⊙ Γ`` with Γ by a select as in ``ssd_chunked``; ``y`` in
    x's dtype."""
    Bt, L, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, L)
    assert L % Q == 0, (L, Q)
    nc = L // Q
    cum, _ = _chunk_cum(dt, A, Q)
    Cf = C.to(F32).reshape(Bt, nc, Q, N)
    tril = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # [b,c,i,j,h]
    gamma = torch.where(tril[None, None, :, :, None], torch.exp(diff),
                        torch.zeros((), dtype=F32, device=x.device))
    scores = torch.einsum("bcin,bcjn->bcij", Cf,
                          B.to(F32).reshape(Bt, nc, Q, N))
    xdt = (x.to(F32) * dt.to(F32)[..., None]).reshape(Bt, nc, Q, H, P)
    g = (scores[..., None] * gamma).permute(0, 1, 4, 2, 3)   # [b,c,h,i,j]
    y = torch.matmul(g, xdt.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)
    y = y + torch.einsum("bcin,bcih,bchnp->bcihp", Cf, torch.exp(cum), h_in)
    y = y.reshape(Bt, L, H, P)
    if D is not None:
        y = y + D.to(F32)[None, None, :, None] * x.to(F32)
    return y.to(x.dtype)
