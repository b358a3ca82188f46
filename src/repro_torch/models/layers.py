"""Shared neural layers of the LM stack: norms, RoPE, attention (self- and
cross-attention, with the activation-type, int8 and ring KV caches), the
SwiGLU MLP and the MoE block.

Parameters keep the reference package's layouts (``wq [d, Hq, dh]``,
``wo [Hq*dh, d]``, ``w1 [d, f]``, ``moe.w1 [E, d, f]`` ...).  Products
follow the reference's type promotion: an operand pair of bfloat16 and
float32 is computed in float32 (``mm``), as the reference's einsums
promote.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..kernels import ops

F32 = torch.float32


def like(x, t):
    """``t``, a plain tensor that no parameter feeds (a rope table, a
    mask, positions, a padding of zeros), as a replicated DTensor on
    ``x``'s mesh when ``x`` is a DTensor; else ``t`` itself."""
    if not isinstance(x, DTensor):
        return t
    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def seq_whole(a):
    """An activation ``a [B, S, ...]`` whole along its sequence: a
    DTensor split over ``S`` (sequence parallelism) is all-gathered over
    those mesh dims, as a sequence-parallel matmul does before a product
    (folding a split ``S`` into the rows would leave a strided split)."""
    if not isinstance(a, DTensor) or a.dim() < 3:
        return a
    pl = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
          for p in a.placements]
    if pl == list(a.placements):
        return a
    return a.redistribute(a.device_mesh, pl)


def gathered(w):
    """A weight whole over the data-parallel mesh dims (every dim but
    ``model``), as ZeRO-3 all-gathers it before use; its ``model`` split
    stays.  Plain tensors pass through."""
    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names
    pl = [p if n == "model" else Replicate()
          for n, p in zip(names, w.placements)]
    if pl == list(w.placements):
        return w
    return w.redistribute(w.device_mesh, pl)


def grad_as_output(y):
    """``y``; in the backward pass its gradient is first placed as ``y``
    is (a partial sum's as replicated), so the product that made ``y``
    never folds a gradient split along the sequence into its rows.
    Plain tensors, and DTensors outside autograd, pass through."""
    if not isinstance(y, DTensor) or not y.requires_grad:
        return y
    from torch.distributed.tensor.experimental import local_map
    pl = list(y.placements)
    grad = [Replicate() if p.is_partial() else p for p in pl]
    return local_map(lambda t: t, out_placements=pl, in_placements=(pl,),
                     in_grad_placements=(grad,), device_mesh=y.device_mesh,
                     redistribute_inputs=True)(y)


def mm(a, w):
    """``a @ w`` in the promoted type of the pair (bf16 x f32 -> f32); on
    DTensors the activation whole along its sequence and the weight
    gathered (``seq_whole``, ``gathered``; see ``grad_as_output``)."""
    t = torch.promote_types(a.dtype, w.dtype)
    return grad_as_output(torch.matmul(seq_whole(a).to(t),
                                       gathered(w).to(t)))


def einsum(eq, a, b):
    """``torch.einsum`` of an activation and a weight in the promoted
    type of the pair, as ``mm`` (DTensors: ``_sharded_einsum``)."""
    t = torch.promote_types(a.dtype, b.dtype)
    if isinstance(a, DTensor):
        return _sharded_einsum(eq, seq_whole(a).to(t), gathered(b).to(t))
    return torch.einsum(eq, a.to(t), b.to(t))


def _sharded_einsum(eq, a, b):
    """``einsum`` of DTensors on each rank's local tensors: ``a`` split
    only along its leading (batch) dim, ``b`` as it is (``gathered``);
    the output split as they are, a contracted split of ``b`` a partial
    sum.  (Left to DTensor, a split of ``b`` folded with another of its
    dims would need a strided split.)"""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    lhs, out = eq.split("->")
    ea, eb = lhs.split(",")
    b_pl = list(b.placements)
    a_pl = [p if isinstance(p, Shard) and p.dim == 0
            and not isinstance(b_pl[i], Shard) else Replicate()
            for i, p in enumerate(a.placements)]
    out_pl = [Replicate()] * len(a_pl)
    a_grad, b_grad = list(a_pl), list(b_pl)
    for i, p in enumerate(a_pl):
        if isinstance(p, Shard):
            out_pl[i] = Shard(out.index(ea[0]))
            b_grad[i] = Partial()
    for i, p in enumerate(b_pl):
        if isinstance(p, Shard):
            letter = eb[p.dim]
            out_pl[i] = Shard(out.index(letter)) if letter in out \
                else Partial()
            a_grad[i] = Partial()
    return local_map(lambda x, y: torch.einsum(eq, x, y),
                     out_placements=out_pl, in_placements=(a_pl, b_pl),
                     in_grad_placements=(a_grad, b_grad),
                     device_mesh=a.device_mesh,
                     redistribute_inputs=True)(a, b)


def rms_norm(x, weight, eps=1e-6):
    """RMS norm computed in float32, returned in x's dtype."""
    x32 = x.to(F32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * weight.to(F32)
    return out.to(x.dtype)


def split_heads(t, h, dh):
    """``t [B, S, h * dh]`` as ``[B, S, h, dh]``.  A DTensor split over
    its last dim into parts that cut a head is gathered over those mesh
    dims first (the view cannot split it unevenly)."""
    B, S = t.shape[:2]
    if isinstance(t, DTensor):
        mesh, last = t.device_mesh, t.dim() - 1
        dims = [i for i, p in enumerate(t.placements)
                if isinstance(p, Shard) and p.dim == last]
        n = 1
        for i in dims:
            n *= mesh.size(i)
        if h % n:
            t = t.redistribute(mesh, [Replicate() if i in dims else p
                                      for i, p in enumerate(t.placements)])
    return t.reshape(B, S, h, dh)


def merge_heads(t):
    """``t [B, S, h, dh]`` as ``[B, S, h * dh]``.  A DTensor's local
    shards are merged in a ``local_map`` (split heads stay split), so
    that its gradient comes back in the same placement and never has to
    be cut into heads unevenly."""
    if not isinstance(t, DTensor):
        return t.reshape(*t.shape[:2], -1)
    from torch.distributed.tensor.experimental import local_map
    in_pl = [Replicate() if isinstance(p, Shard) and p.dim == 3 else p
             for p in t.placements]
    return local_map(lambda tl: tl.reshape(*tl.shape[:2], -1),
                     out_placements=in_pl, in_placements=(in_pl,),
                     device_mesh=t.device_mesh,
                     redistribute_inputs=True)(t)


# ------------------------------------------------------------------ RoPE
def rope_freqs(d_head, theta, device=None):
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=F32,
                                         device=device) / d_head))


def apply_rope(x, positions, theta=500_000.0, style="full"):
    """x: [..., S, H, D]; positions: [..., S] integer."""
    if style == "none":
        return x
    D = x.shape[-1]
    rot_d = D if style == "full" else D // 2
    freqs = rope_freqs(rot_d, theta, x.device)              # [rot_d/2]
    ang = positions[..., None].to(F32) * freqs             # [..., S, rot/2]
    cos = like(x, torch.cos(ang)[..., None, :])
    sin = like(x, torch.sin(ang)[..., None, :])
    xr = x[..., :rot_d].to(F32)
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    rot = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    if style == "half":
        rot = torch.cat([rot, x[..., rot_d:].to(F32)], dim=-1)
    return rot.to(x.dtype)


# ------------------------------------------------------------- attention
def quantize(t):
    """Per-vector symmetric int8: ``t ~ q * scale`` with ``q`` int8 and
    ``scale [..., 1]`` float32; ``round`` half to even, then a clip to
    +-127, as the reference's ``_quantize``."""
    t32 = t.to(F32)
    scale = torch.clamp(t32.abs().amax(dim=-1, keepdim=True),
                        min=1e-6) / 127.0
    q = torch.clamp(torch.round(t32 / scale), -127, 127).to(torch.int8)
    return q, scale


def write_seq(dst, src, pos):
    """``dst[:, pos:pos + S] = src`` in place (``S = src.shape[1]``).  On
    DTensors ``src`` is first placed as ``dst`` but whole along the
    sequence, and each rank writes the part of ``[pos, pos + S)`` that
    its shard of ``dst`` holds (a cache split along the sequence)."""
    S = src.shape[1]
    if not isinstance(dst, DTensor):
        dst[:, pos:pos + S] = src
        return
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = dst.device_mesh
    src = src.redistribute(mesh, [
        Replicate() if isinstance(p, Shard) and p.dim == 1 else p
        for p in dst.placements]).to_local()
    local = dst.to_local()
    shape, offset = compute_local_shape_and_global_offset(
        dst.shape, mesh, dst.placements)
    lo, hi = max(pos, offset[1]), min(pos + S, offset[1] + shape[1])
    if lo < hi:
        local[:, lo - offset[1]:hi - offset[1]] = src[:, lo - pos:hi - pos]


def _write_cache(cache, k, v, pos, dtype):
    """Write ``k``, ``v [B, S, Hk, dh]`` into ``cache`` in place at
    ``pos`` and return the whole cache's keys and values in ``dtype``:
    the int8 cache (``k_scale`` present) quantises on the way in and
    dequantises all of it on the way out."""
    if "k_scale" not in cache:
        write_seq(cache["k"], k, pos)
        write_seq(cache["v"], v, pos)
        return cache["k"], cache["v"]
    out = []
    for name, t in (("k", k), ("v", v)):
        q, scale = quantize(t)
        write_seq(cache[name], q, pos)
        write_seq(cache[name + "_scale"], scale, pos)
        out.append((cache[name].to(F32) * cache[name + "_scale"]).to(dtype))
    return out


def attention_block(x, p, cfg, *, window, positions=None, cache=None,
                    cache_pos=0, kv_len=None, is_cross=False,
                    kv_source=None, impl="auto"):
    """GQA attention with optional cross-attention and a KV cache.

    x: [B, S, D] (queries); ``window``: this layer's sliding window
    (Python int, 0 = full).  Self-attention: ``cache`` = dict(k=[B, Sc,
    Hk, dh], v=...) (the int8 cache adds ``k_scale``/``v_scale [B, Sc,
    Hk, 1]``) or None, written in place at ``cache_pos``; ``kv_len``:
    valid cache length after the write.  A ring cache (the config's
    ``window_ring_cache``, a cache no longer than the config's
    ``window``, one token) writes at ``cache_pos % Sc`` and attends to
    every written slot.  Cross-attention (``is_cross``): keys and values
    projected from ``kv_source [B, T, D]`` into ``cache`` (prefill), or
    read back from it (decode); non-causal, no window, scaled by
    ``tanh(gate)``.  Returns (out [B, S, D], cache).
    """
    B, S, D = x.shape
    hq, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = split_heads(mm(x, gathered(p["wq"]).reshape(D, hq * dh)), hq, dh)
    causal = True
    if not is_cross:
        k = split_heads(mm(x, gathered(p["wk"]).reshape(D, hk * dh)), hk, dh)
        v = split_heads(mm(x, gathered(p["wv"]).reshape(D, hk * dh)), hk, dh)
        if cfg.qk_norm:
            q = rms_norm(q, p["q_norm"], cfg.norm_eps)
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_style)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_style)
        if cache is not None:
            L_cache = cache["k"].shape[1]
            # the reference's condition, on the config's window (not the
            # layer's): a prefill fills the ring in order and stays causal
            ring = (cfg.window_ring_cache and cfg.window > 0
                    and L_cache <= cfg.window and S == 1)
            write_pos = cache_pos % L_cache if ring else cache_pos
            if write_pos + S > L_cache:
                raise ValueError(f"KV cache of {L_cache} positions cannot "
                                 f"take {S} more at {write_pos}")
            if ring:
                # the ring holds exactly the window; RoPE is absolute, so
                # every written slot is attendable in any order
                causal = False
                kv_len = min(cache_pos + S, L_cache)
            k, v = _write_cache(cache, k, v, write_pos, x.dtype)
    else:
        if kv_source is not None:
            T = kv_source.shape[1]
            k = split_heads(mm(kv_source,
                               gathered(p["wk"]).reshape(D, hk * dh)),
                            hk, dh)
            v = split_heads(mm(kv_source,
                               gathered(p["wv"]).reshape(D, hk * dh)),
                            hk, dh)
        elif cache is not None:
            k, v = cache["k"], cache["v"]
        else:
            raise ValueError("cross-attention needs kv_source (the vision "
                             "input) or a cache that holds it")
        if cfg.qk_norm:
            # as the reference: at decode the cached (already normalised)
            # keys are normalised again, and written back
            q = rms_norm(q, p["q_norm"], cfg.norm_eps)
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)
        if cache is not None:
            for name, t in (("k", k), ("v", v)):
                if t is not cache[name]:
                    write_seq(cache[name], t, 0)
        causal, window, kv_len = False, 0, None
    out = ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, window=window,
                        kv_len=kv_len, impl=impl)           # [B,Hq,S,dh]
    out = merge_heads(out.transpose(1, 2))
    out = mm(out, p["wo"])
    if "gate" in p:                                         # vision cross
        out = out * torch.tanh(p["gate"]).to(out.dtype)
    return out.to(x.dtype), cache


# ------------------------------------------------------------------- MLP
def swiglu(x, p):
    h = F.silu(mm(x, p["w1"]))
    h = h * mm(x, p["w3"])
    return mm(h, p["w2"]).to(x.dtype)


# ------------------------------------------------------------------- MoE
def top_k(logits, k):
    """``(values, indices)`` of the ``k`` largest entries of the last
    axis, the lowest index first among equal values (as
    ``jax.lax.top_k``; ``torch.topk`` leaves that order unspecified)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x, router, k):
    """Router logits in float32, the top ``k`` experts of each token and
    the softmax over their ``k`` logits: ``(gates, idx)``."""
    logits = mm(x.to(F32), router.to(F32))
    gates, idx = top_k(logits, k)
    return torch.softmax(gates, dim=-1), idx


def moe_block(x, p, cfg, policy=None):
    """Top-k MoE.  p: router [D, E] float32, w1/w3 [E, D, F],
    w2 [E, F, D].

    ``dense`` dispatch: every expert computes every token and the gates
    select (the reference's SPMD formulation); with ``moe_fold_gates``
    the gates scale ``h`` and ``(e, f)`` are contracted together.
    ``gather`` dispatch: ``_gather_dispatch``.  DTensor ``x`` (a model on a
    mesh): ``_sharded_moe``."""
    if isinstance(x, DTensor):
        return _sharded_moe(x, p, cfg, policy)
    w = (p["w1"], p["w3"], p["w2"], p["router"])
    if cfg.moe_dispatch == "gather":
        out = _gather_dispatch(x, *w, cfg, max(1, min(cfg.moe_groups,
                                                      x.shape[0])))
    else:
        out = _dense_dispatch(x, *w, cfg)
    return out.to(x.dtype)


def _dense_dispatch(x, w1, w3, w2, router, cfg):
    """The dense dispatch of plain ``x [B, S, D]``, before the cast to
    ``x``'s type."""
    E = cfg.moe_experts
    gates, idx = _route(x, router, cfg.moe_top_k)           # [B,S,k]
    onehot = F.one_hot(idx, E).to(F32)                      # [B,S,k,E]
    combine = torch.einsum("bske,bsk->bse", onehot, gates)
    h = F.silu(einsum("bsd,edf->bsef", x, w1))
    h = h * einsum("bsd,edf->bsef", x, w3)
    if cfg.moe_fold_gates:
        hg = h * combine[..., None].to(h.dtype)
        return einsum("bsef,efd->bsd", hg, w2)
    y = einsum("bsef,efd->bsed", h, w2)
    return torch.einsum("bsed,bse->bsd", y.to(F32), combine)


def moe_capacity(cfg, Tg):
    """Tokens per expert buffer of the gather dispatch for ``Tg`` tokens
    a group: ``round(capacity * k * Tg / E)`` (Python's ``round``, at
    least 1), rounded up to 128 and capped at ``Tg``."""
    C = max(1, int(round(cfg.moe_capacity * cfg.moe_top_k * Tg
                         / cfg.moe_experts)))
    return min(Tg, ((C + 127) // 128) * 128)


def _sharded_moe(x, p, cfg, policy):
    """``moe_block`` of DTensors in one ``local_map``.  The tokens split
    over ``policy.batch_axes``: for the dense dispatch where the batch
    divides, for the gather dispatch where its ``G`` groups divide too
    (each rank then dispatches its own ``G / dp`` groups, the
    reference's pin), else every rank takes every token.  The experts'
    hidden dim ``F`` stays split over ``model`` where it divides (the
    weights gathered over the data-parallel dims, ZeRO-3), so each
    rank's expert outputs, and their sum back onto the tokens, are
    partial sums over ``model`` that the next placement reduces (before
    the cast to ``x``'s type)."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    B = x.shape[0]
    gather = cfg.moe_dispatch == "gather"
    G = max(1, min(cfg.moe_groups, B))
    axes = () if policy is None or policy.mesh is None \
        else policy.batch_axes
    dp = 1
    for a in axes:
        dp *= mesh.size(names.index(a))
    pin = dp > 1 and B % dp == 0 and (G % dp == 0 or not gather)
    rep = [Replicate()] * mesh.ndim
    x_pl, out_pl = list(rep), list(rep)
    if pin:
        for a in axes:
            x_pl[names.index(a)] = out_pl[names.index(a)] = Shard(0)
    w13_pl, w2_pl = list(rep), list(rep)
    split = []
    if "model" in names:
        mi = names.index("model")
        if mesh.size(mi) > 1 and cfg.d_ff % mesh.size(mi) == 0:
            w13_pl[mi], w2_pl[mi], out_pl[mi] = Shard(2), Shard(1), Partial()
            split = [mi]

    def local(xl, w1, w3, w2, router):
        if gather:
            return _gather_dispatch(xl, w1, w3, w2, router, cfg,
                                    G // dp if pin else G)
        return _dense_dispatch(xl, w1, w3, w2, router, cfg)

    # replicated inputs whose ranks compute different parts take partial
    # gradients: the weights over the split tokens, x and the router over
    # the split of F
    tok = ops.sharded_dims(x_pl)
    out = local_map(
        local, out_placements=out_pl,
        in_placements=(x_pl, w13_pl, w13_pl, w2_pl, rep),
        in_grad_placements=(ops.with_partial(x_pl, split),
                            ops.with_partial(w13_pl, tok),
                            ops.with_partial(w13_pl, tok),
                            ops.with_partial(w2_pl, tok),
                            ops.with_partial(rep, tok + split)),
        device_mesh=mesh, redistribute_inputs=True)(
        x, p["w1"], p["w3"], p["w2"], p["router"])
    return out.to(x.dtype)


def _gather_dispatch(x, w1, w3, w2, router, cfg, G):
    """The gather dispatch of plain ``x [B, S, D]``, the sorted capacity
    dispatch (the reference's ``_moe_gather``): only the routed experts
    compute.  The ``B * S`` tokens form ``G`` groups on a leading axis
    (``min(moe_groups, B)`` on one card); in each, the (token,
    expert) pairs are sorted by expert (stable), each expert's first
    ``C`` (``moe_capacity``) pairs fill its buffer row by row and the
    rest go to a dump row ``E * C`` and are dropped; the expert outputs,
    scaled by their gates in float32, are added back to their tokens.
    Returns the float32 sum ``[B, S, D]``.  On a mesh the groups are
    pinned to the data-parallel axes, as the reference pins them
    (``_sharded_moe``)."""
    B, S, D = x.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    Tg = B * S // G
    C = moe_capacity(cfg, Tg)
    dev = x.device
    xt = x.reshape(G, Tg, D)
    gates, idx = _route(xt, router, k)                      # [G,Tg,k]
    e_flat = idx.reshape(G, Tg * k)
    order = torch.sort(e_flat, dim=-1, stable=True).indices
    e_s = torch.gather(e_flat, 1, order)
    tok_s = order // k                                      # pair -> token
    g_s = torch.gather(gates.reshape(G, Tg * k), 1, order)
    counts = torch.zeros(G, E, dtype=torch.long, device=dev).scatter_add_(
        1, e_flat, torch.ones_like(e_flat))
    starts = torch.cumsum(counts, dim=1) - counts
    pos = torch.arange(Tg * k, device=dev) - torch.gather(starts, 1, e_s)
    keep = pos < C
    slot = torch.where(keep, e_s * C + pos.clamp(0, C - 1), E * C)
    # one buffer row per slot of every group, the dump row last in each
    rows = slot + torch.arange(G, device=dev)[:, None] * (E * C + 1)
    tok_rows = (tok_s + torch.arange(G, device=dev)[:, None] * Tg).reshape(-1)
    src = torch.where(keep[..., None], xt.reshape(G * Tg, D)[tok_rows]
                      .reshape(G, Tg * k, D), 0)
    # kept slots are distinct, so each buffer row receives one value (the
    # dump row only zeros): adding into zeros writes it exactly
    buf = torch.zeros(G * (E * C + 1), D, dtype=x.dtype, device=dev)
    buf.index_add_(0, rows.reshape(-1), src.reshape(-1, D))
    buf = buf.reshape(G, E * C + 1, D)[:, :E * C].reshape(G, E, C, D)
    h = F.silu(einsum("gecd,edf->gecf", buf, w1))
    h = h * einsum("gecd,edf->gecf", buf, w3)
    y = einsum("gecf,efd->gecd", h, w2).reshape(G, E * C, D)
    y = torch.cat([y, torch.zeros(G, 1, D, dtype=y.dtype, device=dev)],
                  dim=1).reshape(G * (E * C + 1), D)
    contrib = y[rows.reshape(-1)].to(F32) * torch.where(
        keep, g_s, 0.0).reshape(-1, 1)
    out = torch.zeros(G * Tg, D, dtype=F32, device=dev)
    out.index_add_(0, tok_rows, contrib)
    return out.reshape(B, S, D)
