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

from ..kernels import ops

F32 = torch.float32


def mm(a, w):
    """``a @ w`` in the promoted type of the pair (bf16 x f32 -> f32)."""
    t = torch.promote_types(a.dtype, w.dtype)
    return torch.matmul(a.to(t), w.to(t))


def einsum(eq, a, b):
    """``torch.einsum`` in the promoted type of the pair, as ``mm``."""
    t = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(t), b.to(t))


def rms_norm(x, weight, eps=1e-6):
    """RMS norm computed in float32, returned in x's dtype."""
    x32 = x.to(F32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * weight.to(F32)
    return out.to(x.dtype)


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
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
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


def _write_cache(cache, k, v, pos, dtype):
    """Write ``k``, ``v [B, S, Hk, dh]`` into ``cache`` in place at
    ``pos`` and return the whole cache's keys and values in ``dtype``:
    the int8 cache (``k_scale`` present) quantises on the way in and
    dequantises all of it on the way out."""
    S = k.shape[1]
    if "k_scale" not in cache:
        cache["k"][:, pos:pos + S] = k
        cache["v"][:, pos:pos + S] = v
        return cache["k"], cache["v"]
    out = []
    for name, t in (("k", k), ("v", v)):
        q, scale = quantize(t)
        cache[name][:, pos:pos + S] = q
        cache[name + "_scale"][:, pos:pos + S] = scale
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
    q = mm(x, p["wq"].reshape(D, hq * dh)).reshape(B, S, hq, dh)
    causal = True
    if not is_cross:
        k = mm(x, p["wk"].reshape(D, hk * dh)).reshape(B, S, hk, dh)
        v = mm(x, p["wv"].reshape(D, hk * dh)).reshape(B, S, hk, dh)
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
            k = mm(kv_source, p["wk"].reshape(D, hk * dh)).reshape(
                B, T, hk, dh)
            v = mm(kv_source, p["wv"].reshape(D, hk * dh)).reshape(
                B, T, hk, dh)
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
                    cache[name].copy_(t)
        causal, window, kv_len = False, 0, None
    out = ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, window=window,
                        kv_len=kv_len, impl=impl)           # [B,Hq,S,dh]
    out = out.transpose(1, 2).reshape(B, S, hq * dh)
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


def moe_block(x, p, cfg):
    """Top-k MoE.  p: router [D, E] float32, w1/w3 [E, D, F],
    w2 [E, F, D].

    ``dense`` dispatch: every expert computes every token and the gates
    select (the reference's SPMD formulation); with ``moe_fold_gates``
    the gates scale ``h`` and ``(e, f)`` are contracted together.
    ``gather`` dispatch: ``moe_gather``."""
    if cfg.moe_dispatch == "gather":
        return moe_gather(x, p, cfg)
    E = cfg.moe_experts
    gates, idx = _route(x, p["router"], cfg.moe_top_k)      # [B,S,k]
    onehot = F.one_hot(idx, E).to(F32)                      # [B,S,k,E]
    combine = torch.einsum("bske,bsk->bse", onehot, gates)
    h = F.silu(einsum("bsd,edf->bsef", x, p["w1"]))
    h = h * einsum("bsd,edf->bsef", x, p["w3"])
    if cfg.moe_fold_gates:
        hg = h * combine[..., None].to(h.dtype)
        return einsum("bsef,efd->bsd", hg, p["w2"]).to(x.dtype)
    y = einsum("bsef,efd->bsed", h, p["w2"])
    out = torch.einsum("bsed,bse->bsd", y.to(F32), combine)
    return out.to(x.dtype)


def moe_capacity(cfg, Tg):
    """Tokens per expert buffer of the gather dispatch for ``Tg`` tokens
    a group: ``round(capacity * k * Tg / E)`` (Python's ``round``, at
    least 1), rounded up to 128 and capped at ``Tg``."""
    C = max(1, int(round(cfg.moe_capacity * cfg.moe_top_k * Tg
                         / cfg.moe_experts)))
    return min(Tg, ((C + 127) // 128) * 128)


def moe_gather(x, p, cfg):
    """Sorted capacity dispatch (the reference's ``_moe_gather``): only
    the routed experts compute.  The ``B * S`` tokens form ``G =
    min(moe_groups, B)`` groups on a leading axis; in each, the (token,
    expert) pairs are sorted by expert (stable), each expert's first
    ``C`` (``moe_capacity``) pairs fill its buffer row by row and the
    rest go to a dump row ``E * C`` and are dropped; the expert outputs,
    scaled by their gates in float32, are added back to their tokens.
    The reference pins each group tensor to the data-parallel axes of
    its mesh; one card has no mesh, so there is nothing to pin."""
    B, S, D = x.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    G = max(1, min(cfg.moe_groups, B))
    Tg = B * S // G
    C = moe_capacity(cfg, Tg)
    dev = x.device
    xt = x.reshape(G, Tg, D)
    gates, idx = _route(xt, p["router"], k)                 # [G,Tg,k]
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
    h = F.silu(einsum("gecd,edf->gecf", buf, p["w1"]))
    h = h * einsum("gecd,edf->gecf", buf, p["w3"])
    y = einsum("gecf,efd->gecd", h, p["w2"]).reshape(G, E * C, D)
    y = torch.cat([y, torch.zeros(G, 1, D, dtype=y.dtype, device=dev)],
                  dim=1).reshape(G * (E * C + 1), D)
    contrib = y[rows.reshape(-1)].to(F32) * torch.where(
        keep, g_s, 0.0).reshape(-1, 1)
    out = torch.zeros(G * Tg, D, dtype=F32, device=dev)
    out.index_add_(0, tok_rows, contrib)
    return out.reshape(B, S, D).to(x.dtype)
