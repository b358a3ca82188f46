"""Shared neural layers of the LM stack: norms, RoPE, self-attention with
a KV cache, and the SwiGLU MLP.

Parameters keep the reference package's layouts (``wq [d, Hq, dh]``,
``wo [Hq*dh, d]``, ``w1 [d, f]`` ...).  Products follow the reference's
type promotion: an operand pair of bfloat16 and float32 is computed in
float32 (``mm``), as the reference's einsums promote.  Not ported (each
raises ``NotImplementedError``): the int8 KV cache, the ring KV cache
for sliding windows, cross-attention and the MoE block.
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
def check_attention_options(cfg):
    """Raise for the attention options the port does not have yet."""
    if cfg.kv_cache_dtype != "none":
        raise NotImplementedError(
            f"kv_cache_dtype={cfg.kv_cache_dtype!r} (the int8 KV cache) is "
            f"not ported to repro_torch yet (ROADMAP.md)")
    if cfg.window_ring_cache:
        raise NotImplementedError(
            "window_ring_cache (the ring KV cache for sliding windows) is "
            "not ported to repro_torch yet (ROADMAP.md)")


def attention_block(x, p, cfg, *, window, positions, cache=None,
                    cache_pos=0, kv_len=None, impl="auto"):
    """GQA self-attention with an optional KV cache.

    x: [B, S, D]; ``window``: this layer's sliding window (Python int,
    0 = full); ``cache``: dict(k=[B, Sc, Hk, dh], v=...) or None, written
    in place at ``cache_pos``; ``kv_len``: valid cache length after the
    write.  Returns (out [B, S, D], cache).
    """
    check_attention_options(cfg)
    B, S, D = x.shape
    hq, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = mm(x, p["wq"].reshape(D, hq * dh)).reshape(B, S, hq, dh)
    k = mm(x, p["wk"].reshape(D, hk * dh)).reshape(B, S, hk, dh)
    v = mm(x, p["wv"].reshape(D, hk * dh)).reshape(B, S, hk, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_style)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_style)
    if cache is not None:
        L_cache = cache["k"].shape[1]
        if cache_pos + S > L_cache:
            raise ValueError(f"KV cache of {L_cache} positions cannot take "
                             f"{S} more at {cache_pos}")
        # in place: the cache is written once per position, never copied
        cache["k"][:, cache_pos:cache_pos + S] = k
        cache["v"][:, cache_pos:cache_pos + S] = v
        k, v = cache["k"], cache["v"]
    out = ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=True, window=window,
                        kv_len=kv_len, impl=impl)           # [B,Hq,S,dh]
    out = out.transpose(1, 2).reshape(B, S, hq * dh)
    out = mm(out, p["wo"])
    return out.to(x.dtype), cache


# ------------------------------------------------------------------- MLP
def swiglu(x, p):
    h = F.silu(mm(x, p["w1"]))
    h = h * mm(x, p["w3"])
    return mm(h, p["w2"]).to(x.dtype)
