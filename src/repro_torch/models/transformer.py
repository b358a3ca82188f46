"""Decoder stack of the LM slice: one ``nn.Module`` per layer in an
``nn.ModuleList``, the training forward pass and the serving entry
points.

* ``forward(model, tokens)``                     — full-sequence logits
  (training: differentiable, each layer checkpointed per ``cfg.remat``)
* ``prefill(model, tokens, cache_len=)``         — last-position logits
  + cache (under ``no_grad``)
* ``decode_step(model, tokens, cache, pos)``     — one token with a cache
  (under ``no_grad``)

Each layer carries its sliding window as a Python int, since the layer
loop is Python.  Parameters keep the reference package's layouts and
names (``layers.<i>.attn.wq`` is the reference's ``blocks/attn/wq[i]``),
so ``convert.params_from_jax`` is a copy.  ``impl`` picks the kernels
(``"auto"``: the CUDA kernels on the card, their plain versions on the
CPU; a gradient through a kernel is its plain version's, see
``kernels/ops.py``) or the plain versions everywhere (``"torch"``).
``cfg.remat`` follows the reference's ``_maybe_remat``: ``"none"``;
``"full"``, each layer recomputed in the backward pass
(``torch.utils.checkpoint.checkpoint``); ``"dots"``, the same but the
outputs of matrix products without batch dims kept (``aten.mm`` /
``addmm``, the reference's ``dots_with_no_batch_dims_saveable``).  Not
ported (each raises ``NotImplementedError``): MoE, cross-attention, the
vision and audio frontends, the int8 and ring KV caches.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from ..device import resolve_device
from .config import ModelConfig
from .layers import attention_block, check_attention_options, rms_norm, \
    swiglu, mm
from .ssm import mamba2_block, ssm_dims


def check_supported(cfg: ModelConfig):
    """Raise ``NotImplementedError`` for options this slice lacks."""
    missing = []
    if cfg.moe_experts:
        missing.append("MoE (moe_experts)")
    if cfg.cross_attn_every:
        missing.append("cross-attention (cross_attn_every)")
    if cfg.frontend != "none":
        missing.append(f"the {cfg.frontend} frontend")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported to repro_torch "
            f"yet (ROADMAP.md)")
    if not cfg.attn_free:
        check_attention_options(cfg)


def _params(shapes, dtype, device):
    return nn.ParameterDict({
        n: nn.Parameter(torch.empty(s, dtype=dt or dtype, device=device))
        for n, (s, dt) in shapes.items()})


class Layer(nn.Module):
    """One decoder layer: attention and/or Mamba-2 side by side, then the
    MLP.  Parameters are allocated on ``device``, not initialised."""

    def __init__(self, cfg: ModelConfig, window: int, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        f32, act = torch.float32, cfg.activation_dtype
        d = cfg.d_model
        self.cfg = cfg
        self.window = int(window)
        self.ln1 = nn.Parameter(torch.empty(d, dtype=f32, device=device))
        self.attn = self.ssm = self.mlp = self.ln2 = None
        if not cfg.attn_free:
            hq, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
            shapes = {"wq": ((d, hq, dh), None), "wk": ((d, hk, dh), None),
                      "wv": ((d, hk, dh), None), "wo": ((hq * dh, d), None)}
            if cfg.qk_norm:
                shapes.update(q_norm=((dh,), f32), k_norm=((dh,), f32))
            self.attn = _params(shapes, act, device)
        if cfg.ssm in ("mamba2", "hybrid"):
            di, ns, nh, hd = ssm_dims(cfg)
            C = di + 2 * ns
            self.ssm = _params({
                "in_proj": ((d, 2 * di + 2 * ns + nh), None),
                "conv_w": ((cfg.ssm_conv, C), f32), "conv_b": ((C,), f32),
                "A_log": ((nh,), f32), "D": ((nh,), f32),
                "dt_bias": ((nh,), f32), "norm": ((di,), f32),
                "out_proj": ((di, d), None)}, act, device)
        if cfg.d_ff > 0:
            self.ln2 = nn.Parameter(torch.empty(d, dtype=f32, device=device))
            self.mlp = _params({"w1": ((d, cfg.d_ff), None),
                                "w3": ((d, cfg.d_ff), None),
                                "w2": ((cfg.d_ff, d), None)}, act, device)

    def forward(self, x, positions, cache_pos, kv_len, cache, impl):
        cfg = self.cfg
        new_cache = {}
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        y = torch.zeros_like(x)
        if self.attn is not None:
            ya, kv = attention_block(
                h, self.attn, cfg, window=self.window, positions=positions,
                cache=None if cache is None else cache["kv"],
                cache_pos=cache_pos, kv_len=kv_len, impl=impl)
            y = y + ya
            if kv is not None:
                new_cache["kv"] = kv
        if self.ssm is not None:
            ys, sc = mamba2_block(h, self.ssm, cfg,
                                  cache=None if cache is None
                                  else cache["ssm"], impl=impl)
            y = y + ys
            if sc is not None:
                new_cache["ssm"] = sc
        x = x + y
        if self.mlp is not None:
            x = x + swiglu(rms_norm(x, self.ln2, cfg.norm_eps), self.mlp)
        return x, new_cache


class Transformer(nn.Module):
    """The decoder: embedding, ``layers`` (an ``nn.ModuleList``), final
    norm and LM head (absent when the embeddings are tied).  Parameters
    are allocated on ``device`` (default ``"cuda"``, which raises without
    a card), not initialised."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        check_supported(cfg)
        device = resolve_device(device)
        act, d, v = cfg.activation_dtype, cfg.d_model, cfg.vocab_size
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(v, d, dtype=act,
                                              device=device))
        self.layers = nn.ModuleList(
            Layer(cfg, cfg.layer_window(i), device)
            for i in range(cfg.n_layers))
        self.final_norm = nn.Parameter(torch.empty(d, dtype=torch.float32,
                                                   device=device))
        self.lm_head = None
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty(d, v, dtype=act,
                                                    device=device))


# ------------------------------------------------------------------ init
_CONSTANTS = {"ln1": 1.0, "ln2": 1.0, "final_norm": 1.0, "conv_b": 0.0,
              "A_log": 0.0, "D": 1.0, "dt_bias": -4.0, "norm": 1.0,
              "q_norm": 1.0, "k_norm": 1.0}


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Transformer:
    """A ``Transformer`` with the reference's initialisation: dense
    weights ``0.02 * normal`` drawn in float32 and cast to the
    activation type (``conv_w``: ``0.2 * normal``, float32); norms,
    ``D`` ones, ``A_log``, ``conv_b`` zeros, ``dt_bias`` -4.  The draws
    come from ``generator`` (on the same device), so they differ from
    the reference's ``jax.random`` draws."""
    dev = resolve_device(device)
    model = Transformer(cfg, device=dev)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _CONSTANTS:
            p.fill_(_CONSTANTS[leaf])
            continue
        scale = 0.2 if leaf == "conv_w" else 0.02
        w = torch.randn(p.shape, dtype=torch.float32, device=dev,
                        generator=generator)
        p.copy_((scale * w).to(p.dtype))
    return model


# --------------------------------------------------------------- caches
def make_cache(cfg: ModelConfig, batch_size: int, length: int, device,
               dtype=None):
    """Zero-initialised KV + SSM cache: one dict per layer."""
    dt = dtype or cfg.activation_dtype

    def layer_cache():
        c = {}
        if not cfg.attn_free:
            hk, dh = cfg.n_kv_heads, cfg.d_head
            c["kv"] = {
                "k": torch.zeros(batch_size, length, hk, dh, dtype=dt,
                                 device=device),
                "v": torch.zeros(batch_size, length, hk, dh, dtype=dt,
                                 device=device)}
        if cfg.ssm in ("mamba2", "hybrid"):
            di, ns, nh, hd = ssm_dims(cfg)
            c["ssm"] = {
                "conv": torch.zeros(batch_size, cfg.ssm_conv - 1,
                                    di + 2 * ns, dtype=dt, device=device),
                "state": torch.zeros(batch_size, nh, ns, hd,
                                     dtype=torch.float32, device=device)}
        return c

    return [layer_cache() for _ in range(cfg.n_layers)]


# ------------------------------------------------------------- forward
def _unembed(model, x):
    if model.lm_head is None:
        return mm(x, model.embed.t())
    return mm(x, model.lm_head)


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
REMATS = ("none", "full", "dots")


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep the outputs of products without batch dims, recompute the
    rest (the reference's ``dots_with_no_batch_dims_saveable``)."""
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return ckpt.create_selective_checkpoint_contexts(_dots_policy)


def remat(layer, cfg):
    """``layer`` wrapped per ``cfg.remat`` (when autograd records)."""
    if cfg.remat not in REMATS:
        raise ValueError(f"remat {cfg.remat!r} not in {REMATS}")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return layer
    kw = dict(context_fn=_dots_context) if cfg.remat == "dots" else {}
    # the layers draw no random numbers: no RNG state to restore
    return functools.partial(ckpt.checkpoint, layer, use_reentrant=False,
                             preserve_rng_state=False, **kw)


def forward(model: Transformer, tokens, cache=None, cache_pos: int = 0,
            impl="auto"):
    """tokens: [B, S] integer.  cache=None: full forward, differentiable
    when grad mode is on.  Otherwise prefill / decode with the list from
    ``make_cache`` (updated and returned).  Returns (logits [B, S, V],
    cache)."""
    cfg = model.cfg
    act = cfg.activation_dtype
    x = model.embed[tokens] * torch.tensor(cfg.d_model ** 0.5, dtype=act,
                                           device=tokens.device)
    B, S = tokens.shape
    kv_len = cache_pos + S if cache is not None else None
    positions = (cache_pos + torch.arange(S, device=tokens.device))[None, :]
    positions = positions.expand(B, S)
    for i, layer in enumerate(model.layers):
        if cache is None:
            x, _ = remat(layer, cfg)(x, positions, cache_pos, kv_len, None,
                                     impl)
        else:
            x, cache[i] = layer(x, positions, cache_pos, kv_len, cache[i],
                                impl)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return _unembed(model, x), cache


@torch.no_grad()
def prefill(model: Transformer, tokens, cache_len=None, impl="auto"):
    """Run the prompt; returns (last-position logits, cache, next_pos)."""
    cfg = model.cfg
    B, S = tokens.shape
    cache = make_cache(cfg, B, cache_len or cfg.max_cache_len or S,
                       tokens.device)
    logits, cache = forward(model, tokens, cache=cache, cache_pos=0,
                            impl=impl)
    return logits[:, -1:], cache, S


@torch.no_grad()
def decode_step(model: Transformer, tokens, cache, pos: int, impl="auto"):
    """One decode step.  tokens [B, 1]; pos: the Python int position."""
    logits, cache = forward(model, tokens, cache=cache, cache_pos=pos,
                            impl=impl)
    return logits, cache, pos + 1
