"""Decoder stack of the LM stack: one ``nn.Module`` per layer in an
``nn.ModuleList``, the training forward pass and the serving entry
points, for all ten architecture families of the reference registry.

* ``forward(model, tokens, vision=)``            — full-sequence logits
  (training: differentiable, each layer checkpointed per ``cfg.remat``)
* ``prefill(model, tokens, cache_len=, vision=)`` — last-position logits
  + cache (under ``no_grad``)
* ``decode_step(model, tokens, cache, pos)``     — one token with a cache
  (under ``no_grad``)

``tokens`` is ``[B, S]``, or ``[B, S, K]`` for the audio frontend
(``K`` codebooks, logits ``[B, S, K, V]``); ``vision [B, T, d]`` is the
vision stub's encoder states, read by the cross-attention layers.
Self-attention layers (``layers``) carry their sliding window as a
Python int, since the layer loop is Python; a vision model runs groups
of ``cross_attn_every - 1`` of them, then one cross-attention layer
(``cross_layers``), as the reference's two-level scan does.  Parameters
keep the reference package's layouts and names (``layers.<i>.attn.wq``
is the reference's ``blocks/attn/wq[i]``, ``cross_layers.<g>.attn.wq``
its ``cross_blocks/attn/wq[g]``), so ``convert.params_from_jax`` is a
copy.  The run-time options (the KV cache type, the ring cache, the MoE
dispatch, remat) are read from ``model.cfg`` on every call, so they can
be changed on the same weights with ``dataclasses.replace``.  ``impl``
picks the kernels (``"auto"``: the CUDA kernels on the card, their plain
versions on the CPU; a gradient through a kernel is its plain
version's, see ``kernels/ops.py``) or the plain versions everywhere
(``"torch"``).  ``cfg.remat`` follows the reference's ``_maybe_remat``:
``"none"``; ``"full"``, each layer recomputed in the backward pass
(``torch.utils.checkpoint.checkpoint``); ``"dots"``, the same but the
outputs of matrix products without batch dims kept (``aten.mm`` /
``addmm``, the reference's ``dots_with_no_batch_dims_saveable``).

A model whose parameters are DTensors (``params.place_model``) runs on
their mesh: the entry points take a ``ShardingPolicy`` that places the
residual stream at the reference's four sites (after the embedding,
after each layer's mixer and MLP, after each cross layer); the cache
is placed by ``params.place_cache`` and the kernels' calls follow the
mesh (``kernels/ops.py``).  With ``NO_POLICY`` and plain tensors
nothing changes.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils import checkpoint as ckpt

from ..device import resolve_device
from ..kernels.ops import sharded_dims, with_partial
from .config import ModelConfig
from .layers import attention_block, einsum, mm, moe_block, rms_norm, \
    swiglu
from .params import axis_sizes, place_cache, to_placements
from .ssm import mamba2_block, ssm_dims


# ------------------------------------------------------------- sharding
@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """Residual-stream placement policy (``mesh=None``: none).
    ``batch_axes``: the mesh dims the batch is split over (e.g.
    ``("pod", "data")``); ``seq_axis``: the dim the sequence is split
    over between layers (sequence parallelism, e.g. ``"model"``)."""
    mesh: object = None             # torch DeviceMesh
    batch_axes: tuple = ()
    seq_axis: Optional[str] = None

    def spec(self, shape):
        """The residual's spec: batch over ``batch_axes`` and sequence
        over ``seq_axis``, each where it divides (the reference's
        conditions)."""
        sizes = axis_sizes(self.mesh)
        spec = [None] * len(shape)
        bsz = math.prod(sizes[a] for a in self.batch_axes)
        if self.batch_axes and bsz > 1 and shape[0] % bsz == 0:
            spec[0] = (self.batch_axes if len(self.batch_axes) > 1
                       else self.batch_axes[0])
        ssz = sizes.get(self.seq_axis, 1) if self.seq_axis else 1
        if len(shape) >= 3 and ssz > 1 and shape[1] % ssz == 0:
            spec[1] = self.seq_axis
        return tuple(spec)

    def constrain(self, x):
        """``x`` redistributed to ``spec``; a plain tensor passes only
        without a mesh."""
        if self.mesh is None or x.dim() < 2:
            return x
        if not isinstance(x, DTensor):
            raise TypeError("a ShardingPolicy with a mesh needs DTensor "
                            "activations: place the model and its inputs "
                            "first (models.params)")
        return x.redistribute(self.mesh,
                              to_placements(self.mesh, self.spec(x.shape)))


NO_POLICY = ShardingPolicy()


def n_cross_layers(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.cross_attn_every if cfg.cross_attn_every \
        else 0


def self_layer_windows(cfg: ModelConfig):
    """Window per *self* layer (cross layers removed from the
    pattern)."""
    k = cfg.cross_attn_every
    return [w for i, w in enumerate(cfg.window_pattern())
            if not k or (i + 1) % k != 0]


def layer_order(cfg: ModelConfig):
    """``(cross, index)`` of each layer in the order the forward pass
    runs them: every self layer, or, with cross-attention, groups of
    ``cross_attn_every - 1`` self layers each followed by one cross
    layer."""
    n_cross = n_cross_layers(cfg)
    if not n_cross:
        return [(False, i) for i in range(cfg.n_layers)]
    per = cfg.cross_attn_every - 1
    return [item for g in range(n_cross)
            for item in [(False, g * per + j) for j in range(per)]
            + [(True, g)]]


def _params(shapes, dtype, device):
    return nn.ParameterDict({
        n: nn.Parameter(torch.empty(s, dtype=dt or dtype, device=device))
        for n, (s, dt) in shapes.items()})


def _attn_params(cfg, device, cross=False):
    f32 = torch.float32
    d, hq, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    shapes = {"wq": ((d, hq, dh), None), "wk": ((d, hk, dh), None),
              "wv": ((d, hk, dh), None), "wo": ((hq * dh, d), None)}
    if cfg.qk_norm:
        shapes.update(q_norm=((dh,), f32), k_norm=((dh,), f32))
    if cross:
        shapes.update(gate=((), f32))
    return _params(shapes, cfg.activation_dtype, device)


class Layer(nn.Module):
    """One decoder layer: attention and/or Mamba-2 side by side, then the
    MLP or the MoE block.  Parameters are allocated on ``device``, not
    initialised."""

    def __init__(self, cfg: ModelConfig, window: int, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        f32, act = torch.float32, cfg.activation_dtype
        d = cfg.d_model
        self.window = int(window)
        self.ln1 = nn.Parameter(torch.empty(d, dtype=f32, device=device))
        self.attn = self.ssm = self.mlp = self.moe = self.ln2 = None
        if not cfg.attn_free:
            self.attn = _attn_params(cfg, device)
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
            E, f = cfg.moe_experts, cfg.d_ff
            if E:
                self.moe = _params({"router": ((d, E), f32),
                                    "w1": ((E, d, f), None),
                                    "w3": ((E, d, f), None),
                                    "w2": ((E, f, d), None)}, act, device)
            else:
                self.mlp = _params({"w1": ((d, f), None),
                                    "w3": ((d, f), None),
                                    "w2": ((f, d), None)}, act, device)

    def forward(self, x, positions, cache_pos, kv_len, cache, impl, cfg,
                policy=NO_POLICY):
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
        x = policy.constrain(x + y)
        if self.mlp is not None:
            x = x + swiglu(rms_norm(x, self.ln2, cfg.norm_eps), self.mlp)
        elif self.moe is not None:
            x = x + moe_block(rms_norm(x, self.ln2, cfg.norm_eps), self.moe,
                              cfg, policy)
        return policy.constrain(x), new_cache


class CrossLayer(nn.Module):
    """One cross-attention layer of the vision family (the reference's
    ``cross_block``): ln1 and gated cross-attention over the vision
    input, no MLP."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.ln1 = nn.Parameter(torch.empty(cfg.d_model,
                                            dtype=torch.float32,
                                            device=device))
        self.attn = _attn_params(cfg, device, cross=True)

    def forward(self, x, vision, cache, impl, cfg, policy=NO_POLICY):
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        y, kv = attention_block(
            h, self.attn, cfg, window=0, is_cross=True, kv_source=vision,
            cache=None if cache is None else cache["kv"], impl=impl)
        return policy.constrain(x + y), ({} if kv is None else {"kv": kv})


class Transformer(nn.Module):
    """The decoder: embedding (``[V, d]``, audio ``[K, V, d]``),
    ``layers`` (an ``nn.ModuleList`` of the self layers),
    ``cross_layers`` (the vision family's cross layers; empty
    otherwise), final norm and LM head (``[d, V]``, audio
    ``[K, d, V]``; absent when the embeddings are tied).  Parameters
    are allocated on ``device`` (default ``"cuda"``, which raises without
    a card), not initialised."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        act, d, v = cfg.activation_dtype, cfg.d_model, cfg.vocab_size
        audio = (cfg.codebooks,) if cfg.frontend == "audio" else ()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(*audio, v, d, dtype=act,
                                              device=device))
        self.layers = nn.ModuleList(
            Layer(cfg, w, device) for w in self_layer_windows(cfg))
        self.cross_layers = nn.ModuleList(
            CrossLayer(cfg, device) for _ in range(n_cross_layers(cfg)))
        self.final_norm = nn.Parameter(torch.empty(d, dtype=torch.float32,
                                                   device=device))
        self.lm_head = None
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty(*audio, d, v, dtype=act,
                                                    device=device))


# ------------------------------------------------------------------ init
_CONSTANTS = {"ln1": 1.0, "ln2": 1.0, "final_norm": 1.0, "conv_b": 0.0,
              "A_log": 0.0, "D": 1.0, "dt_bias": -4.0, "norm": 1.0,
              "q_norm": 1.0, "k_norm": 1.0, "gate": 0.0}


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Transformer:
    """A ``Transformer`` with the reference's initialisation: dense
    weights ``0.02 * normal`` drawn in float32 and cast to the
    activation type (``conv_w``: ``0.2 * normal``, float32; the MoE
    router float32); norms, ``D`` ones, ``A_log``, ``conv_b`` and the
    cross layers' ``gate`` zeros, ``dt_bias`` -4.  The draws come from
    ``generator`` (on the same device), one parameter at a time, so
    they differ from the reference's ``jax.random`` draws."""
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
        # in place, and freed before the next draw: one float32
        # temporary at a time (3.1 GB for qwen3-32b's embedding)
        p.copy_(w.mul_(scale))
        del w
    return model


# --------------------------------------------------------------- caches
def make_cache(cfg: ModelConfig, batch_size: int, length: int, device,
               dtype=None):
    """Zero-initialised caches, one dict per layer in the order of
    ``layer_order``: a self layer's KV cache ``[B, length, Hk, dh]``
    (int8 with float32 ``k_scale``/``v_scale [B, length, Hk, 1]`` under
    ``kv_cache_dtype="int8"``) and SSM state; a cross layer's keys and
    values of the vision input ``[B, cross_tokens, Hk, dh]``."""
    dt = dtype or cfg.activation_dtype
    hk, dh = cfg.n_kv_heads, cfg.d_head

    def zeros(*shape, dtype=dt):
        return torch.zeros(batch_size, *shape, dtype=dtype, device=device)

    def self_cache():
        c = {}
        if not cfg.attn_free:
            if cfg.kv_cache_dtype == "int8":
                c["kv"] = {
                    "k": zeros(length, hk, dh, dtype=torch.int8),
                    "v": zeros(length, hk, dh, dtype=torch.int8),
                    "k_scale": zeros(length, hk, 1, dtype=torch.float32),
                    "v_scale": zeros(length, hk, 1, dtype=torch.float32)}
            else:
                c["kv"] = {"k": zeros(length, hk, dh),
                           "v": zeros(length, hk, dh)}
        if cfg.ssm in ("mamba2", "hybrid"):
            di, ns, nh, hd = ssm_dims(cfg)
            c["ssm"] = {
                "conv": zeros(cfg.ssm_conv - 1, di + 2 * ns),
                "state": zeros(nh, ns, hd, dtype=torch.float32)}
        return c

    def cross_cache():
        return {"kv": {"k": zeros(cfg.cross_tokens, hk, dh),
                       "v": zeros(cfg.cross_tokens, hk, dh)}}

    return [cross_cache() if cross else self_cache()
            for cross, _ in layer_order(cfg)]


# ------------------------------------------------------------- forward
def _lookup(table, tokens, audio, lo=None):
    """``table[tokens]`` (audio: the sum over the codebooks, k = 0..K-1
    in order, of ``table[k][tokens[..., k]]``).  ``lo``: the table holds
    only the vocabulary rows from ``lo`` on, and ids outside them give
    zeros."""
    def rows(t, ids):
        if lo is None:
            return t[ids]
        n = t.shape[0]
        hit = (ids >= lo) & (ids < lo + n)
        return torch.where(hit[..., None], t[torch.where(hit, ids - lo, 0)],
                           0)
    if not audio:
        return rows(table, tokens)
    x = rows(table[0], tokens[..., 0])
    for k in range(1, table.shape[0]):
        x = x + rows(table[k], tokens[..., k])
    return x


def _sharded_embed(model, tokens):
    """The lookup on a placed ``embed``: the table gathered over the
    data-parallel dims (ZeRO-3), kept split over ``model``.  A vocab
    split is a masked local lookup whose partial sums the next
    placement reduces; a d_model split gives the local columns."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    table = model.embed
    mesh = table.device_mesh
    audio = model.cfg.frontend == "audio"
    v_dim = 1 if audio else 0
    names = mesh.mesh_dim_names
    t_pl = [Replicate()] * mesh.ndim
    out_pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
              for p in tokens.placements]
    tok_pl = list(out_pl)
    split = None
    if "model" in names:
        mi = names.index("model")
        p = table.placements[mi]
        if isinstance(p, Shard):
            t_pl[mi] = p
            split = "vocab" if p.dim == v_dim else "d"
            out_pl[mi] = Partial() if split == "vocab" else Shard(
                tokens.dim() - (1 if audio else 0))

    def local(tl, ids):
        lo = None
        if split == "vocab":
            lo = mesh.get_local_rank("model") * tl.shape[v_dim]
        return _lookup(tl, ids, audio, lo)

    # each data-parallel rank's rows give a partial gradient of the table
    t_grad = with_partial(t_pl, sharded_dims(tok_pl))
    return local_map(local, out_placements=out_pl,
                     in_placements=(t_pl, tok_pl),
                     in_grad_placements=(t_grad, tok_pl), device_mesh=mesh,
                     redistribute_inputs=True)(table, tokens)


def _embed(model, tokens):
    if isinstance(model.embed, DTensor):
        return _sharded_embed(model, tokens)
    return _lookup(model.embed, tokens, model.cfg.frontend == "audio")


def _unembed(model, x):
    audio = model.cfg.frontend == "audio"
    if model.lm_head is None:
        if audio:
            return einsum("bsd,kvd->bskv", x, model.embed)
        return mm(x, model.embed.t())
    if audio:
        return einsum("bsd,kdv->bskv", x, model.lm_head)
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


def _local_device(t):
    return t.to_local().device if isinstance(t, DTensor) else t.device


def _keep_placements(new, old):
    """A layer's new cache with each DTensor placed as the one it
    replaces (the reference's ``out_shardings`` of the cache)."""
    if isinstance(new, dict):
        return {k: _keep_placements(v, old[k]) for k, v in new.items()}
    if isinstance(new, DTensor) and new.placements != old.placements:
        return new.redistribute(old.device_mesh, old.placements)
    return new


def forward(model: Transformer, tokens, cache=None, cache_pos: int = 0,
            impl="auto", vision=None, policy: ShardingPolicy = NO_POLICY):
    """tokens: [B, S] integer ([B, S, K] audio); ``vision``: [B, T, d]
    (vision family; at decode the cross layers read their cache).
    cache=None: full forward, differentiable when grad mode is on.
    Otherwise prefill / decode with the list from ``make_cache``
    (updated and returned).  ``policy`` places the residual stream of
    a model on a mesh.  Returns (logits [B, S, V] ([B, S, K, V] audio),
    cache)."""
    cfg = model.cfg
    act = cfg.activation_dtype
    dev = _local_device(tokens)
    x = _embed(model, tokens) * torch.tensor(cfg.d_model ** 0.5, dtype=act,
                                             device=dev)
    x = policy.constrain(x)
    B, S = tokens.shape[:2]
    kv_len = cache_pos + S if cache is not None else None
    positions = (cache_pos + torch.arange(S, device=dev))[None, :]
    positions = positions.expand(B, S)
    for i, (cross, j) in enumerate(layer_order(cfg)):
        c = None if cache is None else cache[i]
        if cross:
            layer = model.cross_layers[j]
            args = (x, vision, c, impl, cfg, policy)
        else:
            layer = model.layers[j]
            args = (x, positions, cache_pos, kv_len, c, impl, cfg, policy)
        if cache is None:
            x, _ = remat(layer, cfg)(*args)
        else:
            x, new = layer(*args)
            cache[i] = _keep_placements(new, c)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return _unembed(model, x), cache


@torch.no_grad()
def prefill(model: Transformer, tokens, cache_len=None, impl="auto",
            vision=None, policy: ShardingPolicy = NO_POLICY):
    """Run the prompt; returns (last-position logits, cache, next_pos).
    DTensor ``tokens`` (a placed model) need ``policy``'s mesh: the
    cache is made as local shards placed by ``params.cache_pspecs``
    over ``policy.batch_axes``."""
    cfg = model.cfg
    B, S = tokens.shape[:2]
    length = cache_len or cfg.max_cache_len or S
    if isinstance(tokens, DTensor):
        if policy.mesh is None:
            raise ValueError("prefill of DTensor tokens needs a "
                             "ShardingPolicy with their mesh")
        cache = place_cache(cfg, make_cache(cfg, B, length, "meta"),
                            policy.mesh, policy.batch_axes,
                            device=_local_device(tokens))
    else:
        cache = make_cache(cfg, B, length, tokens.device)
    logits, cache = forward(model, tokens, cache=cache, cache_pos=0,
                            impl=impl, vision=vision, policy=policy)
    return logits[:, -1:], cache, S


@torch.no_grad()
def decode_step(model: Transformer, tokens, cache, pos: int, impl="auto",
                policy: ShardingPolicy = NO_POLICY):
    """One decode step.  tokens [B, 1] ([B, 1, K] audio); pos: the Python
    int position."""
    logits, cache = forward(model, tokens, cache=cache, cache_pos=pos,
                            impl=impl, policy=policy)
    return logits, cache, pos + 1
