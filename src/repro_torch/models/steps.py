"""Train / prefill / decode step factories and the loss of the LM slice
(``repro/models/steps.py``)."""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial

from ..kernels.ops import model_size, placements
from ..optim import clip_by_global_norm
from .config import ModelConfig
from .transformer import NO_POLICY, decode_step, forward, prefill

F32 = torch.float32


def _log_z_gold(logits, labels, lo=None):
    """``(logsumexp over the last dim, the label's logit)`` in float32;
    ``lo``: the logits hold the vocabulary from ``lo`` on, and a label
    outside them gives 0."""
    logits = logits.to(F32)
    logz = torch.logsumexp(logits, dim=-1)
    ids = labels.long()
    if lo is None:
        return logz, torch.gather(logits, -1, ids[..., None])[..., 0]
    hit = (ids >= lo) & (ids < lo + logits.shape[-1])
    gold = torch.gather(logits, -1, torch.where(hit, ids - lo, 0)[..., None])
    return logz, torch.where(hit, gold[..., 0], 0.0)


def _sharded_log_z_gold(logits, labels):
    """``_log_z_gold`` of DTensors: the batch over the data-parallel dims
    where it divides, the vocabulary over ``model`` where it divides.
    Each rank's log-sum-exp over its vocabulary rows is gathered over
    ``model`` and combined by one more log-sum-exp; the label's logit is
    a masked local gather whose partial sums are reduced."""
    from torch.distributed.tensor.experimental import local_map
    mesh = logits.device_mesh
    nd, B = labels.dim(), labels.shape[0]
    split = model_size(mesh) > 1 and logits.shape[-1] % model_size(mesh) == 0
    lab_pl = placements(mesh, B)
    pl = z_pl = placements(mesh, B, 0, nd if split else None)
    gold_pl = list(lab_pl)
    if split:
        gold_pl[mesh.mesh_dim_names.index("model")] = Partial()

    def local(lg, lab):
        lo = mesh.get_local_rank("model") * lg.shape[-1] if split else None
        logz, gold = _log_z_gold(lg, lab, lo)
        return logz[..., None], gold

    logz, gold = local_map(local, out_placements=(z_pl, gold_pl),
                           in_placements=(pl, lab_pl), device_mesh=mesh,
                           redistribute_inputs=True)(logits, labels)
    logz = local_map(lambda z: torch.logsumexp(z, dim=-1),
                     out_placements=lab_pl, in_placements=(lab_pl,),
                     device_mesh=mesh, redistribute_inputs=True)(logz)
    return logz, gold


def softmax_cross_entropy(logits, labels):
    """logits [..., V] (any dtype), labels [...] integer -> mean nll
    (float32).  DTensors (a placed model) take ``_sharded_log_z_gold``."""
    if isinstance(logits, DTensor):
        logz, gold = _sharded_log_z_gold(logits, labels)
    else:
        logz, gold = _log_z_gold(logits, labels)
    return torch.mean(logz - gold)


def make_loss_fn(cfg: ModelConfig, impl="auto", policy=NO_POLICY):
    """``loss_fn(model, batch)``: next-token cross entropy of
    ``batch["tokens"]``, ``[B, S]`` or, for the audio frontend, ``[B, S,
    K]`` against logits ``[B, S, K, V]`` (the mean over every position
    and codebook); the vision frontend reads ``batch["vision"] [B, T,
    d]``.  ``policy`` places the residual stream of a placed model."""
    def loss_fn(model, batch):
        tokens = batch["tokens"]
        logits, _ = forward(model, tokens, impl=impl,
                            vision=batch.get("vision"), policy=policy)
        return softmax_cross_entropy(logits[:, :-1], tokens[:, 1:])
    return loss_fn


def make_train_step(cfg: ModelConfig, optimizer, accum: int = 1,
                    clip_norm: float = 0.0, grad_compress: bool = False,
                    impl="auto", policy=NO_POLICY):
    """Returns ``train_step(model, opt_state, batch) -> {"loss",
    "grad_norm"}``; the model's parameters and ``opt_state`` are updated
    in place by ``optimizer.update(grads, opt_state, model)``.
    ``accum > 1`` splits the batch into microbatches run in sequence,
    each gradient added to a float32 accumulator as ``acc + g.f32 /
    accum``; ``grad_compress`` casts each microbatch's gradients to
    bfloat16 first; ``clip_norm > 0`` clips by the global norm before the
    update (``grad_norm`` is 0 otherwise).  A model placed on a mesh
    (DTensor parameters, ``policy`` its residual placement) gets DTensor
    gradients; the global norm is reduced across their shards."""
    loss_fn = make_loss_fn(cfg, impl, policy)

    def grads_of(model, params, batch):
        loss = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, params)
        if grad_compress:
            grads = [g.to(torch.bfloat16) for g in grads]
        return loss.detach(), grads

    def train_step(model, opt_state, batch):
        names, params = zip(*model.named_parameters())
        if accum <= 1:
            loss, grads = grads_of(model, params, batch)
        else:
            n = len(batch["tokens"])
            if n % accum:
                raise ValueError(f"batch of {n} does not split into "
                                 f"{accum} microbatches")
            mb = n // accum
            grads = [torch.zeros_like(p, dtype=F32) for p in params]
            losses = []
            for i in range(accum):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss, g_mb = grads_of(model, params, micro)
                for acc, g in zip(grads, g_mb):
                    acc.add_(g.to(F32) / accum)
                losses.append(loss)
            loss = torch.mean(torch.stack(losses))
        grads = dict(zip(names, grads))
        if clip_norm > 0:
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
        else:
            gnorm = torch.zeros((), dtype=F32)
        optimizer.update(grads, opt_state, model)
        return {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_prefill_step(cache_len=None, policy=NO_POLICY):
    def prefill_step(model, tokens, vision=None):
        return prefill(model, tokens, cache_len=cache_len, vision=vision,
                       policy=policy)
    return prefill_step


def make_decode_step(policy=NO_POLICY):
    def serve_step(model, tokens, cache, pos):
        return decode_step(model, tokens, cache, pos, policy=policy)
    return serve_step
