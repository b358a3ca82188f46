"""Train / prefill / decode step factories and the loss of the LM slice
(``repro/models/steps.py``)."""
from __future__ import annotations

import torch

from ..optim import clip_by_global_norm
from .config import ModelConfig
from .transformer import decode_step, forward, prefill

F32 = torch.float32


def softmax_cross_entropy(logits, labels):
    """logits [..., V] (any dtype), labels [...] integer -> mean nll
    (float32)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)


def make_loss_fn(cfg: ModelConfig, impl="auto"):
    """``loss_fn(model, batch)``: next-token cross entropy of
    ``batch["tokens"]``, ``[B, S]`` or, for the audio frontend, ``[B, S,
    K]`` against logits ``[B, S, K, V]`` (the mean over every position
    and codebook); the vision frontend reads ``batch["vision"] [B, T,
    d]``."""
    def loss_fn(model, batch):
        tokens = batch["tokens"]
        logits, _ = forward(model, tokens, impl=impl,
                            vision=batch.get("vision"))
        return softmax_cross_entropy(logits[:, :-1], tokens[:, 1:])
    return loss_fn


def make_train_step(cfg: ModelConfig, optimizer, accum: int = 1,
                    clip_norm: float = 0.0, grad_compress: bool = False,
                    impl="auto"):
    """Returns ``train_step(model, opt_state, batch) -> {"loss",
    "grad_norm"}``; the model's parameters and ``opt_state`` are updated
    in place by ``optimizer.update(grads, opt_state, model)``.
    ``accum > 1`` splits the batch into microbatches run in sequence,
    each gradient added to a float32 accumulator as ``acc + g.f32 /
    accum``; ``grad_compress`` casts each microbatch's gradients to
    bfloat16 first; ``clip_norm > 0`` clips by the global norm before the
    update (``grad_norm`` is 0 otherwise)."""
    loss_fn = make_loss_fn(cfg, impl)

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
            grads = [torch.zeros(p.shape, dtype=F32, device=p.device)
                     for p in params]
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


def make_prefill_step(cache_len=None):
    def prefill_step(model, tokens, vision=None):
        return prefill(model, tokens, cache_len=cache_len, vision=vision)
    return prefill_step


def make_decode_step():
    def serve_step(model, tokens, cache, pos):
        return decode_step(model, tokens, cache, pos)
    return serve_step
