"""Prefill / decode step factories and the loss of the LM slice (the
train step waits for the training slice)."""
from __future__ import annotations

import torch

from .transformer import decode_step, prefill


def softmax_cross_entropy(logits, labels):
    """logits [..., V] (any dtype), labels [...] integer -> mean nll
    (float32)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)


def make_prefill_step(cache_len=None):
    def prefill_step(model, tokens):
        return prefill(model, tokens, cache_len=cache_len)
    return prefill_step


def make_decode_step():
    def serve_step(model, tokens, cache, pos):
        return decode_step(model, tokens, cache, pos)
    return serve_step
