"""AdamW with the reference package's arithmetic (``repro/optim/adam.py``):
parameters in their own dtype (bfloat16 in a bfloat16 model), moments in
float32, bias correction ``m / (1 - b1**step)``, decoupled weight decay
added to the update, ``new_p = (p.f32 - lr * u).to(p.dtype)``, and the
warmup + cosine schedule in float32.  ``torch.optim.AdamW`` forms the
decay and the bias correction otherwise, so it is not used.

PyTorch idiom: ``init(model)`` returns an ``AdamState`` whose moments
are keyed by parameter name (``model.named_parameters()``), and
``update(grads, state, model)`` writes the parameters and moments in
place.  The step count is an int32 scalar on the host, so the schedule
costs no device read.  Gradient accumulation and bf16 gradient
compression live in the train step (``models/steps.py``).

A model placed on a mesh has DTensor parameters: each moment is made in
its parameter's placement, and a gradient whose data-parallel sum is
still pending (``Partial``, as autograd returns it; cast to bfloat16
first under gradient compression) is reduced into that placement
before the update.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

F32 = torch.float32


class AdamState(NamedTuple):
    step: torch.Tensor    # int32 scalar, on the host
    m: dict               # name -> float32 tensor like the parameter
    v: dict


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    warmup_steps: int = 0
    decay_steps: int = 0          # cosine decay horizon (0 = constant)

    def init(self, model) -> AdamState:
        m = {n: torch.zeros_like(p, dtype=F32)
             for n, p in model.named_parameters()}
        return AdamState(step=torch.zeros((), dtype=torch.int32), m=m,
                         v={n: t.clone() for n, t in m.items()})

    def schedule(self, step: int) -> np.float32:
        """The learning rate at ``step``, in float32 as the reference
        forms it."""
        f = np.float32
        lr = f(self.lr)
        if self.warmup_steps:
            lr = lr * min(f(1.0), f(step + 1) / f(self.warmup_steps))
        if self.decay_steps:
            t = f(step - self.warmup_steps) / f(
                max(1, self.decay_steps - self.warmup_steps))
            t = min(max(t, f(0.0)), f(1.0))
            lr = lr * f(0.5) * (f(1.0) + np.cos(f(np.pi) * t))
        return f(lr)

    @torch.no_grad()
    def update(self, grads, state: AdamState, model) -> AdamState:
        """One step: ``grads`` maps each parameter name to its gradient.
        Writes the parameters, ``state.m``, ``state.v`` and
        ``state.step`` in place and returns ``state``."""
        state.step.add_(1)
        step = int(state.step)
        lr = float(self.schedule(step))
        b1, b2 = self.b1, self.b2
        f = np.float32
        bc1 = float(f(1.0) - f(b1) ** f(step))
        bc2 = float(f(1.0) - f(b2) ** f(step))
        for name, p in model.named_parameters():
            m, v = state.m[name], state.v[name]
            g = grads[name]
            if isinstance(g, DTensor) and g.placements != m.placements:
                g = g.redistribute(m.device_mesh, m.placements)
            g = g.to(F32)
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            p32 = p.to(F32)
            if self.weight_decay:
                u = u + self.weight_decay * p32
            p.copy_((p32 - lr * u).to(p.dtype))
        return state


def global_norm(grads):
    """``sqrt(sum |g|^2)`` over a dict (or iterable) of gradients, in
    float32."""
    leaves = grads.values() if isinstance(grads, dict) else grads
    return torch.sqrt(sum(torch.sum(torch.square(g.to(F32)))
                          for g in leaves))


def clip_by_global_norm(grads, max_norm):
    """``(clipped, norm)``: every gradient scaled by ``min(1, max_norm /
    (norm + 1e-9))`` in float32, back in its own dtype."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {n: (g.to(F32) * scale).to(g.dtype)
            for n, g in grads.items()}, norm
