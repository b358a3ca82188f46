"""Row-batched gather/scatter helpers shared by the port's scheduler and
simulator modules.  Every tensor carries a leading row axis ``[R, ...]``;
indices are per row."""
from __future__ import annotations

import torch

NEG = -3e38          # float32 "minus infinity" sentinel of the reference


def take(x, idx):
    """``x[r, idx[r, j]]`` for ``x: [R, n]`` and ``idx: [R, m]``."""
    return torch.gather(x, 1, idx)


def scatter_or(n: int, idx, mask):
    """``bool[R, n]``: True at ``idx[r, j]`` wherever ``mask[r, j]`` —
    the reference's ``zeros(n, bool).at[idx].max(mask)``.  Masked-off
    entries go to an extra column that is sliced away, so ``idx`` only
    needs to be in range where ``mask`` holds."""
    R = idx.shape[0]
    out = torch.zeros(R, n + 1, dtype=torch.bool, device=idx.device)
    out.scatter_(1, torch.where(mask, idx, n), True)
    return out[:, :n]


def scatter_max(n: int, idx, values, init):
    """``full(n, init).at[idx].max(values)`` per row (float max is
    order-independent, so this is exact on any device)."""
    R = idx.shape[0]
    out = torch.full((R, n), init, dtype=values.dtype, device=idx.device)
    return out.scatter_reduce_(1, idx, values, "amax", include_self=True)


def scatter_min(n: int, idx, values, init):
    """``full(n, init).at[idx].min(values)`` per row."""
    R = idx.shape[0]
    out = torch.full((R, n), init, dtype=values.dtype, device=idx.device)
    return out.scatter_reduce_(1, idx, values, "amin", include_self=True)


def scatter_count(n: int, idx, mask):
    """``int64[R, n]``: how many ``mask`` entries land on each index
    (integer sums are exact in any order)."""
    R = idx.shape[0]
    out = torch.zeros(R, n, dtype=torch.int64, device=idx.device)
    return out.scatter_add_(1, idx, mask.long())


def as_rows(x, R: int, dtype, device):
    """A scalar or per-row value as a ``[R]`` tensor of ``dtype``."""
    t = torch.as_tensor(x, device=device)
    if t.dim() == 0:
        t = t.expand(R)
    return t.to(dtype).contiguous()


def fma32(a, b, c):
    """``round_f32(a * b + c)`` with a single rounding, for float32
    tensors — the fused multiply-add that the reference's compiler emits
    for ``c + a * b`` (the simulator's time advance and granularity, the
    waterfill's capacity update).  The product of two float32 values is
    exact in float64; where the float64 sum lands exactly on a float32
    rounding midpoint, its exact TwoSum error decides the direction, so
    the result is the correctly rounded one on every device."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bv = s - p
    err = (p - (s - bv)) + (cd - bv)
    r = s.float()
    d = s - r.double()
    other = torch.nextafter(r, torch.where(d > 0, float("inf"),
                                           float("-inf")).float())
    mid = (d != 0) & ((r.double() + other.double()) * 0.5 == s)
    fix = mid & (err != 0) & ((err > 0) == (d > 0))
    return torch.where(fix, other, r)
