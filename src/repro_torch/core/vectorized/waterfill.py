"""Max-min fairness by progressive filling, batched over rows — the plain
PyTorch version of the port's max-min solver (counterpart of
``repro.core.vectorized.waterfill``).

Each row is one simulation's flow set: ``F`` flows over ``2W``
resources, ``r in [0, W)`` the upload capacity of worker r and
``r in [W, 2W)`` the download capacity of worker ``r - W``.  Flow ``f``
uses resources ``src[f]`` and ``W + dst[f]``.

Every round counts the live flows per resource, takes each resource's
share ``cap / count`` and the row's minimal share, freezes every live
flow that touches a resource at that share, and subtracts the capacity
they use.  Counts and ``used`` are integer-valued float32 sums
(``scatter_add_``), exact in any order, the division is IEEE, and the
capacity update ``cap - min_share * used`` is rounded once, as the
fused multiply-add the reference's compiler emits (``_ops.fma32``), so
the result is bitwise reproducible — it is the reference the CUDA
kernel (``repro_torch.kernels.waterfill``) is held against.

A row stops when it has no live flow; ``max_rounds`` (default ``2W``)
bounds the loop for every row.  Finished rows are frozen with
``torch.where``, as a batched ``while_loop`` would.
"""
from __future__ import annotations

import torch

from ._ops import fma32

INF = float("inf")


def waterfill(src, dst, active, caps_up, caps_down, max_rounds=None, *,
              sync=True):
    """Max-min rates for batched flow sets.

    Args:
      src, dst: int[R, F] worker indices per flow (or int[F]).
      active:   bool[R, F] flows currently transferring.
      caps_up, caps_down: f32[R, W] per-worker capacities (bytes/s).
      max_rounds: filling rounds bound (defaults to 2W).
      sync: stop once the host reads that no row has a live flow;
        ``False`` runs all ``max_rounds`` rounds without reading the
        host (for a CUDA graph), with the same result.

    Returns: f32[R, F] rates (0 for inactive flows); ``[F]`` for
    unbatched input.
    """
    return waterfill_rounds(src, dst, active, caps_up, caps_down,
                            max_rounds, sync=sync)[0]


def waterfill_rounds(src, dst, active, caps_up, caps_down, max_rounds=None,
                     *, sync=True):
    """``(rates, rounds)``: the rates of ``waterfill`` and the filling
    rounds each row took (int64 ``[R]``, or a scalar tensor for
    unbatched input) — the work a row's solve needs, one round per
    distinct bottleneck level."""
    unbatched = src.dim() == 1
    if unbatched:
        src, dst, active, caps_up, caps_down = (
            x.unsqueeze(0) for x in (src, dst, active, caps_up, caps_down))
    R, F = src.shape
    W = caps_up.shape[-1]
    if max_rounds is None:
        max_rounds = 2 * W
    res_u = src.long()                     # resource ids used by each flow
    res_d = dst.long() + W
    active = active.bool()
    cap = torch.cat([caps_up, caps_down], dim=1).float()
    rates = torch.zeros(R, F, dtype=torch.float32, device=src.device)
    frozen = ~active
    row_live = active.any(dim=1)
    row_rounds = torch.zeros(R, dtype=torch.int64, device=src.device)
    rounds = 0
    # the host reads row_live once per round: rounds are few (a freeze
    # per distinct bottleneck share) and this is the reference path.
    # Without it every round runs; a row with no live flow is frozen.
    while rounds < max_rounds and (not sync or bool(row_live.any())):
        live = active & ~frozen
        livef = live.float()
        counts = torch.zeros(R, 2 * W, dtype=torch.float32,
                             device=src.device)
        counts.scatter_add_(1, res_u, livef).scatter_add_(1, res_d, livef)
        share = torch.where(counts > 0, cap / counts.clamp(min=1.0), INF)
        # idle resources carry inf shares and never win the min; a row
        # with no live flow is frozen below, so its inf min is unused
        min_share = share.amin(dim=1, keepdim=True)
        # the reference writes min_share * (1.0 + 1e-9); in float32
        # that factor rounds to exactly 1.0, so the test is share <= min
        is_bn = (share <= min_share) & (counts > 0)
        freeze = live & (is_bn.gather(1, res_u) | is_bn.gather(1, res_d))
        freezef = freeze.float()
        used = torch.zeros(R, 2 * W, dtype=torch.float32, device=src.device)
        used.scatter_add_(1, res_u, freezef).scatter_add_(1, res_d, freezef)
        rl = row_live.unsqueeze(1)
        rates = torch.where(freeze & rl, min_share, rates)
        # one rounding, as the reference's contracted multiply-add
        left = fma32(-min_share, used, cap)
        cap = torch.where(rl, left.clamp(min=0.0), cap)
        frozen = frozen | (freeze & rl)
        row_rounds += row_live
        row_live = (active & ~frozen).any(dim=1)
        rounds += 1
    if unbatched:
        return rates[0], row_rounds[0]
    return rates, row_rounds


def waterfill_simple(active, bandwidth):
    """The 'simple' netmodel: every active flow at full bandwidth.
    ``bandwidth`` is a scalar or one value per row (``[R]``)."""
    bw = torch.as_tensor(bandwidth, dtype=torch.float32,
                         device=active.device)
    if bw.dim() == 1 and active.dim() == 2:
        bw = bw.unsqueeze(1)
    return torch.where(active.bool(), bw, torch.zeros((), device=bw.device))
