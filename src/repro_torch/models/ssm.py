"""Mamba-2 (SSD) block: in_proj -> short depthwise conv -> selective SSD
-> gated RMSNorm -> out_proj.  [Dao & Gu 2024, arXiv:2405.21060]

The training forward pass and prefill run the chunked SSD scan (K3 on
the card, its plain version on the CPU; in training the gradient goes
through the plain version), and prefill also hands the final state to
decode; decode advances the closed-form single-step recurrence in plain
PyTorch with a carried (conv window, ssm state) cache.  Types follow
the reference: the conv with its float32 weights promotes the SSD
inputs to float32, so the scan runs in float32 even in a bfloat16
model.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard

from ..kernels import ops
from .layers import like, merge_heads, mm, rms_norm, split_heads

F32 = torch.float32


def ssm_dims(cfg):
    di = cfg.d_inner
    ns = cfg.ssm_state
    nh = cfg.ssm_heads
    hd = cfg.ssm_head_dim
    assert nh * hd == di, (nh, hd, di)
    return di, ns, nh, hd


def softplus(x):
    """``log(1 + exp(x))`` without a threshold (the reference's form)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _step(state, dt1, A, B1, C1, x1):
    """One step of the recurrence: ``state [B, H, N, P]``, ``dt1 [B,
    H]``, ``A [H]``, ``B1``/``C1 [B, N]``, ``x1 [B, H, P]`` -> (``C1 .
    state`` ``[B, H, P]`` float32, the new state)."""
    decay = torch.exp(dt1 * A[None, :])                         # [B,H]
    upd = torch.einsum("bn,bh,bhp->bhnp", B1.to(F32), dt1, x1.to(F32))
    state = state * decay[..., None, None] + upd
    return torch.einsum("bn,bhnp->bhp", C1.to(F32), state), state


def _sharded_step(state, dt1, A, B1, C1, x1):
    """``_step`` of DTensors in a ``local_map``, split as the cached
    state is over ``model`` (its heads H, its state dim N or its head dim
    P; N makes the output a partial sum over ``model``), the batch over
    the data-parallel dims where it divides."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    mesh = state.device_mesh
    names = mesh.mesh_dim_names
    d = None
    if "model" in names:
        p = state.placements[names.index("model")]
        d = p.dim if isinstance(p, Shard) else None
    bt = state.shape[0]
    st_pl = ops.placements(mesh, bt, 0, d)
    x_pl = ops.placements(mesh, bt, 0, {1: 1, 3: 2}.get(d))
    y_pl = list(x_pl)
    if d == 2:
        y_pl[names.index("model")] = Partial()
    return local_map(
        _step, out_placements=(y_pl, st_pl),
        in_placements=(st_pl, ops.placements(mesh, bt, 0,
                                             1 if d == 1 else None),
                       ops.placements(mesh, None, 0, 0 if d == 1 else None),
                       ops.placements(mesh, bt, 0, 1 if d == 2 else None),
                       ops.placements(mesh, bt, 0, 1 if d == 2 else None),
                       x_pl),
        device_mesh=mesh, redistribute_inputs=True)(state, dt1, A, B1, C1,
                                                    x1)


def mamba2_block(x, p, cfg, *, cache=None, impl="auto"):
    """x: [B, S, D] -> (y [B, S, D], new_cache).

    cache (decode): dict(conv=[B, K-1, C], state=[B, H, N, P]).
    p: in_proj [D, 2*di+2*ns+nh], conv_w [K, C], conv_b [C], A_log [H],
    D [H], dt_bias [H], norm [di], out_proj [di, D]  (C = di + 2*ns).
    """
    B, S, D = x.shape
    di, ns, nh, hd = ssm_dims(cfg)
    K = cfg.ssm_conv
    C = di + 2 * ns

    zxbcdt = mm(x, p["in_proj"])
    z, xbc, dt = torch.split(zxbcdt, [di, C, nh], dim=-1)
    dt = softplus(dt.to(F32) + p["dt_bias"].to(F32))            # [B,S,H]

    # short depthwise causal conv over (x, B, C) channels
    if cache is None:
        pad = like(x, torch.zeros(B, K - 1, C, dtype=xbc.dtype,
                                  device=x.device))
        xbc_c = torch.cat([pad, xbc], dim=1)
    else:
        xbc_c = torch.cat([cache["conv"].to(xbc.dtype), xbc], dim=1)
    new_conv = xbc_c[:, -(K - 1):, :] if K > 1 else None
    windows = torch.stack([xbc_c[:, i:i + S, :] for i in range(K)], dim=2)
    ct = torch.promote_types(windows.dtype, p["conv_w"].dtype)
    xbc = torch.einsum("bskc,kc->bsc", windows.to(ct), p["conv_w"].to(ct))
    xbc = F.silu(xbc + p["conv_b"])
    xs, Bm, Cm = torch.split(xbc, [di, ns, ns], dim=-1)
    xh = split_heads(xs, nh, hd)
    A = -torch.exp(p["A_log"].to(F32))                          # [H] < 0

    if cache is None or S > 1:
        # training forward, or prefill (cache given but empty at pos 0)
        if cache is None:
            y = ops.ssd(xh, dt, A, Bm, Cm, p["D"], impl=impl)
            new_state = None
        else:   # prefill hands the final state to decode
            y, new_state = ops.ssd(xh, dt, A, Bm, Cm, p["D"], impl=impl,
                                   return_state=True)
    else:
        # single-step recurrence (S == 1)
        step = _sharded_step if isinstance(x, DTensor) else _step
        y, new_state = step(cache["state"], dt[:, 0], A, Bm[:, 0],
                            Cm[:, 0], xh[:, 0])
        y = y + p["D"].to(F32)[None, :, None] * xh[:, 0].to(F32)
        y = y[:, None].to(x.dtype)                              # [B,1,H,P]

    y = merge_heads(y)
    y = rms_norm(y * F.silu(z.to(F32)).to(y.dtype), p["norm"], cfg.norm_eps)
    out = mm(y, p["out_proj"]).to(x.dtype)
    new_cache = None
    if cache is not None:
        new_cache = {"conv": (new_conv if new_conv is not None
                              else torch.zeros(B, 0, C, dtype=x.dtype,
                                               device=x.device)),
                     "state": new_state}
    return out, new_cache
