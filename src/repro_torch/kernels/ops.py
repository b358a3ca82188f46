"""Public entry points of the LM kernels, dispatched by device.

``impl="auto"`` (the default) sends CUDA tensors to the hand-written
kernels (K2 ``flash_attention``, K3 ``ssd_scan``) and CPU tensors to
their plain PyTorch versions; ``impl="torch"`` runs the plain versions
on any device (``chip_smoke.py`` holds the model's kernel path against
it on the card).  Unlike the reference's ``kernels/ops.py`` there is no
route to the oracle for a run-time ``window`` or ``kv_len``: the CUDA
kernel takes both at run time.

A CUDA call that autograd records (grad mode on, an input that requires
grad) goes through the kernel's ``torch.autograd.Function``: the kernel
in the forward pass, the gradient of the plain version in the backward
pass.  Any other call (serving, under ``no_grad``) calls the kernel's
wrapper directly.

DTensor inputs (a model placed on a mesh, ``models/params.py``) run
through ``local_map``: the inputs are redistributed to the placements
below and the call above runs on each rank's local tensors, so the
ctypes launchers only ever see local tensors, and a gradient goes
through ``_FlashAttentionFn`` / ``_SSDScanFn`` on the local shards.

* Attention: the batch over the mesh's data-parallel dims when it
  divides; the query heads over ``model`` when they divide, else
  attention runs replicated over ``model`` (hymba's 25 and
  llama4-scout's 40 heads on 16 cards, as the reference splits d_model
  there).  KV heads that divide ``model`` are split with them; else K/V
  reach the call replicated over ``model`` (the reference splits
  ``wk``/``wv`` over d_model, not heads) and each rank slices the KV
  heads its query heads use.  A rank's query heads that would straddle
  a GQA group unevenly raise.  The sequence is never split: a
  sequence-parallel residual and a decode cache split along the
  sequence (``cache_pspecs`` when the KV heads do not divide ``model``)
  are all-gathered before the call — a collective the dry run counts.
* SSD scan: the batch as above; the SSD heads over ``model`` when they
  divide, else the scan runs replicated over ``model``.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from . import ref
from .flash_attention import _FlashAttentionFn, flash_attention
from .ssd import _SSDScanFn, ssd_scan

IMPLS = ("auto", "torch")


def _check_impl(impl):
    if impl not in IMPLS:
        raise ValueError(f"kernel impl {impl!r} not in {IMPLS}")


def _records_grad(*tensors):
    """True when autograd would record a call on ``tensors``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def attention(q, k, v, *, causal=True, window=0, scale=None, kv_len=None,
              impl="auto"):
    """GQA attention with causal and sliding-window masks.  See
    ``ref.attention_ref``."""
    _check_impl(impl)
    if isinstance(q, DTensor):
        return _sharded_attention(q, k, v, causal=causal, window=window,
                                  scale=scale, kv_len=kv_len, impl=impl)
    if impl == "torch":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 scale=scale, kv_len=kv_len)
    if q.device.type == "cuda" and _records_grad(q, k, v):
        return _FlashAttentionFn.apply(q, k, v, causal, window, scale,
                                       kv_len, flash_attention)
    return flash_attention(q, k, v, causal=causal, window=window,
                           scale=scale, kv_len=kv_len)


def ssd(x, dt, A, B, C, D, *, chunk=64, impl="auto", return_state=False):
    """Mamba-2 SSD chunked scan; with ``return_state`` also the final
    state ``f32[Bt, H, N, P]`` (prefill, which takes no gradient: asking
    for one raises).  See ``ref.ssd_chunked``."""
    _check_impl(impl)
    if isinstance(x, DTensor):
        return _sharded_ssd(x, dt, A, B, C, D, chunk=chunk, impl=impl,
                            return_state=return_state)
    grad = _records_grad(x, dt, A, B, C, D)
    if return_state and grad:
        raise RuntimeError("ops.ssd: return_state (prefill) has no "
                           "gradient; call it under torch.no_grad()")
    if impl == "torch":
        y = ref.ssd_chunked(x, dt, A, B, C, D, chunk=chunk)
        if not return_state:
            return y
        return y, ref.ssd_final_state(x, dt, A, B)
    if x.device.type == "cuda" and grad:
        return _SSDScanFn.apply(x, dt, A, B, C, D, chunk, ssd_scan)
    return ssd_scan(x, dt, A, B, C, D, chunk=chunk,
                    return_state=return_state)


# ------------------------------------------------------------- DTensors
def model_size(mesh):
    names = mesh.mesh_dim_names
    return mesh.size(names.index("model")) if "model" in names else 1


def placements(mesh, batch=None, batch_dim=0, split_dim=None):
    """Placements on ``mesh``: tensor dim ``batch_dim`` over every
    data-parallel mesh dim when ``batch`` (its size; None: never)
    divides their product, ``split_dim`` (None: none) over ``model``,
    the rest replicated."""
    names = mesh.mesh_dim_names
    dp = [i for i, n in enumerate(names) if n != "model"]
    out = [Replicate()] * mesh.ndim
    size = 1
    for i in dp:
        size *= mesh.size(i)
    if batch is not None and size > 1 and batch % size == 0:
        for i in dp:
            out[i] = Shard(batch_dim)
    if split_dim is not None:
        out[names.index("model")] = Shard(split_dim)
    return out


def with_partial(pl, dims):
    """``pl`` with ``Partial()`` on the mesh dims ``dims`` where it is
    ``Replicate``: the gradient placement of an input that is replicated
    over mesh dims whose ranks compute different parts from it."""
    return [Partial() if i in dims and isinstance(p, Replicate) else p
            for i, p in enumerate(pl)]


def sharded_dims(pl):
    """The mesh dims ``pl`` splits."""
    return [i for i, p in enumerate(pl) if isinstance(p, Shard)]


def _head_split(Hq, Hkv, m):
    """How attention splits over a ``model`` axis of ``m``: ``(query
    heads split?, KV heads split?, KV heads a rank slices)``; the last
    is None when the KV heads are split or replicated whole.  Raises
    when a rank's query heads would straddle a GQA group unevenly."""
    if m <= 1 or Hq % m:
        return False, False, None
    if Hkv % m == 0:
        return True, True, None
    hq, group = Hq // m, Hq // Hkv
    if hq % group and group % hq:
        raise ValueError(f"attention: {hq} query heads a rank over "
                         f"groups of {group} straddle a GQA group "
                         f"unevenly (Hq {Hq}, Hkv {Hkv}, model {m})")
    return True, False, max(1, hq // group)


def _sharded_attention(q, k, v, *, causal, window, scale, kv_len, impl):
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    B, Hq = q.shape[:2]
    Hkv = k.shape[1]
    q_split, kv_split, n_kv = _head_split(Hq, Hkv, model_size(mesh))
    q_pl = placements(mesh, B, 0, 1 if q_split else None)
    kv_pl = placements(mesh, B, 0, 1 if kv_split else None)
    # a rank that reads a slice of replicated K/V gives a partial gradient
    kv_grad = with_partial(kv_pl, [mesh.mesh_dim_names.index("model")]
                           if n_kv is not None else [])
    group = Hq // Hkv

    def local(ql, kl, vl):
        if n_kv is not None:
            # this rank's query heads and the KV heads they read
            h0 = mesh.get_local_rank("model") * ql.shape[1]
            kv0 = h0 // group
            kl, vl = kl[:, kv0:kv0 + n_kv], vl[:, kv0:kv0 + n_kv]
        return attention(ql, kl, vl, causal=causal, window=window,
                         scale=scale, kv_len=kv_len, impl=impl)

    return local_map(local, out_placements=q_pl,
                     in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def _sharded_ssd(x, dt, A, B, C, D, *, chunk, impl, return_state):
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    Bt, H = x.shape[0], x.shape[2]
    m = model_size(mesh)
    split = m > 1 and H % m == 0
    x_pl = placements(mesh, Bt, 0, 2 if split else None)     # x, dt, y
    bc_pl = placements(mesh, Bt, 0)                           # B, C
    vec_pl = placements(mesh, None, 0, 0 if split else None)  # A, D [H]
    state_pl = placements(mesh, Bt, 0, 1 if split else None)
    mi = [mesh.mesh_dim_names.index("model")] if split else []
    bc_grad = with_partial(bc_pl, mi)
    vec_grad = with_partial(vec_pl, sharded_dims(bc_pl))

    def local(xl, dtl, Al, Bl, Cl, Dl):
        return ssd(xl, dtl, Al, Bl, Cl, Dl, chunk=chunk, impl=impl,
                   return_state=return_state)

    return local_map(
        local, out_placements=(x_pl, state_pl) if return_state else x_pl,
        in_placements=(x_pl, x_pl, vec_pl, bc_pl, bc_pl, vec_pl),
        in_grad_placements=(x_pl, x_pl, vec_grad, bc_grad, bc_grad,
                            vec_grad),
        device_mesh=mesh, redistribute_inputs=True)(x, dt, A, B, C, D)
