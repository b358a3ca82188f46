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
"""
from __future__ import annotations

import torch

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
