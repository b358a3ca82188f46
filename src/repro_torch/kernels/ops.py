"""Public entry points of the LM kernels, dispatched by device.

``impl="auto"`` (the default) sends CUDA tensors to the hand-written
kernels (K2 ``flash_attention``, K3 ``ssd_scan``) and CPU tensors to
their plain PyTorch versions; ``impl="torch"`` runs the plain versions
on any device (``chip_smoke.py`` holds the model's kernel path against
it on the card).  Unlike the reference's ``kernels/ops.py`` there is no
route to the oracle for a run-time ``window`` or ``kv_len``: the CUDA
kernel takes both at run time.
"""
from __future__ import annotations

from . import ref
from .flash_attention import flash_attention
from .ssd import ssd_scan

IMPLS = ("auto", "torch")


def _check_impl(impl):
    if impl not in IMPLS:
        raise ValueError(f"kernel impl {impl!r} not in {IMPLS}")


def attention(q, k, v, *, causal=True, window=0, scale=None, kv_len=None,
              impl="auto"):
    """GQA attention with causal and sliding-window masks.  See
    ``ref.attention_ref``."""
    _check_impl(impl)
    if impl == "torch":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 scale=scale, kv_len=kv_len)
    return flash_attention(q, k, v, causal=causal, window=window,
                           scale=scale, kv_len=kv_len)


def ssd(x, dt, A, B, C, D, *, chunk=64, impl="auto", return_state=False):
    """Mamba-2 SSD chunked scan; with ``return_state`` also the final
    state ``f32[Bt, H, N, P]``.  See ``ref.ssd_chunked``."""
    _check_impl(impl)
    if impl == "torch":
        y = ref.ssd_chunked(x, dt, A, B, C, D, chunk=chunk)
        if not return_state:
            return y
        return y, ref.ssd_final_state(x, dt, A, B)
    return ssd_scan(x, dt, A, B, C, D, chunk=chunk,
                    return_state=return_state)
