"""K3 — the Mamba-2 SSD chunked scan as a hand-written CUDA kernel.

``ssd_scan(x, dt, A, B, C, D, chunk=64, return_state=False)`` computes
the function of the plain version ``ref.ssd_chunked`` (x
``[Bt, L, H, P]``, dt ``[Bt, L, H]``, A/D ``[H]``, B/C ``[Bt, L, N]``)
and, with ``return_state``, also the state ``f32[Bt, H, N, P]`` after
the last step, which the prefill hands to decode.  On CUDA tensors it
launches ``kernels/csrc/ssd.cu`` (built by ``_build`` at first use) or
raises; on CPU tensors it runs the plain versions (``ref.ssd_chunked``
and the sequential ``ref.ssd_final_state``).  There is no fallback from
the kernel to the plain version on the card.

The kernel replaces the TPU kernel ``src/repro/kernels/ssd.py::
_ssd_kernel`` (Pallas, wrapper ``ssd_scan``): one block per
(batch, head) walks the chunks in order with the state in shared
memory; see the note at the top of the CUDA source.  It takes float32
only — the model's path is float32 there even in a bfloat16 model.

``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from ._counter import LaunchCounter

MAX_CHUNK = 64

LAUNCHES = LaunchCounter()

_FN = None


def _launcher():
    global _FN
    if _FN is None:
        from . import _build
        fn = _build.load("ssd").ssd_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(x, dt, A, B, C, D, chunk):
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x must be [Bt, L, H, P], got "
                         f"{tuple(x.shape)}")
    Bt, L, H, P = x.shape
    if (dt.shape != (Bt, L, H) or A.shape != (H,) or B.dim() != 3
            or B.shape[:2] != (Bt, L) or C.shape != B.shape
            or (D is not None and D.shape != (H,))):
        raise ValueError(f"ssd_scan: shapes disagree: x {tuple(x.shape)}, "
                         f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}")
    Q = min(chunk, L)
    if Q <= 0 or L % Q:
        raise ValueError(f"ssd_scan: L={L} is not a multiple of the chunk "
                         f"{Q}")
    devs = {t.device for t in (x, dt, A, B, C) if t is not None}
    if D is not None:
        devs.add(D.device)
    if len(devs) != 1:
        raise ValueError(f"ssd_scan: tensors on several devices {devs}")
    return Q


def ssd_scan(x, dt, A, B, C, D=None, *, chunk=64, return_state=False):
    """``y [Bt, L, H, P]`` in x's dtype, or ``(y, state)`` with
    ``return_state``.  ``L`` must be a multiple of ``min(chunk, L)``."""
    Q = _check(x, dt, A, B, C, D, chunk)
    if x.device.type == "cpu":
        y = ref.ssd_chunked(x, dt, A, B, C, D, chunk=chunk)
        if not return_state:
            return y
        return y, ref.ssd_final_state(x, dt, A, B)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    if Q > MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk {Q} exceeds {MAX_CHUNK}")
    if D is None:
        D = torch.zeros_like(A)
    ts = [t.contiguous() for t in (x, dt, A, B, C, D)]
    for name, t in zip(("x", "dt", "A", "B", "C", "D"), ts):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan: {name!r} is {t.dtype}; the kernel "
                            f"takes float32")
    Bt, L, H, P = x.shape
    N = B.shape[-1]
    y = torch.empty(Bt, L, H, P, dtype=torch.float32, device=x.device)
    state = (torch.empty(Bt, H, N, P, dtype=torch.float32, device=x.device)
             if return_state else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _launcher()(*(t.data_ptr() for t in ts), y.data_ptr(),
                          state.data_ptr() if state is not None else None,
                          Bt, L, H, P, N, Q, stream)
    if err != 0:
        raise RuntimeError(f"ssd kernel launch failed: CUDA error {err} "
                           f"(x {tuple(x.shape)}, N={N}, chunk={Q})")
    LAUNCHES.count += 1
    return (y, state) if return_state else y
