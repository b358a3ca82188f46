"""K3 — the Mamba-2 SSD chunked scan as three hand-written CUDA kernels.

``ssd_scan(x, dt, A, B, C, D, chunk=64, return_state=False)`` computes
the function of the plain version ``ref.ssd_chunked`` (x
``[Bt, L, H, P]``, dt ``[Bt, L, H]``, A/D ``[H]``, B/C ``[Bt, L, N]``)
and, with ``return_state``, also the state ``f32[Bt, H, N, P]`` after
the last step, which the prefill hands to decode.  On CUDA tensors it
launches the three kernels of ``kernels/csrc/ssd.cu`` (built by
``_build`` at first use) on the current stream or raises; on CPU
tensors it runs the plain versions (``ref.ssd_chunked`` and the
sequential ``ref.ssd_final_state``).  There is no fallback from a
kernel to the plain version on the card.

The kernels replace the TPU kernel ``src/repro/kernels/ssd.py::
_ssd_kernel`` (Pallas, wrapper ``ssd_scan``), cut into the three phases
of the Mamba-2 paper's SSD algorithm, each parallel over chunks:

* ``chunk_states`` — the state each chunk emits, ``S_loc f32[Bt, nc,
  H, N, P]``, and the chunk totals of the decay (plain version
  ``ref.ssd_chunk_states``);
* ``pass_states`` — in chunk order, the state entering each chunk
  (``h_in``, written over ``S_loc``) and the final state (plain version
  ``ref.ssd_pass_states``);
* ``chunk_scan`` — ``y`` from each chunk's own terms and its ``h_in``
  (plain version ``ref.ssd_chunk_scan``).

``ssd_scan`` allocates the ``S_loc`` / ``h_in`` scratch and runs the
three; the three functions alone serve ``chip_smoke.py``'s per-phase
checks.  What bounds the design and what it does about it: the note at
the top of the CUDA source.  The kernels take float32 only — the
model's path is float32 there even in a bfloat16 model.

``LAUNCHES.count`` goes up by one per ``ssd_scan`` call served by the
kernels (its three launches count once); the per-phase functions are
not counted.

Training: ``_SSDScanFn`` runs ``ssd_scan`` in the forward pass and, in
the backward pass, differentiates the plain version ``ref.ssd_chunked``
recomputed from the saved inputs (``_grad.plain_backward``); the kernels
have no backward, as the Pallas kernel has none.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from ._counter import LaunchCounter
from ._grad import plain_backward

MAX_CHUNK = 64

LAUNCHES = LaunchCounter()

_FNS = {}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, dt, A, B, S_loc, total, Bt, L, H, P, N, Q, stream
    "ssd_chunk_state_launch": [_P] * 6 + [_I] * 6 + [_P],
    # S_loc (h_in in place), total, state_out, Bt, nc, H, N, P, stream
    "ssd_state_pass_launch": [_P] * 3 + [_I] * 5 + [_P],
    # x, dt, A, B, C, D, h_in, y, Bt, L, H, P, N, Q, stream
    "ssd_chunk_scan_launch": [_P] * 8 + [_I] * 6 + [_P],
}


def _launcher(name):
    fn = _FNS.get(name)
    if fn is None:
        from . import _build
        fn = getattr(_build.load("ssd"), name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


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


def _float32_cuda(**tensors):
    """The tensors, contiguous; raises unless each is float32 on CUDA."""
    out = []
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"ssd_scan: no kernel for device {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan: {name!r} is {t.dtype}; the kernel "
                            f"takes float32")
        out.append(t.contiguous())
    return out


def _launch(name, dev, *args):
    """Launches kernel ``name`` on ``dev``'s current stream; raises on a
    CUDA error (a refused launch never runs)."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err} (shapes and "
                           f"shared memory: the note in csrc/ssd.cu)")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _chunk_states(x, dt, A, B, Q):
    Bt, L, H, P = x.shape
    N = B.shape[-1]
    S = torch.empty(Bt, L // Q, H, N, P, dtype=torch.float32,
                    device=x.device)
    total = torch.empty(Bt, L // Q, H, dtype=torch.float32, device=x.device)
    _launch("ssd_chunk_state_launch", x.device, *map(_ptr, (x, dt, A, B)),
            S.data_ptr(), total.data_ptr(), Bt, L, H, P, N, Q)
    return S, total


def _pass_states(S, total, state):
    """``S`` becomes ``h_in`` in place; ``state`` (or None) the final
    state."""
    Bt, nc, H, N, P = S.shape
    _launch("ssd_state_pass_launch", S.device, S.data_ptr(),
            total.data_ptr(), _ptr(state), Bt, nc, H, N, P)


def _chunk_scan(x, dt, A, B, C, D, h_in, Q):
    Bt, L, H, P = x.shape
    N = B.shape[-1]
    y = torch.empty(Bt, L, H, P, dtype=torch.float32, device=x.device)
    _launch("ssd_chunk_scan_launch", x.device,
            *map(_ptr, (x, dt, A, B, C, D, h_in, y)), Bt, L, H, P, N, Q)
    return y


def ssd_scan(x, dt, A, B, C, D=None, *, chunk=64, return_state=False):
    """``y [Bt, L, H, P]`` in x's dtype, or ``(y, state)`` with
    ``return_state``.  ``L`` must be a multiple of ``min(chunk, L)``."""
    Q = _check(x, dt, A, B, C, D, chunk)
    if x.device.type == "cpu":
        y = ref.ssd_chunked(x, dt, A, B, C, D, chunk=chunk)
        if not return_state:
            return y
        return y, ref.ssd_final_state(x, dt, A, B)
    if Q > MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk {Q} exceeds {MAX_CHUNK}")
    if D is None:
        D = torch.zeros_like(A)
    x, dt, A, B, C, D = _float32_cuda(x=x, dt=dt, A=A, B=B, C=C, D=D)
    Bt, L, H, P = x.shape
    N = B.shape[-1]
    state = (torch.empty(Bt, H, N, P, dtype=torch.float32, device=x.device)
             if return_state else None)
    S, total = _chunk_states(x, dt, A, B, Q)
    _pass_states(S, total, state)                # S is h_in from here on
    y = _chunk_scan(x, dt, A, B, C, D, S, Q)
    LAUNCHES.count += 1
    return (y, state) if return_state else y


class _SSDScanFn(torch.autograd.Function):
    """``kernel(x, dt, A, B, C, D, chunk=)`` in the forward pass
    (``ssd_scan`` on the model's path; the CPU tests hand it the plain
    version to check the wiring), the gradient of ``ref.ssd_chunked`` for
    x, dt, A, B, C and D in the backward pass.  Arguments: x, dt, A, B,
    C, D (or None), chunk, kernel."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, chunk, kernel):
        ctx.save_for_backward(x, dt, A, B, C, D)
        ctx.chunk = chunk
        return kernel(x, dt, A, B, C, D, chunk=chunk)

    @staticmethod
    def backward(ctx, grad_y):
        grads = plain_backward("ssd_scan_backward_plain", ref.ssd_chunked,
                               ctx.saved_tensors, ctx.needs_input_grad[:6],
                               grad_y, chunk=ctx.chunk)
        return (*grads, None, None)


def chunk_states(x, dt, A, B, *, chunk=64):
    """Phase 1 alone: ``(S_loc f32[Bt, nc, H, N, P], total f32[Bt, nc,
    H])``; the plain version ``ref.ssd_chunk_states`` on CPU tensors."""
    Q = _check(x, dt, A, B, B, None, chunk)
    if x.device.type == "cpu":
        return ref.ssd_chunk_states(x, dt, A, B, chunk=chunk)
    return _chunk_states(*_float32_cuda(x=x, dt=dt, A=A, B=B), Q)


def pass_states(S_loc, total):
    """Phase 2 alone: ``(h_in, final state)``; ``S_loc`` is left as it
    was (the kernel runs in place on a copy).  The plain version
    ``ref.ssd_pass_states`` on CPU tensors."""
    if S_loc.dim() != 5 or total.shape != S_loc.shape[:3]:
        raise ValueError(f"pass_states: S_loc {tuple(S_loc.shape)} and "
                         f"total {tuple(total.shape)} disagree")
    if S_loc.device.type == "cpu":
        return ref.ssd_pass_states(S_loc, total)
    S, total = _float32_cuda(S_loc=S_loc, total=total)
    h_in = S.clone()
    Bt, nc, H, N, P = S.shape
    state = torch.empty(Bt, H, N, P, dtype=torch.float32, device=S.device)
    _pass_states(h_in, total, state)
    return h_in, state


def chunk_scan(x, dt, A, B, C, D, h_in, *, chunk=64):
    """Phase 3 alone: ``y`` from the chunks' own terms and ``h_in
    f32[Bt, nc, H, N, P]``; the plain version ``ref.ssd_chunk_scan`` on
    CPU tensors."""
    Q = _check(x, dt, A, B, C, D, chunk)
    Bt, L, H, P = x.shape
    if h_in.shape != (Bt, L // Q, H, B.shape[-1], P):
        raise ValueError(f"chunk_scan: h_in {tuple(h_in.shape)} does not "
                         f"fit x {tuple(x.shape)}, chunk {Q}")
    if x.device.type == "cpu":
        return ref.ssd_chunk_scan(x, dt, A, B, C, D, h_in, chunk=chunk)
    if D is None:
        D = torch.zeros_like(A)
    return _chunk_scan(*_float32_cuda(x=x, dt=dt, A=A, B=B, C=C, D=D,
                                      h_in=h_in), Q)
