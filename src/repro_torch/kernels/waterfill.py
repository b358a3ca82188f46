"""K1 — the max-min waterfill as a hand-written CUDA kernel.

``waterfill(src, dst, active, caps_up, caps_down)`` computes the same
batched max-min fair rates as the plain PyTorch version
(``repro_torch.core.vectorized.waterfill``).  On CUDA tensors it
launches ``kernels/csrc/waterfill.cu`` (built by ``_build`` at first
use) or raises; on CPU tensors it runs the plain version.  There is no
fallback from the kernel to the plain version on the card.

The kernel replaces the TPU kernel
``src/repro/kernels/waterfill.py::_waterfill_kernel`` (Pallas, wrapper
``waterfill_batch``).  It is bound by launch latency and the serial
filling rounds inside a row, not by bytes or operations: per row it
reads ``F*9 + W*8`` bytes and writes ``F*4``.  The design answers that
with one block per row, shared-memory integer counters, and an early
exit per row; see the note at the top of the CUDA source.

``LAUNCHES`` counts kernel launches (not CPU calls), so a run can show
that the simulator's main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.vectorized.waterfill import waterfill as waterfill_plain
from ._counter import LaunchCounter

MAX_THREADS = 1024

LAUNCHES = LaunchCounter()

_FN = None


def _launcher():
    global _FN
    if _FN is None:
        from . import _build
        fn = _build.load("waterfill").waterfill_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _require_f32(**arrays):
    """The simulator is float32 end to end: a float64 capacity would
    silently change every share.  Fail at the boundary instead."""
    for name, x in arrays.items():
        if x.dtype != torch.float32:
            raise TypeError(f"waterfill: {name!r} is {x.dtype}; the "
                            f"simulator pipeline is float32-only")


def _check(src, dst, active, caps_up, caps_down):
    _require_f32(caps_up=caps_up, caps_down=caps_down)
    if src.dim() != 2 or dst.shape != src.shape or active.shape != src.shape:
        raise ValueError(f"waterfill: src/dst/active must share one [R, F] "
                         f"shape, got {tuple(src.shape)}, "
                         f"{tuple(dst.shape)}, {tuple(active.shape)}")
    R = src.shape[0]
    if caps_up.dim() != 2 or caps_up.shape[0] != R \
            or caps_down.shape != caps_up.shape:
        raise ValueError(f"waterfill: caps must be [R, W] with R={R}, got "
                         f"{tuple(caps_up.shape)}, {tuple(caps_down.shape)}")
    devs = {t.device for t in (src, dst, active, caps_up, caps_down)}
    if len(devs) != 1:
        raise ValueError(f"waterfill: tensors on several devices {devs}")


def waterfill(src, dst, active, caps_up, caps_down, max_rounds=None):
    """Max-min rates ``f32[R, F]`` for ``R`` flow sets of ``F`` flows over
    ``W`` workers.  ``src``/``dst``: int32 ``[R, F]`` worker ids in
    ``[0, W)``; ``active``: bool or uint8 ``[R, F]``; ``caps_up``/
    ``caps_down``: f32 ``[R, W]``.  ``max_rounds`` defaults to ``2W``.
    Unbatched ``[F]``/``[W]`` input gives ``[F]``."""
    unbatched = src.dim() == 1
    if unbatched:
        src, dst, active, caps_up, caps_down = (
            x.unsqueeze(0) for x in (src, dst, active, caps_up, caps_down))
    _check(src, dst, active, caps_up, caps_down)
    if src.device.type == "cpu":
        out = waterfill_plain(src, dst, active, caps_up, caps_down,
                              max_rounds)
        return out[0] if unbatched else out
    if src.device.type != "cuda":
        raise ValueError(f"waterfill: no kernel for device {src.device}")
    for name, x in (("src", src), ("dst", dst)):
        if x.dtype != torch.int32:
            raise TypeError(f"waterfill: {name!r} must be int32, got "
                            f"{x.dtype}")
    if active.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"waterfill: 'active' must be bool or uint8, got "
                        f"{active.dtype}")
    R, F = src.shape
    W = caps_up.shape[1]
    if max(F, 2 * W) > MAX_THREADS:
        raise ValueError(f"waterfill: max(F, 2W) = {max(F, 2 * W)} exceeds "
                         f"one block's {MAX_THREADS} threads")
    if max_rounds is None:
        max_rounds = 2 * W
    tensors = [x.contiguous() for x in (src, dst, active, caps_up,
                                        caps_down)]
    rates = torch.empty(R, F, dtype=torch.float32, device=src.device)
    if R == 0 or F == 0:
        return rates[0] if unbatched else rates
    if W == 0:
        rates.zero_()
        return rates[0] if unbatched else rates
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = _launcher()(*(t.data_ptr() for t in tensors), rates.data_ptr(),
                          R, F, W, int(max_rounds), stream)
    if err != 0:
        raise RuntimeError(f"waterfill kernel launch failed: CUDA error "
                           f"{err} (R={R}, F={F}, W={W})")
    LAUNCHES.count += 1
    return rates[0] if unbatched else rates
