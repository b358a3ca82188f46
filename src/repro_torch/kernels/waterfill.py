"""K1 — the max-min waterfill as hand-written CUDA kernels.

``waterfill(src, dst, active, caps_up, caps_down)`` computes the same
batched max-min fair rates as the plain PyTorch version
(``repro_torch.core.vectorized.waterfill``), bit for bit.  On CUDA
tensors it launches one route of ``kernels/csrc/waterfill.cu`` (built
by ``_build`` at first use) or raises; on CPU tensors it runs the plain
version.  There is no fallback from a kernel to the plain version, or
from one route to the other, on the card.  The route is picked from the
shape alone (``route_for``):

* ``"warp"`` — ``F <= 128`` and ``W <= 32`` (every survey cluster:
  ``F = 4W``): one warp per row, 4 rows per block, no block barrier;
* ``"block"`` — every other shape with ``2W <= 1024``: one block per
  row, one thread per resource and ``ceil(F / blockDim)`` flows per
  thread, so any ``F`` (the per-edge simulator solves ``F = E``).

The kernels replace the TPU kernel
``src/repro/kernels/waterfill.py::_waterfill_kernel`` (Pallas, wrapper
``waterfill_batch``).  They are bound by launch latency and the serial
filling rounds inside a row, not by bytes or operations: per row they
read ``F*9 + W*8`` bytes and write ``F*4``; see the note at the top of
the CUDA source.  The simulator calls this wrapper on every event step
of a host-bound loop, so the wrapper itself is kept short: no copy of
an input that is already contiguous, no device context when the inputs
are on the current device, one ctypes function resolved once.

``LAUNCHES.count`` counts kernel launches (not CPU calls), so a run can
show that the simulator's main path went through the kernel;
``LAUNCHES.routes`` counts the same launches by route.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.vectorized.waterfill import waterfill as waterfill_plain
from ._counter import LaunchCounter
from ._launch import on_device, raw_stream

ROUTES = ("warp", "block")
# the warp route's limits: 4 flows per lane, one upload and one download
# resource per lane; the block route's: one thread per resource
WARP_MAX_F, WARP_MAX_W = 128, 32
MAX_THREADS = 1024

LAUNCHES = LaunchCounter(ROUTES)

_FN = None


def _launcher():
    global _FN
    if _FN is None:
        from . import _build
        fn = _build.load("waterfill").waterfill_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def route_for(F, W):
    """The kernel route of a CUDA call with ``F`` flows over ``W``
    workers: ``"warp"`` or ``"block"`` (see the module docstring)."""
    return "warp" if F <= WARP_MAX_F and W <= WARP_MAX_W else "block"


def _require_f32(**arrays):
    """The simulator is float32 end to end: a float64 capacity would
    silently change every share.  Fail at the boundary instead."""
    for name, x in arrays.items():
        if x.dtype != torch.float32:
            raise TypeError(f"waterfill: {name!r} is {x.dtype}; the "
                            f"simulator pipeline is float32-only")


def _check(src, dst, active, caps_up, caps_down):
    """``(device, R, F, W)`` of a call, or raises (the simulator calls
    this on every event step: one read of each shape and device)."""
    if caps_up.dtype is not torch.float32 \
            or caps_down.dtype is not torch.float32:
        _require_f32(caps_up=caps_up, caps_down=caps_down)
    shape, caps = src.shape, caps_up.shape
    if len(shape) != 2 or dst.shape != shape or active.shape != shape:
        raise ValueError(f"waterfill: src/dst/active must share one [R, F] "
                         f"shape, got {tuple(shape)}, "
                         f"{tuple(dst.shape)}, {tuple(active.shape)}")
    if len(caps) != 2 or caps[0] != shape[0] or caps_down.shape != caps:
        raise ValueError(f"waterfill: caps must be [R, W] with R="
                         f"{shape[0]}, got {tuple(caps)}, "
                         f"{tuple(caps_down.shape)}")
    dev = src.device
    if not dev == dst.device == active.device == caps_up.device \
            == caps_down.device:
        devs = {t.device for t in (src, dst, active, caps_up, caps_down)}
        raise ValueError(f"waterfill: tensors on several devices {devs}")
    return dev, shape[0], shape[1], caps[1]


def _check_cuda(src, dst, active, dev):
    if dev.type != "cuda":
        raise ValueError(f"waterfill: no kernel for device {dev}")
    for name, x in (("src", src), ("dst", dst)):
        if x.dtype is not torch.int32:
            raise TypeError(f"waterfill: {name!r} must be int32, got "
                            f"{x.dtype}")
    if active.dtype is not torch.bool and active.dtype is not torch.uint8:
        raise TypeError(f"waterfill: 'active' must be bool or uint8, got "
                        f"{active.dtype}")


def waterfill(src, dst, active, caps_up, caps_down, max_rounds=None):
    """Max-min rates ``f32[R, F]`` for ``R`` flow sets of ``F`` flows over
    ``W`` workers.  ``src``/``dst``: int32 ``[R, F]`` worker ids in
    ``[0, W)`` (the kernels treat a flow with an id outside as inactive;
    the plain version indexes by id and needs them in range);
    ``active``: bool or uint8 ``[R, F]``; ``caps_up``/``caps_down``: f32
    ``[R, W]``.  ``max_rounds`` defaults to ``2W``.  Unbatched
    ``[F]``/``[W]`` input gives ``[F]``."""
    return _waterfill(src, dst, active, caps_up, caps_down, max_rounds)


def _waterfill(src, dst, active, caps_up, caps_down, max_rounds=None,
               route=None):
    """``waterfill`` with the route forced (``None``: by shape).  Not a
    knob of the simulator: it lets the smoke run and the card tests hold
    either route against the plain version at the same shape.  A route
    that does not take the shape raises."""
    unbatched = src.dim() == 1
    if unbatched:
        src, dst, active, caps_up, caps_down = (
            x.unsqueeze(0) for x in (src, dst, active, caps_up, caps_down))
    dev, R, F, W = _check(src, dst, active, caps_up, caps_down)
    if route is None:
        route = route_for(F, W)
    elif route not in ROUTES:
        raise ValueError(f"waterfill: route {route!r} not in {ROUTES}")
    elif route == "warp" and route_for(F, W) != "warp":
        raise ValueError(f"waterfill: the warp route takes F <= "
                         f"{WARP_MAX_F} and W <= {WARP_MAX_W}, got F={F}, "
                         f"W={W}")
    if dev.type == "cpu":
        out = waterfill_plain(src, dst, active, caps_up, caps_down,
                              max_rounds)
        return out[0] if unbatched else out
    _check_cuda(src, dst, active, dev)
    if 2 * W > MAX_THREADS:
        raise ValueError(f"waterfill: 2W = {2 * W} resources exceed one "
                         f"block's {MAX_THREADS} threads")
    rates = torch.empty((R, F), dtype=torch.float32, device=dev)
    if R == 0 or F == 0:
        return rates[0] if unbatched else rates
    if W == 0:
        rates.zero_()
        return rates[0] if unbatched else rates
    ins = [x if x.is_contiguous() else x.contiguous()
           for x in (src, dst, active, caps_up, caps_down)]
    with on_device(dev):
        err = _launcher()(*(x.data_ptr() for x in ins), rates.data_ptr(),
                          R, F, W,
                          2 * W if max_rounds is None else int(max_rounds),
                          ROUTES.index(route), raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"waterfill {route} launch failed: CUDA error "
                           f"{err} (R={R}, F={F}, W={W})")
    LAUNCHES.add(route)
    return rates[0] if unbatched else rates
