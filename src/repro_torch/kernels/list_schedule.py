"""The static list schedule as one hand-written CUDA kernel.

``list_schedule(order, e_task, prod_e, e_obj, edge_valid, cpus, est_dur,
est_size, bandwidth, cores, max_cores)`` computes the static schedule of
``blevel``, ``tlevel`` or ``mcp`` (``order``, one of
``scheduling.LIST_ORDERS``) for every row of a simulator call: the
level, the order and the placement, bit for bit what the plain version
(``repro_torch.core.vectorized.scheduling.list_schedule_plain``) gives.
``blevel_priorities(e_task, prod_e, edge_valid, est_dur)`` stops after
the order of ``blevel``: greedy's priorities
(``blevel_priorities_plain``).  On
CUDA tensors both launch ``kernels/csrc/list_schedule.cu`` (built by
``_build`` at first use) or raise; on CPU tensors they run the plain
version.  There is no fallback from the kernel on the card.

It replaces no Pallas kernel: the reference runs the schedule on the
device as ``fori_loop``s under ``jit``, and the plain version issues a
few dozen eager ops a task from the host, 2·T steps a call.  The kernel
is one launch a call with no host read, one warp a row; it is bound by
the latency of a serial walk over the row's tasks, not by bytes or
operations (see the note at the top of the CUDA source).

Limits: T and E up to 65535, W up to 512, ``max_cores`` (the core slots
a worker, C) up to 32, and a row's shared memory (about 21·T + 10·E +
4·W·C bytes) up to 227 KB; a shape past them raises.  ``LAUNCHES``
counts kernel launches (not CPU calls) by mode: ``place`` and
``priorities``.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.vectorized.scheduling import (LIST_ORDERS,
                                          blevel_priorities_plain,
                                          list_schedule_plain)
from ._counter import LaunchCounter
from ._launch import on_device, raw_stream

MAX_IDS = 0xFFFF      # task and edge ids are uint16 in shared memory
MAX_W = 512           # one warp a row, lanes striding over 16 words
MAX_C = 32            # one lane a core slot

LAUNCHES = LaunchCounter(routes=("place", "priorities"))

_FN = None


def _launcher():
    global _FN
    if _FN is None:
        from . import _build
        fn = _build.load("list_schedule").list_schedule_launch
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(name, tensors, shapes, dtypes):
    """The call's device, or raises on a shape, dtype or device that the
    kernel does not take."""
    dev = tensors["est_dur"].device
    for key, x in tensors.items():
        if tuple(x.shape) != shapes[key]:
            raise ValueError(f"{name}: {key!r} must be {shapes[key]}, got "
                             f"{tuple(x.shape)}")
        if x.dtype is not dtypes[key]:
            raise TypeError(f"{name}: {key!r} must be {dtypes[key]}, got "
                            f"{x.dtype}")
        if x.device != dev:
            devs = {t.device for t in tensors.values()}
            raise ValueError(f"{name}: tensors on several devices {devs}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev


def _order(name, order):
    if order not in LIST_ORDERS:
        raise ValueError(f"{name}: order must be one of {LIST_ORDERS}, got "
                         f"{order!r}")
    return LIST_ORDERS.index(order)


def _edges(e_task, prod_e, edge_valid, est_dur):
    if est_dur.dim() != 2 or e_task.dim() != 2:
        raise ValueError(f"est_dur [R, T] and e_task [R, E] expected, got "
                         f"{tuple(est_dur.shape)}, {tuple(e_task.shape)}")
    R, T = est_dur.shape
    E = e_task.shape[1]
    shapes = dict(e_task=(R, E), prod_e=(R, E), edge_valid=(R, E),
                  est_dur=(R, T))
    dtypes = dict(e_task=torch.int64, prod_e=torch.int64,
                  edge_valid=torch.bool, est_dur=torch.float32)
    return R, T, E, shapes, dtypes


def _launch(dev, args, R, T, E, O, W, C, order, place):
    if T > MAX_IDS or E > MAX_IDS:
        raise ValueError(f"list_schedule: T = {T} tasks and E = {E} edges "
                         f"must not exceed {MAX_IDS}")
    args = [x if x is None or x.is_contiguous() else x.contiguous()
            for x in args]
    with on_device(dev):
        err = _launcher()(*(None if x is None else x.data_ptr()
                            for x in args),
                          R, T, E, O, W, C, order, int(place),
                          raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"list_schedule launch failed: CUDA error {err} "
                           f"(R={R}, T={T}, E={E}, W={W}, C={C}; a row "
                           f"takes about 21*T + 10*E + 4*W*C bytes of "
                           f"shared memory, 227 KB at most)")
    LAUNCHES.add("place" if place else "priorities")


def list_schedule(order, e_task, prod_e, e_obj, edge_valid, cpus, est_dur,
                  est_size, bandwidth, cores, max_cores):
    """``(assignment i64[R, T], priority f32[R, T])``: the static list
    schedule of ``order`` (``"blevel"``, ``"tlevel"`` or ``"mcp"``) from
    the edges' consumers, producers and objects (i64 ``[R, E]``) and
    validity (bool ``[R, E]``), the tasks' cores (i64 ``[R, T]``) and
    estimated durations (f32 ``[R, T]``), the objects' estimated sizes
    (f32 ``[R, O]``), the rows' bandwidths (f32 ``[R]``), the workers'
    cores (i64 ``[R, W]``) and ``max_cores`` core slots a worker (see
    ``scheduling.list_schedule_plain``)."""
    code = _order("list_schedule", order)
    R, T, E, shapes, dtypes = _edges(e_task, prod_e, edge_valid, est_dur)
    if est_size.dim() != 2 or cores.dim() != 2:
        raise ValueError(f"list_schedule: est_size [R, O] and cores [R, W] "
                         f"expected, got {tuple(est_size.shape)}, "
                         f"{tuple(cores.shape)}")
    O, W = est_size.shape[1], cores.shape[1]
    tensors = dict(e_task=e_task, prod_e=prod_e, e_obj=e_obj,
                   edge_valid=edge_valid, cpus=cpus, est_dur=est_dur,
                   est_size=est_size, bandwidth=bandwidth, cores=cores)
    shapes.update(e_obj=(R, E), cpus=(R, T), est_size=(R, O),
                  bandwidth=(R,), cores=(R, W))
    dtypes.update(e_obj=torch.int64, cpus=torch.int64,
                  est_size=torch.float32, bandwidth=torch.float32,
                  cores=torch.int64)
    dev = _check("list_schedule", tensors, shapes, dtypes)
    if dev.type == "cpu":
        return list_schedule_plain(order, e_task, prod_e, e_obj, edge_valid,
                                   cpus, est_dur, est_size, bandwidth, cores,
                                   max_cores)
    if W == 0 or W > MAX_W:
        raise ValueError(f"list_schedule: W = {W} workers; the kernel takes "
                         f"1 to {MAX_W}")
    if not 1 <= max_cores <= MAX_C:
        raise ValueError(f"list_schedule: max_cores = {max_cores}; the "
                         f"kernel takes 1 to {MAX_C} core slots a worker")
    aw = torch.empty((R, T), dtype=torch.int64, device=dev)
    prio = torch.empty((R, T), dtype=torch.float32, device=dev)
    if R and T:
        _launch(dev, (e_task, prod_e, e_obj, edge_valid, cpus, est_dur,
                      est_size, bandwidth, cores, aw, prio),
                R, T, E, O, W, max_cores, code, True)
    return aw, prio


def blevel_priorities(e_task, prod_e, edge_valid, est_dur):
    """``f32[R, T]``: greedy's priorities, T - each task's rank in
    decreasing estimated b-level (ties: smaller id), from the edges'
    consumers and producers (i64 ``[R, E]``), their validity (bool ``[R,
    E]``) and the estimated durations (f32 ``[R, T]``): the ``blevel``
    list schedule without its placement (see
    ``scheduling.blevel_priorities_plain``)."""
    R, T, E, shapes, dtypes = _edges(e_task, prod_e, edge_valid, est_dur)
    tensors = dict(e_task=e_task, prod_e=prod_e, edge_valid=edge_valid,
                   est_dur=est_dur)
    dev = _check("blevel_priorities", tensors, shapes, dtypes)
    if dev.type == "cpu":
        return blevel_priorities_plain(e_task, prod_e, edge_valid, est_dur)
    prio = torch.empty((R, T), dtype=torch.float32, device=dev)
    if R and T:
        _launch(dev, (e_task, prod_e, None, edge_valid, None, est_dur, None,
                      None, None, None, prio), R, T, E, 0, 0, 0,
                LIST_ORDERS.index("blevel"), False)
    return prio
