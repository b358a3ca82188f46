"""Greedy's placement as one hand-written CUDA kernel.

``greedy_place(placing, table, e_obj, size_now, missing, cpus, cores,
load0, tally)`` proposes a worker for each placing task of the dynamic
simulator's greedy invocation, bit for bit what the plain PyTorch
version (``repro_torch.core.vectorized.scheduling.greedy_place_plain``:
``bucket_transfer_costs`` then ``make_bucket_greedy_placer``'s loop)
proposes.  On CUDA tensors it launches ``kernels/csrc/greedy_place.cu``
(built by ``_build`` at first use) or raises; on CPU tensors it runs the
plain version.  There is no fallback from the kernel on the card.  The
kernel reads nothing on the host, so the simulator's whole event step
replays from a CUDA graph; one warp owns one row, and a lane strides
over the workers when ``W > 32`` (``W <= 512``).

It replaces no Pallas kernel: the reference runs this placement on the
device as a ``fori_loop`` under ``jit``.  It is bound by latency, not by
bytes or operations: a serial walk over a row's placing tasks (about 6
at the survey's shapes) and the input edges of each; see the note at
the top of the CUDA source.

``tally`` is an int64 ``[3]`` device tensor, zero before a simulator
call's first step: every call adds the placer's loop length (the
largest placing count over the rows) to ``tally[0]`` on the device,
and ``tally[1:]`` is the kernel's scratch, left at 0.  ``LAUNCHES.count``
counts kernel launches (not CPU calls).
"""
from __future__ import annotations

import ctypes

import torch

from ..core.vectorized.scheduling import greedy_place_plain
from ._counter import LaunchCounter
from ._launch import on_device, raw_stream

# one warp a row, lanes striding over up to 16 words of 32 workers
MAX_W = 512

LAUNCHES = LaunchCounter()

_FN = None


def _launcher():
    global _FN
    if _FN is None:
        from . import _build
        fn = _build.load("greedy_place").greedy_place_launch
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(placing, table, e_obj, size_now, missing, cpus, cores, load0,
           tally):
    """``(device, R, T, D, E, O, W)`` of a call, or raises."""
    if placing.dim() != 2 or table.dim() != 3 or missing.dim() != 3:
        raise ValueError(f"greedy_place: placing [R, T], table [R, T, D] "
                         f"and missing [R, O, W] expected, got "
                         f"{tuple(placing.shape)}, {tuple(table.shape)}, "
                         f"{tuple(missing.shape)}")
    R, T = placing.shape
    D = table.shape[2]
    _, O, W = missing.shape
    E = e_obj.shape[-1]
    want = {"table": (table, (R, T, D)), "e_obj": (e_obj, (R, E)),
            "size_now": (size_now, (R, O)), "missing": (missing, (R, O, W)),
            "cpus": (cpus, (R, T)), "cores": (cores, (R, W)),
            "load0": (load0, (R, W)), "tally": (tally, (3,))}
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"greedy_place: {name!r} must be {shape}, got "
                             f"{tuple(x.shape)}")
    dev = placing.device
    ins = (table, e_obj, size_now, missing, cpus, cores, load0, tally)
    if any(x.device != dev for x in ins):
        devs = {x.device for x in (placing,) + ins}
        raise ValueError(f"greedy_place: tensors on several devices {devs}")
    return dev, R, T, D, E, O, W


_DTYPES = {"placing": torch.bool, "table": torch.int64,
           "e_obj": torch.int64, "size_now": torch.float32,
           "missing": torch.bool, "cpus": torch.int64,
           "cores": torch.int64, "load0": torch.int64, "tally": torch.int64}


def greedy_place(placing, table, e_obj, size_now, missing, cpus, cores,
                 load0, tally):
    """``i64[R, T]``: the proposed worker of each ``placing`` task (bool
    ``[R, T]``), -1 elsewhere, from the edge table (i64 ``[R, T, D]``,
    -1-padded), the edges' objects (i64 ``[R, E]``), the objects' sizes
    (f32 ``[R, O]``), which objects each worker misses (bool ``[R, O,
    W]``), the tasks' cores (i64 ``[R, T]``), the workers' cores and
    queued loads (i64 ``[R, W]``); the placer's loop length is added to
    ``tally[0]`` (see the module docstring)."""
    dev, R, T, D, E, O, W = _check(placing, table, e_obj, size_now,
                                   missing, cpus, cores, load0, tally)
    if dev.type == "cpu":
        return greedy_place_plain(placing, table, e_obj, size_now, missing,
                                  cpus, cores, load0, tally)
    if dev.type != "cuda":
        raise ValueError(f"greedy_place: no kernel for device {dev}")
    args = dict(placing=placing, table=table, e_obj=e_obj,
                size_now=size_now, missing=missing, cpus=cpus, cores=cores,
                load0=load0, tally=tally)
    for name, x in args.items():
        if x.dtype is not _DTYPES[name]:
            raise TypeError(f"greedy_place: {name!r} must be "
                            f"{_DTYPES[name]}, got {x.dtype}")
    if W > MAX_W:
        raise ValueError(f"greedy_place: W = {W} workers exceed the "
                         f"kernel's {MAX_W}")
    new_pw = torch.empty((R, T), dtype=torch.int64, device=dev)
    if R == 0 or T == 0:
        return new_pw
    if W == 0:
        raise ValueError("greedy_place: no worker to place on (W = 0)")
    if not tally.is_contiguous():
        raise ValueError("greedy_place: 'tally' must be contiguous (the "
                         "kernel adds to it in place)")
    ins = [x if x.is_contiguous() else x.contiguous()
           for x in (placing, table, e_obj, size_now, missing, cpus, cores,
                     load0)]
    with on_device(dev):
        err = _launcher()(*(x.data_ptr() for x in ins),
                          new_pw.data_ptr(), tally.data_ptr(),
                          R, T, D, E, O, W, raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"greedy_place launch failed: CUDA error {err} "
                           f"(R={R}, T={T}, D={D}, W={W})")
    LAUNCHES.add()
    return new_pw
