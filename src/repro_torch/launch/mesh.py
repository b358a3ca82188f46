"""Production mesh builders, as ``DeviceMesh``es over the default process
group.

A pod is modelled as a ``(data=16, model=16)`` mesh of 256 cards; the
multi-pod dry run prepends a ``pod`` axis (2 pods = 512 cards), the
reference's shapes and axis names.  The ``pod`` axis is pure data
parallelism by default.

A mesh takes the first ``prod(shape)`` ranks of the default group, which
must exist and be at least that large: on one machine the dry run
(``launch/dryrun.py``) starts a fake group of 256 or 512 ranks first.
Functions, not module constants: importing this module starts no process
group and touches no device.

The survey's grid engine gathers its results on the host: each rank's
share of a grid is a few KB, and two ranks of the port's test
arrangement share one card, which NCCL refuses ("Duplicate GPU
detected").  So ``grid_host_group`` gives the engine a gloo group over
the grid mesh's ranks, whatever the default group's backend, made once
per set of ranks and cached, with a finite timeout (``GRID_TIMEOUT``):
a rank that fails leaves the others waiting that long at most.  No
NCCL communicator is made on that path.
"""
from __future__ import annotations

import datetime
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def _mesh(shape, axes, device_type, hint):
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(f"need {n} ranks for mesh {tuple(shape)}, the "
                           f"default process group has {have} — {hint}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    return _mesh(shape, axes, device_type,
                 "run under repro_torch.launch.dryrun (which starts a fake "
                 "process group of that size)")


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   device_type: str = "cuda") -> DeviceMesh:
    n = math.prod(shape)
    return _mesh(shape, axes, device_type,
                 f"start a group of {n} ranks first (torch.distributed."
                 f"init_process_group with world_size={n}, or the fake "
                 f"backend for planning)")


def make_grid_mesh(n: int | None = None,
                   device_type: str = "cuda") -> DeviceMesh:
    """1-D mesh over a single ``"grid"`` axis, the sharded survey
    engine's data-parallel layout.  ``n=None`` takes every rank of the
    default group."""
    if n is None:
        n = dist.get_world_size() if dist.is_initialized() else 0
    if n < 1:
        raise RuntimeError("need at least 1 rank for a 1-D grid mesh, the "
                           "default process group has none — start one "
                           "first")
    return _mesh((n,), ("grid",), device_type,
                 f"start a group of {n} ranks first")


# how long a rank of the grid engine waits for the others in a collective
GRID_TIMEOUT = datetime.timedelta(minutes=10)

_HOST_GROUPS: dict = {}


def grid_ranks(mesh: DeviceMesh) -> list[int]:
    """The global ranks along ``mesh``'s ``"grid"`` dim through this
    rank, in grid order."""
    grid = mesh if mesh.ndim == 1 else mesh["grid"]
    return [int(r) for r in grid.mesh.flatten().tolist()]


def grid_host_group(mesh: DeviceMesh):
    """A gloo group over ``grid_ranks(mesh)``, made once per set of ranks
    (of the current default group) and cached.  Only those ranks call
    ``new_group`` (local synchronisation), so a rank outside the grid
    need not."""
    ranks = tuple(grid_ranks(mesh))
    key = (dist.group.WORLD, ranks)
    group = _HOST_GROUPS.get(key)
    if group is None:
        group = dist.new_group(list(ranks), timeout=GRID_TIMEOUT,
                               backend="gloo",
                               use_local_synchronization=True)
        _HOST_GROUPS[key] = group
    return group


def dp_axes(mesh: DeviceMesh):
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
