"""One front door for the port's vectorized simulator — the counterpart
of ``repro.core.vectorized.api``.

    from repro_torch.core.vectorized.api import build, SimConfig

    run = build(spec, n_workers=4, cores=2)            # static sim
    res = run(assignment, priority)                    # -> SimResult

    dyn = build(spec, n_workers=4, cores=2, scheduler="greedy",
                dynamic=True, config=SimConfig(msd=1.0))
    res = dyn(est_dur, est_size)                       # -> SimResult

    sched = build(spec, n_workers=4, cores=2, scheduler="blevel")
    a, p = sched(est_dur, est_size, bandwidth, seed)   # static schedule

Every entry point takes ``device`` (default ``"cuda"``) and raises when
CUDA is requested and no card is present; the CPU runs only when asked
for.  ``spec=None`` returns the late-bound bucket form (the spec becomes
the first argument).  Arguments may carry a leading row axis — one row
per simulation — in place of the reference's ``jax.vmap``.

The engine block rides ``SimConfig`` as in the reference, and only
``make_grid_runner`` dispatches on it: ``engine="sharded"`` streams the
grid's rows in chunks of ``stream_rows`` through ``engine.
ShardedGridRunner``, split over ``devices`` ranks of a started
``torch.distributed`` group (one card each; ``torchrun --nproc-per-node
n``) or over a given ``mesh``.  ``cache_dir`` has no counterpart here
and raises (``engine.py`` says why).
"""
from __future__ import annotations

import dataclasses

from ...device import resolve_device
from . import scheduling as _scheduling
from . import sim as _sim
from .specs import GraphSpec, as_bucketed, frontier_caps_for_spec


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Frozen bundle of every simulator option ``build`` accepts.  The
    fields mirror the reference's ``SimConfig``; ``msd`` /
    ``decision_delay`` / ``imode`` / ``seed`` become the *default* call
    arguments of a bound dynamic run.  ``waterfill_impl`` is ``"auto"``
    (kernel on the card, plain version on the CPU), ``"torch"`` or
    ``"cuda"``; ``check_every`` is how many simulator steps pass between
    the host's checks that a row is still live; ``step_graph`` is
    ``"auto"`` (each simulator call's event step replayed from a CUDA
    graph on the card, eager on the CPU), ``"graph"`` (raises on the
    CPU) or ``"eager"``.  The engine block: ``engine`` is ``"vmap"``
    (one batched call) or ``"sharded"`` (``stream_rows`` rows a call,
    streamed through a double-buffered queue and split over ``devices``
    ranks of the started process group, one card each: ``None`` is the
    whole group, or one card when none is started; ``engine.grid_mesh``);
    ``cache_dir`` raises."""

    flow_slots: bool | None = None
    frontier: bool | None = None
    frontier_caps: tuple[int, int] | None = None
    waterfill_impl: str = "auto"
    flow_rounds: int = 4
    max_steps: int | None = None
    msd: float = 0.0
    decision_delay: float = 0.0
    imode: str = "exact"
    seed: int = 0
    engine: str = "vmap"
    devices: int | None = None
    stream_rows: int | None = None
    cache_dir: str | None = None
    check_every: int = 16
    step_graph: str = "auto"

    def replace(self, **kwargs) -> "SimConfig":
        return dataclasses.replace(self, **kwargs)


def _merge_config(config, opts) -> SimConfig:
    cfg = SimConfig() if config is None else config
    if opts:
        unknown = set(opts) - {f.name for f in dataclasses.fields(SimConfig)}
        if unknown:
            raise TypeError(f"build() got unknown option(s) "
                            f"{sorted(unknown)}; SimConfig fields are "
                            f"{sorted(f.name for f in dataclasses.fields(SimConfig))}")
        cfg = cfg.replace(**opts)
    if cfg.engine not in ("vmap", "sharded"):
        raise TypeError(f"unknown engine {cfg.engine!r}; SimConfig.engine "
                        f"is 'vmap' or 'sharded'")
    if cfg.cache_dir is not None:
        from .engine import NO_CACHE_DIR
        raise NotImplementedError(NO_CACHE_DIR)
    return cfg


def build(spec=None, *, n_workers: int, cores=None, scheduler=None,
          netmodel: str = "maxmin", dynamic: bool = False,
          max_cores: int | None = None, config: SimConfig | None = None,
          device="cuda", **opts):
    """Build a simulator or scheduler callable on ``device``.

    Dispatch:

    * ``scheduler=None`` (default) — the **static simulator**:
      ``run(assignment, priority, durations, sizes, bandwidth, cores)
      -> SimResult`` over rows of schedules.
    * ``dynamic=True`` — the **dynamic simulator** for ``scheduler``
      (default ``"blevel"``): ``run(est_durations, est_sizes, msd,
      decision_delay, bandwidth, seed, cores) -> SimResult``.
    * ``scheduler`` given with ``dynamic=False`` — the **static
      schedule function**: ``schedule(est_durations, est_sizes,
      bandwidth, seed, cores) -> (assignment, priority)`` over rows.

    ``spec`` may be a ``GraphSpec``/``BucketedGraphSpec`` (bound now)
    or ``None`` (bucket form: the callable takes the spec first).
    Options come from ``config`` and/or keyword overrides; unknown
    options raise ``TypeError``."""
    dev = resolve_device(device)
    cfg = _merge_config(config, opts)
    bspec = None if spec is None else as_bucketed(spec)
    if (bspec is not None and cfg.frontier is not False
            and cfg.frontier_caps is None):
        # the spec is concrete, so widen the shape-derived caps to the
        # root count — all roots are ready at t=0
        cfg = cfg.replace(frontier_caps=frontier_caps_for_spec(bspec))
    if bspec is not None and cores is not None:
        # host-side guard: a task that fits no worker would stall the
        # event loop
        _sim._check_cpus_fit([bspec],
                             _scheduling._resolve_cores(n_workers, cores),
                             "build")

    if scheduler is None and not dynamic:
        brun = _sim.make_bucket_simulator(
            n_workers, cores, netmodel, cfg.flow_rounds, cfg.max_steps,
            max_cores=max_cores, flow_slots=cfg.flow_slots,
            frontier=cfg.frontier, frontier_caps=cfg.frontier_caps,
            waterfill_impl=cfg.waterfill_impl, device=dev,
            check_every=cfg.check_every, step_graph=cfg.step_graph)
        if bspec is None:
            return brun
        return lambda assignment, priority, durations=None, sizes=None, \
            bandwidth=100 * 1024 * 1024.0, cores=None: brun(
                bspec, assignment, priority, durations, sizes, bandwidth,
                cores)

    if not dynamic:
        schedule = _scheduling.rows_schedule(
            _scheduling.make_bucket_scheduler(n_workers, cores, scheduler,
                                              max_cores), dev)
        if bspec is None:
            return schedule
        return lambda est_dur, est_size, bandwidth, seed=0, cores=None: \
            schedule(bspec, est_dur, est_size, bandwidth, seed, cores)

    brun = _sim.make_bucket_dynamic_simulator(
        n_workers, cores, scheduler or "blevel", netmodel,
        cfg.flow_rounds, cfg.max_steps, max_cores=max_cores,
        flow_slots=cfg.flow_slots, frontier=cfg.frontier,
        frontier_caps=cfg.frontier_caps,
        waterfill_impl=cfg.waterfill_impl, device=dev,
        check_every=cfg.check_every, step_graph=cfg.step_graph)
    if bspec is None:
        return brun

    def run(est_durations, est_sizes, msd=cfg.msd,
            decision_delay=cfg.decision_delay,
            bandwidth=100 * 1024 * 1024.0, seed=cfg.seed, cores=None):
        return brun(bspec, est_durations, est_sizes, msd, decision_delay,
                    bandwidth, seed, cores)
    return run


def make_grid_runner(entries, scheduler, n_workers, cores, *,
                     netmodel: str = "maxmin", max_steps: int | None = None,
                     shape=None, batch=None, est_cache=None,
                     config: SimConfig | None = None, device="cuda",
                     mesh=None, **opts):
    """Engine-dispatching front door over the bucket grid runners:
    positional arguments match ``BucketedGridRunner``; options ride the
    same config/override mechanics as ``build``::

        runner = make_grid_runner(entries, "blevel", 8, cores2d,
                                  engine="sharded", stream_rows=64)
        res = runner(points)               # SimResult[K, B, N]

    ``engine="vmap"`` (default) returns a ``BucketedGridRunner`` (one
    simulator call over all ``[K, B, N]`` rows); ``engine="sharded"`` a
    ``ShardedGridRunner`` (one call per chunk of ``stream_rows`` rows,
    the same results bit for bit), over ``devices`` ranks or ``mesh``'s
    ``"grid"`` dim."""
    dev = resolve_device(device)
    cfg = _merge_config(config, opts)
    kwargs = dict(
        netmodel=netmodel,
        max_steps=cfg.max_steps if max_steps is None else max_steps,
        shape=shape, batch=batch, est_cache=est_cache, device=dev,
        waterfill_impl=cfg.waterfill_impl, flow_rounds=cfg.flow_rounds,
        flow_slots=cfg.flow_slots, frontier=cfg.frontier,
        frontier_caps=cfg.frontier_caps, check_every=cfg.check_every,
        step_graph=cfg.step_graph)
    if cfg.engine == "vmap":
        return _sim.BucketedGridRunner(entries, scheduler, n_workers, cores,
                                       **kwargs)
    from .engine import ShardedGridRunner
    return ShardedGridRunner(entries, scheduler, n_workers, cores,
                             mesh=mesh, devices=cfg.devices,
                             stream_rows=cfg.stream_rows, **kwargs)


def build_for_graph(graph, **kwargs):
    """``build`` for a ``TaskGraph``: encodes the graph first."""
    from .specs import encode_graph
    return build(encode_graph(graph), **kwargs)


__all__ = ["SimConfig", "build", "build_for_graph", "make_grid_runner",
           "GraphSpec"]
