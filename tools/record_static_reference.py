"""Record the reference package's values that ``chip_smoke.py`` holds
the port's static simulator and ``genetic-vec`` against.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/record_static_reference.py

Runs JAX on the CPU and prints, as Python literals, the constants
``STATIC_FULL_WIDTH`` and ``GENETIC_VEC`` of ``chip_smoke.py``:

* ``STATIC_FULL_WIDTH``: the full grid's T512 bucket (fork1,
  size_stairs, crossvx, epigenomics-204-s0) on 32x4.  For each of the
  five static schedulers and each bandwidth (100 and 512 MiB/s) the
  reference's bucket scheduler places every graph of the padded bucket
  from its exact estimates (seed 0), and its static simulator runs the
  40 schedules in one ``jax.vmap`` call with full-coverage frontier caps
  ``(E, T)``: ``(ok, n_events, n_steps, makespan, transferred)`` per
  ``(scheduler, bandwidth in MiB/s, graph)``.
* ``GENETIC_VEC``: the reference event loop on ``fastcrossv`` at 32x4
  (maxmin, 100 MiB/s) with ``make_scheduler("genetic-vec", seed=0)``
  at its defaults (population 32) and with ``generations=2``: the
  report's makespan and each task's worker.

It imports the reference package; the port never imports it.
"""
from __future__ import annotations

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp

from repro.core import (MiB, Simulator, make_scheduler, parse_cluster,
                        resolve_workers)
from repro.core.graphs import encode_graph_batch, make_graph, survey_names
from repro.core.imodes import encode_imode
from repro.core.vectorized import build
from repro.core.vectorized.specs import BucketedGraphSpec, pad_to

SCHEDULERS = ("blevel", "tlevel", "mcp", "etf", "random")
BANDWIDTHS_MIB = (100, 512)


def static_full_width():
    encoded, groups = encode_graph_batch(survey_names(3), seed=0,
                                         bucket=True)
    grp = next(g for g in groups if g.shape[0] == 512)
    T, O, E = grp.shape
    cores = np.asarray(parse_cluster("32x4"), np.int32)
    est = [encode_imode(encoded[n][0], "exact") for n in grp.names]
    D = np.stack([pad_to(d, T) for d, _ in est])
    S = np.stack([pad_to(s, O) for _, s in est])
    keys, rows_b, rows_a, rows_p, rows_bw = [], [], [], [], []
    for sched in SCHEDULERS:
        fn = build(None, n_workers=32, cores=cores, scheduler=sched)
        for mib in BANDWIDTHS_MIB:
            bw = np.full(len(grp.names), mib * MiB, np.float32)
            aw, prio = jax.jit(jax.vmap(
                lambda s, d, z, b: fn(s, d, z, b, jnp.int32(0))))(
                grp.batch, D, S, bw)
            for b, name in enumerate(grp.names):
                keys.append((sched, mib, name))
                rows_b.append(b)
                rows_a.append(np.asarray(aw[b]))
                rows_p.append(np.asarray(prio[b]))
                rows_bw.append(np.float32(mib * MiB))
    spec_rows = BucketedGraphSpec(*(
        np.asarray(getattr(grp.batch, f.name))[rows_b]
        for f in dataclasses.fields(BucketedGraphSpec)))
    sim = build(None, n_workers=32, cores=cores, frontier_caps=(E, T))
    res = jax.jit(jax.vmap(lambda s, a, p, b: sim(s, a, p, None, None, b)))(
        spec_rows, np.stack(rows_a), np.stack(rows_p), np.stack(rows_bw))
    out = {}
    for i, key in enumerate(keys):
        out[key] = (bool(res.ok[i]), int(res.n_events[i]),
                    int(res.n_steps[i]), float(res.makespan[i]),
                    float(res.transferred[i]))
    return out


def genetic_vec():
    g = make_graph("fastcrossv", seed=0)
    out = {}
    for gens in (16, 2):
        kw = {} if gens == 16 else dict(generations=gens)
        rep = Simulator(g, resolve_workers(parse_cluster("32x4")),
                        make_scheduler("genetic-vec", seed=0, **kw)).run()
        out[gens] = (rep.makespan,
                     [rep.task_records[t].worker for t in g.tasks])
    return out


def main():
    print("STATIC_FULL_WIDTH = {")
    for key, val in static_full_width().items():
        print(f"    {key!r}: {val!r},")
    print("}")
    print("GENETIC_VEC = {")
    for gens, (ms, workers) in genetic_vec().items():
        print(f"    {gens}: ({ms!r}, {workers!r}),")
    print("}")


if __name__ == "__main__":
    main()
