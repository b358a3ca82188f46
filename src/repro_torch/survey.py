"""Paper-grid survey on the PyTorch port — the port's entry point.

Sweeps the (graph family x cluster x bandwidth x netmodel x scheduler x
imode x msd) grid of ``benchmarks/survey.py`` through the port's
batched dynamic simulator.  Graphs are padded into shape buckets,
clusters into worker-count buckets (``w_bucket``), and the grid is
grouped by (bucket, padded W, scheduler, netmodel): one
``BucketedGridRunner`` call per group runs the whole [clusters x graphs
x points] sub-grid as rows of one batched simulation.

It writes the estee-schema CSV of the reference survey::

    graph_name, cluster_name, bandwidth, netmodel, scheduler_name,
    imode, min_sched_interval, time, total_transfer, dataset

into ``results/survey_torch.csv``, and the agreement/speedup rows of
the reference (columns ``AGREE_SCHEMA``) into
``results/survey_agreement_torch.csv``: for each graph of the first
cluster group on the first netmodel, the batched makespan against the
reference event loop (``core.simulator``) running the scheduler's
deterministic twin (``REF_TWIN``) on the unpadded cluster, and one
``__pergraph_path__`` row timing one ``DynamicGridRunner`` per graph
against the one bucketed runner.

The graph axis is a dataset (``--dataset``): ``default`` keeps the
per-family survey representatives under the tuned ``specs.T_EDGES``,
and a named ``workloads`` manifest (``wfcommons-mini``) sweeps its
instances under bucket edges derived from the dataset itself
(``workloads.compute_bucket_edges``).

The reference compiles one program per group and gates the count
(``check_compiles``, ``--assert-compiles``).  The port's counterpart of
that program is the CUDA graph of the event step, captured once per
simulator call (``engine.capture_counter``): ``--assert-compiles``
gates captures == simulator calls (one per group, or one per chunk
with ``--engine sharded``; nothing is captured on the CPU, so the gate
fails there).  The ``compile_count`` column holds the captures of a
bucket row's first call (B for ``__pergraph_path__``) and
``total_compiles`` the captures of the whole grid.  ``--engine
sharded`` streams each group's rows in chunks of ``--stream-rows``
(``ShardedGridRunner``); with ``--devices n`` above 1, under ``torchrun
--nproc-per-node n``, each group's rows are split over the n ranks, one
card each (``main`` starts a gloo group from torchrun's environment).
Every rank walks the same groups in the same order and holds the whole
result; rank 0 alone writes the CSVs and runs the reference twins and
per-graph runners of the agreement pass, while the others wait, and
``--assert-compiles`` gates every rank's own captures.

CLI (runs on the CUDA card unless told otherwise)::

    PYTHONPATH=src python -m repro_torch.survey --mini
    PYTHONPATH=src python -m repro_torch.survey --mini \
        --dataset wfcommons-mini
    PYTHONPATH=src python -m repro_torch.survey --full --no-agreement
    PYTHONPATH=src python -m repro_torch.survey --mini --engine sharded \
        --stream-rows 32 --assert-compiles
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.survey \
        --mini --engine sharded --devices 2 --assert-compiles
"""
from __future__ import annotations

import argparse
import csv
import math
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .core import (MiB, Simulator, make_scheduler, parse_cluster,
                   resolve_workers, w_bucket)
from .core.graphs import encode_graph_batch, make_graph, survey_names
from .core.vectorized import (DynamicGridRunner, capture_counter,
                               make_grid_runner)
from .core.vectorized.engine import grid_mesh, rank_device
from .launch.mesh import GRID_TIMEOUT, grid_host_group

SCHEMA = ("graph_name", "cluster_name", "bandwidth", "netmodel",
          "scheduler_name", "imode", "min_sched_interval", "time",
          "total_transfer", "dataset")

AGREE_SCHEMA = ("graph_name", "scheduler_name", "cluster_name", "netmodel",
                "bucket", "group_size", "compile_count", "makespan_ratio",
                "vec_us_per_sim", "ref_us_per_sim", "speedup",
                "bucket_cold_s", "pergraph_cold_s", "total_compiles",
                "bucket_groups", "dataset")

OUT_DIR = os.environ.get("SURVEY_OUT", "results")

# the vectorized schedulers' deterministic twins in the reference event
# loop (core.schedulers.det), for the agreement/speedup rows
REF_TWIN = {"blevel": "blevel-det", "tlevel": "tlevel-det",
            "mcp": "mcp-det", "etf": "etf-det", "random": "random-det",
            "greedy": "greedy"}

# CI-sized: 1 graph per family (all four representatives share the T160
# shape bucket), 2 clusters incl. one heterogeneous
MINI_GRID = dict(
    dataset="default",
    graphs_per_family=1,
    clusters=("8x4", "1x8+4x2"),
    bandwidths_mib=(32, 256),
    netmodels=("maxmin", "simple"),
    schedulers=("blevel", "random", "etf", "greedy"),
    imodes=("exact", "user"),
    msds=(0.0, 0.1),
)

FULL_GRID = dict(
    dataset="default",
    graphs_per_family=3,
    clusters=("8x4", "16x4", "32x4", "1x8+4x2"),
    bandwidths_mib=(32, 128, 512, 2048),
    netmodels=("maxmin", "simple"),
    schedulers=("blevel", "tlevel", "mcp", "random", "etf", "greedy"),
    imodes=("exact", "user", "mean"),
    msds=(0.0, 0.1),
)


def grid_points(grid):
    """The (bandwidth x imode x msd) batch every runner executes in one
    call.  Static schedulers ignore msd beyond the initial invocation;
    greedy is genuinely rate-limited by it."""
    return [dict(bandwidth=bw * MiB, imode=im, msd=m,
                 decision_delay=0.05 if m > 0 else 0.0)
            for bw in grid["bandwidths_mib"]
            for im in grid["imodes"]
            for m in grid["msds"]]


def dataset_axis(grid):
    """The grid's graph axis: ``(dataset_name, graph_items, t_edges)``.
    The ``default`` dataset is the per-family representative slice under
    the tuned ``specs.T_EDGES`` (``t_edges=None``); a named manifest is
    built once, its bucket edges derived from the built graphs, and the
    prebuilt ``(name, graph)`` pairs handed to ``encode_graph_batch``."""
    ds = grid.get("dataset", "default")
    if ds == "default":
        return ds, survey_names(grid["graphs_per_family"]), None
    from .workloads import build_dataset, compute_bucket_edges, get_manifest

    man = get_manifest(ds)
    graphs = build_dataset(man)
    return ds, list(graphs.items()), compute_bucket_edges(
        graphs, k=man.bucket_k)


def cluster_groups(cluster_names):
    """Group cluster names by padded worker count: ``[(W, [name, ...],
    cores i32[K, W]), ...]`` ordered by W."""
    by_w = {}
    for cname in cluster_names:
        by_w.setdefault(w_bucket(len(parse_cluster(cname))),
                        []).append(cname)
    out = []
    for wb in sorted(by_w):
        names = by_w[wb]
        cores2d = np.stack([
            np.pad(np.asarray(parse_cluster(n), np.int32),
                   (0, wb - len(parse_cluster(n))))
            for n in names])
        out.append((wb, names, cores2d))
    return out


def full_frontier_caps(shape):
    """Ready-frontier capacities that cover the whole bucket, ``(E, T)``:
    the frontiers can never overflow, and results equal the
    shape-derived caps' wherever those do not overflow.  The survey
    uses them because the derived caps of the T512 bucket overflow on
    ``crossvx`` at 32x4 (the reference package's too)."""
    T, _O, E = shape
    return (E, T)


def estee_rows(gname, cname, netmodel, scheduler, points, ms, xfer,
               dataset="default"):
    """Map one graph's batched results onto the estee CSV schema."""
    rows = []
    for p, m, x in zip(points, ms, xfer, strict=True):
        rows.append({
            "graph_name": gname,
            "cluster_name": cname,
            "bandwidth": p["bandwidth"] / MiB,
            "netmodel": netmodel,
            "scheduler_name": scheduler,
            "imode": p["imode"],
            "min_sched_interval": p["msd"],
            "time": float(m),
            "total_transfer": float(x),
            "dataset": dataset,
        })
    return rows


def time_reference_twin(graph_name, scheduler, workers, cores, points,
                        netmodel="maxmin", graph_seed=0):
    """The reference event loop running the deterministic twin of
    ``scheduler`` over ``points``: ``(reports, us_per_sim)``, the wall
    time on the host's clock (the loop is host Python).  ``cores`` may
    be a scalar or a per-worker list (heterogeneous cluster)."""
    g = make_graph(graph_name, seed=graph_seed)
    cores_l = (list(cores) if hasattr(cores, "__len__")
               else [cores] * workers)
    t0 = time.perf_counter()
    reps = []
    for p in points:
        sched = make_scheduler(REF_TWIN[scheduler], seed=p.get("seed", 0))
        ws = resolve_workers(list(cores_l))
        reps.append(Simulator(
            g, ws, sched, netmodel=netmodel,
            bandwidth=p.get("bandwidth", 100 * MiB),
            imode=p.get("imode", "exact"), msd=p.get("msd", 0.0),
            decision_delay=p.get("decision_delay", 0.0)).run())
    wall = time.perf_counter() - t0
    return reps, wall / len(points) * 1e6


def agreement_pass(grid, points, encoded, groups, runners, stats, dev,
                   lead=True):
    """Agreement/speedup rows for the first (cluster group, netmodel):
    per (graph, first cluster) the bucketed makespan at the first point
    against the reference twin on the unpadded cluster, per group the
    warm batched time per simulation, and one ``__pergraph_path__`` row
    timing one ``DynamicGridRunner`` per graph of the first bucket
    (first call each) against the bucketed runner's first call.  The
    per-graph runners keep the spec-derived frontier caps of the
    reference; no grid of this module overflows them there (the first
    cluster group's W is 8).  Every clock read follows a device
    synchronisation.  The warm group runs are the grid runners' calls,
    which every rank of a split grid joins; the rest runs on the
    ``lead`` rank alone, and the others return no rows."""
    netmodel = grid["netmodels"][0]
    warm = {}
    for sched in grid["schedulers"]:
        for gi in range(len(groups)):
            runner, _, cnames, _ = runners[(sched, netmodel, gi)]
            _sync(dev)
            t0 = time.perf_counter()
            res = runner(points)                 # warm, steady state
            _sync(dev)
            n_sims = len(cnames) * runner.B * len(points)
            warm[(sched, gi)] = (res, (time.perf_counter() - t0)
                                 / n_sims * 1e6)
    if not lead:
        return []
    agree_rows = []
    for sched in grid["schedulers"]:
        for gi, grp in enumerate(groups):
            runner, _, cnames, captures = runners[(sched, netmodel, gi)]
            cname = cnames[0]
            cores = parse_cluster(cname)
            res, vec_us = warm[(sched, gi)]
            for b, gname in enumerate(grp.names):
                reps, ref_us = time_reference_twin(
                    gname, sched, len(cores), cores, points[:1],
                    netmodel=netmodel)
                agree_rows.append({
                    "graph_name": gname, "scheduler_name": sched,
                    "cluster_name": cname, "netmodel": netmodel,
                    "bucket": grp.label, "group_size": runner.B,
                    "compile_count": captures,
                    "makespan_ratio": (float(res.makespan[0, b, 0])
                                       / reps[0].makespan),
                    "vec_us_per_sim": vec_us,
                    "ref_us_per_sim": ref_us,
                    "speedup": ref_us / vec_us,
                    "dataset": stats["dataset"],
                })
    # the bucketing row: B per-graph runners, each paying its first call,
    # against the one bucketed runner's first call
    sched = grid["schedulers"][0]
    grp = groups[0]
    runner, bucket_cold, cnames, _ = runners[(sched, netmodel, 0)]
    cores = parse_cluster(cnames[0])
    _sync(dev)
    t0 = time.perf_counter()
    with capture_counter() as cc:
        for gname in grp.names:
            g, spec = encoded[gname]
            DynamicGridRunner(g, sched, len(cores), cores,
                              netmodel=netmodel, spec=spec,
                              device=dev)(points)
    _sync(dev)
    pergraph_cold = time.perf_counter() - t0
    agree_rows.append({
        "graph_name": "__pergraph_path__", "scheduler_name": sched,
        "cluster_name": cnames[0], "netmodel": netmodel,
        "bucket": grp.label, "group_size": runner.B,
        "compile_count": cc.captures,
        "bucket_cold_s": bucket_cold,
        "pergraph_cold_s": pergraph_cold,
        "speedup": pergraph_cold / bucket_cold,
        "total_compiles": stats["captures"],
        "bucket_groups": stats["bucket_groups"],
        "dataset": stats["dataset"],
    })
    return agree_rows


def survey(grid, out_dir=OUT_DIR, device="cuda", agreement=True,
           engine="vmap", devices=None, stream_rows=None):
    """Run the whole grid on ``device``; returns ``(rows, agree_rows,
    stats)`` and writes ``survey_torch.csv`` (and, with ``agreement``,
    ``survey_agreement_torch.csv``) under ``out_dir``.  ``stats`` counts
    groups, simulations and processed events, the simulator calls and
    CUDA graph captures of the grid (``sim_calls``, ``captures``), the
    wall time of the simulator calls (``wall_s``) and of the agreement
    pass (``agreement_s``), each on the host's clock between device
    synchronisations.  ``engine``, ``devices`` and ``stream_rows`` pick
    the grid runner (``make_grid_runner``): ``engine="sharded"`` with
    ``devices`` above 1 (or ``None`` under a started group) splits each
    group's rows over the ranks of the default group, which all call
    ``survey`` alike; ``stats["ranks"]`` and ``stats["rank"]`` say which,
    rank 0 alone writes the CSVs, and every rank returns the same rows.
    The other ranks' ``agree_rows`` are empty."""
    mesh = grid_mesh(devices) if engine == "sharded" else None
    group = None if mesh is None else grid_host_group(mesh)
    rank = 0 if group is None else dist.get_rank(group)
    dev = rank_device(device, mesh)
    points = grid_points(grid)
    dataset, names, t_edges = dataset_axis(grid)
    encoded, groups = encode_graph_batch(names, seed=0, bucket=True,
                                         t_edges=t_edges)
    wgroups = cluster_groups(grid["clusters"])
    rows = []
    runners = {}                 # only the agreement slice is retained
    stats = dict(groups=0, sims=0, events=0, wall_s=0.0, all_ok=True,
                 sim_calls=0, captures=0, engine=engine,
                 ranks=1 if group is None else dist.get_world_size(group),
                 rank=rank, mesh=mesh, device=str(dev), dataset=dataset,
                 t_edges=("T_EDGES" if t_edges is None else tuple(t_edges)),
                 buckets=[f"{grp.label}:{','.join(grp.names)}"
                          for grp in groups],
                 cluster_groups=[f"W{wb}:{','.join(cn)}"
                                 for wb, cn, _ in wgroups],
                 bucket_groups=(len(wgroups) * len(grid["schedulers"])
                                * len(grid["netmodels"]) * len(groups)))
    est_caches = [{} for _ in groups]
    for wb, cnames, cores2d in wgroups:
        for sched in grid["schedulers"]:
            for netmodel in grid["netmodels"]:
                for gi, grp in enumerate(groups):
                    runner = make_grid_runner(
                        [encoded[n] for n in grp.names], sched, wb, cores2d,
                        netmodel=netmodel, shape=grp.shape, batch=grp.batch,
                        est_cache=est_caches[gi], device=dev,
                        frontier_caps=full_frontier_caps(grp.shape),
                        engine=engine, devices=devices, mesh=mesh,
                        stream_rows=stream_rows)
                    _sync(dev)
                    t0 = time.perf_counter()
                    with capture_counter() as cc:
                        res = runner(points)             # [K, B, N]
                    _sync(dev)
                    cold_s = time.perf_counter() - t0
                    stats["wall_s"] += cold_s
                    stats["groups"] += 1
                    stats["sim_calls"] += cc.calls
                    stats["captures"] += cc.captures
                    stats["sims"] += int(res.ok.size)
                    stats["events"] += int(res.n_events.sum())
                    stats["all_ok"] &= bool(res.ok.all())
                    if (wb == wgroups[0][0]
                            and netmodel == grid["netmodels"][0]):
                        runners[(sched, netmodel, gi)] = (
                            runner, cold_s, cnames, cc.captures)
                    for k, cname in enumerate(cnames):
                        for b, gname in enumerate(grp.names):
                            rows.extend(estee_rows(
                                gname, cname, netmodel, sched, points,
                                res.makespan[k, b], res.transferred[k, b],
                                dataset=dataset))
    stats["events_per_s"] = (stats["events"] / stats["wall_s"]
                             if stats["wall_s"] > 0 else 0.0)
    stats["diagnose"] = _make_diagnose(runners, grid, points)
    agree_rows = []
    stats["agreement_s"] = 0.0
    if agreement:
        _sync(dev)
        t0 = time.perf_counter()
        agree_rows = agreement_pass(grid, points, encoded, groups, runners,
                                    stats, dev, lead=rank == 0)
        _sync(dev)
        stats["agreement_s"] = time.perf_counter() - t0
    stats["csv"] = os.path.join(out_dir, "survey_torch.csv")
    stats["agreement_csv"] = os.path.join(out_dir,
                                          "survey_agreement_torch.csv")
    if rank == 0:
        _write_csv(stats["csv"], rows, SCHEMA)
        _write_csv(stats["agreement_csv"], agree_rows, AGREE_SCHEMA)
    if group is not None:
        dist.barrier(group=group)       # the CSVs are written
    return rows, agree_rows, stats


def _write_csv(path, rows, fieldnames):
    """``path`` with the given columns (not written when there are no
    rows, as in the reference)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if rows:
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(fieldnames))
            w.writeheader()
            w.writerows(rows)


def _make_diagnose(runners, grid, points):
    """A lazy closure over the first retained runner that records one
    event step of its simulator for bucket member 0 vs 1 (and cluster row
    0 vs 1) and diffs the op traces — ``repro_torch.analysis
    .diff_traces``.  Called only when ``check_compiles`` is about to fail,
    so the AssertionError can name the first divergent op (or blame the
    Python side when the steps are identical)."""
    key = (grid["schedulers"][0], grid["netmodels"][0], 0)
    if key not in runners:
        return None
    runner = runners[key][0]

    def diagnose():
        from .analysis import diff_traces
        D, S = runner._estimates("exact")
        dev = runner.device
        bw = points[0].get("bandwidth", 100 * MiB) if points else 100 * MiB

        def args(b, k):
            def t(x, dtype):
                return torch.as_tensor(np.asarray(x), dtype=dtype,
                                       device=dev)
            return (runner._bspec_dev.map(lambda x: x[b:b + 1]),
                    t(D[b:b + 1], torch.float32),
                    t(S[b:b + 1], torch.float32), t([0.0], torch.float32),
                    t([0.0], torch.float32), t([bw], torch.float32),
                    t([0], torch.int64),
                    t(runner.clusters[k:k + 1], torch.int64))

        parts = []
        if runner.B > 1:
            parts.append("graph axis (bucket member 0 vs 1):\n"
                         + diff_traces(runner.run, args(0, 0), args(1, 0),
                                       labels=(runner.names[0],
                                               runner.names[1])))
        if runner.clusters.shape[0] > 1:
            parts.append("cluster axis (row 0 vs 1):\n"
                         + diff_traces(runner.run, args(0, 0), args(0, 1),
                                       labels=("cluster0", "cluster1")))
        return "\n".join(parts) if parts else \
            "single-graph, single-cluster group: nothing to diff"

    return diagnose


def check_compiles(stats):
    """The one-program-per-simulator-call contract: every simulator call
    of the grid (one per group, or one per chunk) captured its event
    step in exactly one CUDA graph.  On a grid split over ranks, each
    rank's own calls and captures, with the verdict taken over all
    ranks: every rank raises if any fails.  A mismatch names its cause
    through ``stats["diagnose"]`` (``_make_diagnose``) when the survey
    left one."""
    counts = [(stats["captures"], stats["sim_calls"], stats["groups"])]
    if stats.get("mesh") is not None:
        mine = torch.tensor(counts[0], dtype=torch.int64)
        got = [torch.empty_like(mine) for _ in range(stats["ranks"])]
        dist.all_gather(got, mine, group=grid_host_group(stats["mesh"]))
        counts = [tuple(int(x) for x in g) for g in got]
    bad = [r for r, (cap, calls, groups) in enumerate(counts)
           if cap != calls or calls < groups]
    if bad:
        msg = "; ".join(
            f"rank {r}: CUDA graph captures {counts[r][0]} != simulator "
            f"calls {counts[r][1]} over {counts[r][2]} groups" for r in bad)
        msg += (f" (engine {stats['engine']}, device {stats['device']}; "
                f"the CPU runs every step eagerly and captures nothing)")
        diagnose = stats.get("diagnose")
        if diagnose is not None and stats.get("rank", 0) in bad:
            try:
                msg += ("\nrecompile diagnosis (repro_torch.analysis):\n"
                        + diagnose())
            except Exception as e:  # diagnosis must never mask the gate
                msg += f"\n(recompile diagnosis itself failed: {e!r})"
        raise AssertionError(msg)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def geomean(xs):
    xs = [max(x, 1e-12) for x in xs]
    return math.exp(sum(math.log(x) for x in xs) / len(xs))


def report(rows, agree_rows, stats):
    """Print the reference's ``name,us_per_call,derived`` rows."""
    for a in agree_rows:
        if a["graph_name"] == "__pergraph_path__":
            print(f"survey/bucket_vs_pergraph_cold,"
                  f"{a['bucket_cold_s'] * 1e6:.0f},{a['speedup']:.2f}")
            continue
        print(f"survey/agree_{a['graph_name']}/{a['scheduler_name']},"
              f"{a['ref_us_per_sim']:.0f},{a['makespan_ratio']:.4f}")
        print(f"survey/speedup_{a['graph_name']}/{a['scheduler_name']},"
              f"{a['vec_us_per_sim']:.0f},{a['speedup']:.1f}")
    plain = [a for a in agree_rows if a["graph_name"] != "__pergraph_path__"]
    if plain:
        print(f"survey/speedup_geomean,0,"
              f"{geomean([a['speedup'] for a in plain]):.2f}")
    print(f"survey/sim_calls,0,{stats['sim_calls']}")
    print(f"survey/graph_captures,0,{stats['captures']}")
    print(f"survey/bucket_groups,0,{stats['bucket_groups']}")
    print(f"survey/cluster_groups,0,{len(stats['cluster_groups'])}")
    print(f"survey/rows,0,{len(rows)}")
    print(f"# dataset {stats['dataset']}: t_edges={stats['t_edges']}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--mini", action="store_true",
                      help="CI-sized grid (default)")
    mode.add_argument("--full", action="store_true",
                      help="paper-scale grid (slow)")
    ap.add_argument("--dataset", default="default",
                    help="graph-axis dataset: 'default' (per-family "
                         "survey representatives, tuned T_EDGES) or a "
                         "workloads manifest name (e.g. 'wfcommons-mini') "
                         "with bucket edges derived from the dataset")
    ap.add_argument("--no-agreement", action="store_true",
                    help="skip the reference-loop agreement/speedup pass")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default 'cuda'; 'cpu' runs the "
                         "plain PyTorch path)")
    ap.add_argument("--out", default=OUT_DIR,
                    help=f"output directory (default {OUT_DIR!r})")
    ap.add_argument("--assert-compiles", action="store_true",
                    help="fail unless every simulator call captured its "
                         "event step in one CUDA graph (one per group, or "
                         "one per chunk)")
    ap.add_argument("--engine", choices=("vmap", "sharded"), default="vmap",
                    help="grid executor: one simulator call per group "
                         "(default) or the streaming engine, one call per "
                         "chunk of --stream-rows rows")
    ap.add_argument("--devices", type=int, default=None,
                    help="sharded engine: number of ranks, one card each "
                         "(above 1: run under torchrun --nproc-per-node "
                         "n; default the started group, or one card)")
    ap.add_argument("--stream-rows", type=int, default=None,
                    help="sharded engine: double-buffered chunk size in "
                         "grid rows (default: a group's rows in one chunk)")
    args = ap.parse_args(argv)
    grid = dict(FULL_GRID if args.full else MINI_GRID, dataset=args.dataset)
    # under torchrun: one rank per card, gathered over gloo
    started = (args.engine == "sharded" and (args.devices or 1) > 1
               and "WORLD_SIZE" in os.environ and not dist.is_initialized())
    if started:
        dist.init_process_group("gloo", timeout=GRID_TIMEOUT)
    try:
        return _main(args, grid)
    finally:
        if started:
            dist.destroy_process_group()


def _main(args, grid):
    rows, agree_rows, stats = survey(grid, out_dir=args.out,
                                     device=args.device,
                                     agreement=not args.no_agreement,
                                     engine=args.engine, devices=args.devices,
                                     stream_rows=args.stream_rows)
    if stats["rank"] == 0:
        report(rows, agree_rows, stats)
    print(f"# survey_torch[{stats['dataset']}/{stats['device']}"
          f"{_rank_tag(stats)}]: "
          f"{len(rows)} grid points, {stats['groups']} groups "
          f"({'; '.join(stats['buckets'])}; "
          f"{'; '.join(stats['cluster_groups'])}; engine {stats['engine']}"
          f"), {stats['events']} events "
          f"in {stats['wall_s']:.2f}s ({stats['events_per_s']:.1f} "
          f"events/s), agreement pass {stats['agreement_s']:.2f}s "
          f"-> {stats['csv']}")
    if args.assert_compiles:
        try:
            check_compiles(stats)
        except AssertionError as e:
            print(f"error: {e}", file=sys.stderr)
            sys.exit(1)
        print(f"# compile-count assertion passed{_rank_tag(stats)}: "
              f"{stats['captures']} captures == {stats['sim_calls']} "
              f"simulator calls")


def _rank_tag(stats):
    return (f" rank {stats['rank']} of {stats['ranks']}"
            if stats["ranks"] > 1 else "")


if __name__ == "__main__":
    main()
