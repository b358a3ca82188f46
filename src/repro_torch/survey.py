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

into ``results/survey_torch.csv``.  The graph axis is the default
dataset (per-family survey representatives); ``--dataset`` is not
ported yet.

CLI (runs on the CUDA card unless told otherwise)::

    PYTHONPATH=src python -m repro_torch.survey --mini
    PYTHONPATH=src python -m repro_torch.survey --full --device cuda
"""
from __future__ import annotations

import argparse
import csv
import os
import time

import numpy as np
import torch

from .core import MiB, parse_cluster, w_bucket
from .core.graphs import encode_graph_batch, survey_names
from .core.vectorized import make_grid_runner
from .device import resolve_device

SCHEMA = ("graph_name", "cluster_name", "bandwidth", "netmodel",
          "scheduler_name", "imode", "min_sched_interval", "time",
          "total_transfer", "dataset")

OUT_DIR = os.environ.get("SURVEY_OUT", "results")

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


def survey(grid, out_dir=OUT_DIR, device="cuda"):
    """Run the whole grid on ``device``; returns ``(rows, stats)`` and
    writes ``survey_torch.csv`` under ``out_dir``.
    ``stats`` counts groups, simulations, processed events and the wall
    time of the simulator calls (host clock, ended by a device sync)."""
    if grid.get("dataset", "default") != "default":
        raise NotImplementedError("only the default dataset is ported "
                                  "(ROADMAP: port workloads/datasets.py)")
    dev = resolve_device(device)
    points = grid_points(grid)
    names = survey_names(grid["graphs_per_family"])
    encoded, groups = encode_graph_batch(names, seed=0, bucket=True)
    rows = []
    stats = dict(groups=0, sims=0, events=0, wall_s=0.0, all_ok=True,
                 device=str(dev))
    est_caches = [{} for _ in groups]
    for wb, cnames, cores2d in cluster_groups(grid["clusters"]):
        for sched in grid["schedulers"]:
            for netmodel in grid["netmodels"]:
                for gi, grp in enumerate(groups):
                    runner = make_grid_runner(
                        [encoded[n] for n in grp.names], sched, wb, cores2d,
                        netmodel=netmodel, shape=grp.shape, batch=grp.batch,
                        est_cache=est_caches[gi], device=dev,
                        frontier_caps=full_frontier_caps(grp.shape))
                    _sync(dev)
                    t0 = time.perf_counter()
                    res = runner(points)                 # [K, B, N]
                    _sync(dev)
                    stats["wall_s"] += time.perf_counter() - t0
                    stats["groups"] += 1
                    stats["sims"] += int(res.ok.size)
                    stats["events"] += int(res.n_events.sum())
                    stats["all_ok"] &= bool(res.ok.all())
                    for k, cname in enumerate(cnames):
                        for b, gname in enumerate(grp.names):
                            rows.extend(estee_rows(
                                gname, cname, netmodel, sched, points,
                                res.makespan[k, b], res.transferred[k, b]))
    stats["events_per_s"] = (stats["events"] / stats["wall_s"]
                             if stats["wall_s"] > 0 else 0.0)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "survey_torch.csv")
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(SCHEMA))
        w.writeheader()
        w.writerows(rows)
    stats["csv"] = path
    return rows, stats


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--mini", action="store_true",
                      help="CI-sized grid (default)")
    mode.add_argument("--full", action="store_true",
                      help="paper-scale grid (slow)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default 'cuda'; 'cpu' runs the "
                         "plain PyTorch path)")
    ap.add_argument("--out", default=OUT_DIR,
                    help=f"output directory (default {OUT_DIR!r})")
    args = ap.parse_args(argv)
    grid = FULL_GRID if args.full else MINI_GRID
    rows, stats = survey(grid, out_dir=args.out, device=args.device)
    print(f"# survey_torch[{stats['device']}]: {len(rows)} grid points, "
          f"{stats['groups']} groups, {stats['events']} events in "
          f"{stats['wall_s']:.2f}s ({stats['events_per_s']:.1f} events/s) "
          f"-> {stats['csv']}")


if __name__ == "__main__":
    main()
