"""What one cell of the benchmark runs, found by name, and the calls into
the program that its window times.

A cell of ``BENCHMARK.json`` names a configuration
(``configs/<name>.json``: the graphs, clusters and grid points of one
deployment) and a traffic mix (``traffic/<name>.json``: scheduler,
netmodel, which points, and the shape of a call).  Two shapes of
traffic exist, both closed loops of one client:

* ``grid`` -- each call is one shape bucket of the configuration's
  graphs x all of its clusters x the points, one batched simulator call
  built by ``make_grid_runner`` as the survey builds a group; the graphs
  are encoded once in set-up and the calls cycle over the buckets;
* ``proto`` -- each request encodes one graph, builds its runner on one
  cluster and runs the points; requests cycle over the (graph, cluster)
  pairs.

Inputs are made here from ``--seed`` (``reference.generators``), and
the same graph objects go to the program and to the reference.  The
program is imported lazily (``program()``), so that the reference and
the tests of this folder load without it.
"""
from __future__ import annotations

import itertools
import json
import sys
import time
from pathlib import Path

import numpy as np

from .reference import encode as enc
from .reference import generators as gen

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MiB = 1024.0 * 1024.0
# steps of a grid bucket's warm-up call: past step 0 and the capture,
# enough to load every kernel and fill the allocator's pools
WARMUP_STEPS = 48


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _load(root / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> dict:
    """The workload entry ``name`` of ``root``'s ``BENCHMARK.json`` with
    its configuration and traffic files loaded (``config_data``,
    ``traffic_data``), the folder of the benchmark's files (``dir``)
    and the metrics it reports (``end_to_end``, ``per_layer``: the
    entries whose ``workloads`` list it, or that have none)."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = dict(cells[name])
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    w["config_data"] = _load(root / cfg["file"])
    w["dir"] = root / HERE.name
    w["traffic_data"] = _load(w["dir"] / "traffic" / f"{w['traffic']}.json")
    for kind in ("end_to_end", "per_layer"):
        w[kind] = [m for m in bench[kind]
                   if name in m.get("workloads", [name])]
    return w


def grid_points(config: dict, only: dict) -> list:
    """The configuration's (bandwidth x imode x msd) points, in that
    order, kept to the values ``only`` lists per axis."""
    bws = only.get("bandwidths_mib", config["bandwidths_mib"])
    ims = only.get("imodes", config["imodes"])
    msds = only.get("msds", config["msds"])
    return [dict(bandwidth=bw * MiB, imode=im, msd=float(m),
                 decision_delay=config["decision_delay"] if m > 0 else 0.0)
            for bw, im, m in itertools.product(bws, ims, msds)]


def cores_matrix(cluster_names) -> tuple:
    """``(W, cores i32[K, W])`` of clusters that share one padded
    worker count."""
    lists = [enc.parse_cluster(c) for c in cluster_names]
    ws = {enc.w_bucket(len(c)) for c in lists}
    if len(ws) != 1:
        raise ValueError(f"clusters {cluster_names} pad to different "
                         f"worker counts {sorted(ws)}")
    W = ws.pop()
    return W, np.stack([np.pad(np.asarray(c, np.int32), (0, W - len(c)))
                        for c in lists])


class Workload:
    """The inputs of one run of a cell: graphs drawn from ``seed``, the
    clusters and points, and what one call covers (``units``)."""

    def __init__(self, w: dict, seed: int):
        self.name = w["name"]
        self.seed = seed
        cfg, tr = w["config_data"], w["traffic_data"]
        self.kind = tr["kind"]
        if self.kind not in ("grid", "proto"):
            raise ValueError(f"traffic kind {self.kind!r} is not grid or "
                             f"proto")
        self.scheduler, self.netmodel = tr["scheduler"], tr["netmodel"]
        self.points = grid_points(cfg, tr.get("points", {}))
        self.clusters = list(cfg["clusters"])
        self.W, self.cores = cores_matrix(self.clusters)
        graphs = [gen.make_graph(cfg["dataset"], n, seed)
                  for n in cfg["graphs"]]
        self.graphs = graphs
        if self.kind == "grid":
            # one unit per shape bucket: (graph names, cluster indices)
            self.units = [(tuple(g.name for g in gs),
                           tuple(range(len(self.clusters))))
                          for _, gs in enc.buckets(graphs)]
        else:
            self.units = [((g.name,), (k,)) for g in graphs
                          for k in range(len(self.clusters))]

    def graph(self, name):
        return next(g for g in self.graphs if g.name == name)

    def rows_of(self, unit) -> int:
        names, ks = unit
        return len(names) * len(ks) * len(self.points)


def program():
    """The system under test: ``repro_torch`` from the checkout's
    ``src`` (the JAX package beside it is never imported)."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import repro_torch.core.graphs as graphs
    import repro_torch.core.vectorized as vec
    import repro_torch.kernels.waterfill as k1
    return graphs, vec, k1


class Client:
    """The program's side of a run: encodes, builds runners and calls
    them the way the survey does, and records each call's spans and
    counters (``calls``)."""

    def __init__(self, wl: Workload, device):
        self.wl = wl
        self.device = device
        self.graphs_mod, self.vec, self.k1 = program()
        self.calls = []
        self.encoded = self.groups = None
        self.est_caches = {}

    def encode(self, names):
        pairs = [(n, self.wl.graph(n)) for n in names]
        encoded, groups = self.graphs_mod.encode_graph_batch(pairs,
                                                             bucket=True)
        if len(groups) != 1:
            raise ValueError(f"{names} span {len(groups)} buckets")
        return encoded, groups[0]

    def setup(self):
        """Encode every graph once (grid traffic), as a survey does."""
        if self.wl.kind == "grid":
            names = [g.name for g in self.wl.graphs]
            pairs = [(n, self.wl.graph(n)) for n in names]
            self.encoded, self.groups = self.graphs_mod.encode_graph_batch(
                pairs, bucket=True)
            by_names = {grp.names: grp for grp in self.groups}
            self.groups = [by_names[u[0]] for u in self.wl.units]

    def _runner(self, encoded, grp, ks, est_cache, max_steps=None):
        T, _O, E = grp.shape
        return self.vec.make_grid_runner(
            [encoded[n] for n in grp.names], self.wl.scheduler, self.wl.W,
            self.wl.cores[list(ks)], netmodel=self.wl.netmodel,
            shape=grp.shape, batch=grp.batch, est_cache=est_cache,
            device=self.device, frontier_caps=(E, T), max_steps=max_steps)

    def warmup(self):
        """Every shape the window uses, once: a grid bucket's call at its
        full rows, stopped after ``WARMUP_STEPS`` steps (its results are
        dropped); a proto request of the first (graph, cluster) pair of
        each shape bucket."""
        for i in self.one_per_shape():
            if self.wl.kind == "grid":
                runner = self._runner(self.encoded, self.groups[i],
                                      self.wl.units[i][1],
                                      self.est_caches.setdefault(i, {}),
                                      max_steps=WARMUP_STEPS)
                runner.run(*runner.row_inputs(self.wl.points))
            else:
                self.call(i, record=False)
        self.sync()

    def one_per_shape(self):
        """The first unit of each shape bucket (every unit of a grid)."""
        firsts = {}
        for i, (names, _) in enumerate(self.wl.units):
            shape = enc.shape_of([self.wl.graph(n) for n in names])
            firsts.setdefault(shape, i)
        return sorted(firsts.values())

    def sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def call(self, i, record=True):
        """One call (grid) or request (proto) of unit ``i``; the host
        holds its results when it returns.  Records ``t0``/``t1``, the
        spans ``encode_s``/``build_s``/``run_s``, the loop's counters
        and the results (or the error) when ``record``."""
        unit = self.wl.units[i]
        from torch.profiler import record_function
        rec = dict(unit=i, rows=self.wl.rows_of(unit), error=None)
        launches0 = self.k1.LAUNCHES.count
        grp = None
        t0 = time.perf_counter()
        try:
            if self.wl.kind == "grid":
                encoded, grp = self.encoded, self.groups[i]
                t1 = t0
                cache = self.est_caches.setdefault(i, {})
            else:
                with record_function("perfbench.encode"):
                    encoded, grp = self.encode(unit[0])
                t1 = time.perf_counter()
                cache = None
            with record_function("perfbench.build"):
                runner = self._runner(encoded, grp, unit[1], cache)
            t2 = time.perf_counter()
            with record_function("perfbench.call"), \
                    self.vec.capture_counter() as cc:
                res = runner(self.wl.points)           # numpy [K, B, N]
            t3 = time.perf_counter()
            rec.update(result=res, ok=int(res.ok.sum()),
                       row_steps=int(res.n_steps.sum()),
                       sim_calls=cc.calls, captures=cc.captures,
                       replays=cc.replays)
        except RuntimeError as e:          # a row failed: _check_ok raises
            t1 = t2 = t3 = time.perf_counter()
            rec.update(result=None, ok=0, row_steps=0, sim_calls=0,
                       captures=0, replays=0, error=str(e)[:500])
        rec.update(t0=t0, t1=t3, encode_s=t1 - t0, build_s=t2 - t1,
                   run_s=t3 - t2,
                   k1_launches=self.k1.LAUNCHES.count - launches0)
        if record:
            self.calls.append(rec)
        return rec

    def cycle(self, record=True, units=None):
        """One call of every unit (or of ``units``), in order."""
        units = range(len(self.wl.units)) if units is None else units
        return [self.call(i, record) for i in units]

    def window(self, seconds: float):
        """Whole cycles until ``seconds`` have passed since the first
        call started: no cycle starts after that."""
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            self.cycle()
        return start, time.perf_counter()
