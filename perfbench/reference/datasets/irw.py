"""Frozen copy of estee's *irw* generators ("inspired by real workflows",
paper Table 1; estee's ``benchmarks/README.md``, zenodo
10.5281/zenodo.2630384): ``gridcat``, the cross-validation pipelines
``crossv``, ``fastcrossv``, ``crossvx`` and ``nestedcrossv``, and
``mapreduce`` cut to 48 maps x 48 reduces (``mapreduce48``; published
160 x 160).  The cross-validation graphs approximate Table 1's counts;
the published instances are on zenodo.  ``seed`` draws the durations,
sizes and ``user`` estimates; the structure is fixed per graph.

Loaded by path by ``generators.make_graph`` for a configuration whose
``dataset`` is ``irw`` (see ``datasets/__init__.py``)."""
from __future__ import annotations

import random

from perfbench.reference.generators import finish, tnormal
from perfbench.reference.taskgraph import MiB, TaskGraph


def merge_graphs(graphs, name=""):
    """Disjoint union of task graphs, tasks and objects renumbered in
    order (``crossvx``'s two instances)."""
    out = TaskGraph(name)
    for g in graphs:
        tmap = {}
        for t in g.tasks:
            nt = out.new_task(t.duration, outputs=[o.size for o in t.outputs],
                              cpus=t.cpus,
                              expected_duration=t.expected_duration,
                              name=t.name)
            for o, no in zip(t.outputs, nt.outputs, strict=True):
                no.expected_size = o.expected_size
            tmap[t] = nt
        for t in g.tasks:
            for o in t.inputs:
                idx = o.parent.outputs.index(o)
                out._add_input(tmap[t], tmap[o.parent].outputs[idx])
    return out


def gridcat(seed=0):
    """4 levels of sliding-window 'cat' merges of 300 MiB files:
    101 producers + 3 x 100 cats; every output is a 300 MiB file."""
    rng = random.Random(seed)
    g = TaskGraph("gridcat")
    level = [g.new_task(tnormal(rng, 20, 4), outputs=[300 * MiB], name="dl")
             for _ in range(101)]
    for lvl in range(3):
        nxt = []
        for i in range(100):
            a = level[i % len(level)]
            b = level[(i + 1) % len(level)]
            inputs = [a.outputs[0]]
            if b is not a:
                inputs.append(b.outputs[0])
            nxt.append(g.new_task(tnormal(rng, 35, 6), inputs=inputs,
                                  outputs=[300 * MiB], name=f"cat{lvl}"))
        level = nxt
    return finish(g, seed)


def _crossv(g, rng, folds=8, configs=5, speed=1.0, tag=""):
    load = g.new_task(tnormal(rng, 120, 15) * speed,
                      outputs=[tnormal(rng, 950, 60) * MiB], name=tag + "load")
    split = g.new_task(tnormal(rng, 30, 5) * speed, inputs=load.outputs,
                       outputs=[tnormal(rng, 110, 10) * MiB
                                for _ in range(folds)], name=tag + "split")
    merges = []
    for _ in range(configs):
        scores = []
        for f in range(folds):
            train_in = [split.outputs[i] for i in range(folds) if i != f]
            train = g.new_task(tnormal(rng, 600, 90) * speed, inputs=train_in,
                               outputs=[tnormal(rng, 40, 6) * MiB],
                               name=tag + "train")
            ev = g.new_task(tnormal(rng, 60, 10) * speed,
                            inputs=[train.outputs[0], split.outputs[f]],
                            outputs=[0.1 * MiB], name=tag + "eval")
            scores.append(ev.outputs[0])
        merges.append(g.new_task(tnormal(rng, 10, 2) * speed, inputs=scores,
                                 outputs=[0.1 * MiB], name=tag + "cmerge"))
    g.new_task(tnormal(rng, 5, 1) * speed,
               inputs=[m.outputs[0] for m in merges], name=tag + "final")
    return g


def crossv(seed=0, speed=1.0):
    """Machine-learning cross validation: 8 folds x 5 hyper-configs."""
    rng = random.Random(seed)
    g = TaskGraph("crossv" if speed == 1.0 else "fastcrossv")
    _crossv(g, rng, speed=speed)
    return finish(g, seed)


def fastcrossv(seed=0):
    """Same structure as crossv, tasks are 50x shorter (paper Table 1)."""
    return crossv(seed=seed, speed=1.0 / 50.0)


def crossvx(seed=0):
    """Two instances of cross validation (8 folds x 6 configs), run
    concurrently."""
    gs = []
    for k in range(2):
        g = TaskGraph()
        _crossv(g, random.Random(seed + 17 * k), folds=8, configs=6,
                tag=f"i{k}.")
        gs.append(g)
    return finish(merge_graphs(gs, name="crossvx"), seed)


def mapreduce(seed=0, maps=160, reduces=160, name="mapreduce"):
    """MapReduce: every reduce consumes one output of every map."""
    rng = random.Random(seed)
    g = TaskGraph(name)
    map_tasks = [g.new_task(tnormal(rng, 120, 20),
                            outputs=[tnormal(rng, 17.4, 2.5) * MiB
                                     for _ in range(reduces)], name="map")
                 for _ in range(maps)]
    red_tasks = [g.new_task(tnormal(rng, 80, 12),
                            inputs=[m.outputs[r] for m in map_tasks],
                            outputs=[tnormal(rng, 20, 3) * MiB],
                            name="reduce")
                 for r in range(reduces)]
    g.new_task(tnormal(rng, 30, 5),
               inputs=[r.outputs[0] for r in red_tasks], name="collect")
    return finish(g, seed)


def mapreduce48(seed=0):
    """``mapreduce`` at 48 maps x 48 reduces: 97 tasks, 2,352 objects
    and 2,352 input edges (the published 160 x 160 takes over 24,000
    event steps a row)."""
    return mapreduce(seed, maps=48, reduces=48, name="mapreduce48")


def nestedcrossv(seed=0, outer=6, inner=5, configs=4):
    """Nested cross validation (model selection inside each outer fold)."""
    rng = random.Random(seed)
    g = TaskGraph("nestedcrossv")
    load = g.new_task(tnormal(rng, 120, 15),
                      outputs=[tnormal(rng, 950, 60) * MiB], name="load")
    osplit = g.new_task(tnormal(rng, 30, 5), inputs=load.outputs,
                        outputs=[tnormal(rng, 150, 12) * MiB
                                 for _ in range(outer)], name="osplit")
    for o in range(outer):
        isplit = g.new_task(tnormal(rng, 20, 4), inputs=[osplit.outputs[o]],
                            outputs=[tnormal(rng, 28, 4) * MiB
                                     for _ in range(inner)], name="isplit")
        scores = []
        for _ in range(configs):
            for f in range(inner):
                train_in = [isplit.outputs[i] for i in range(inner) if i != f]
                tr = g.new_task(tnormal(rng, 300, 45), inputs=train_in,
                                outputs=[tnormal(rng, 40, 6) * MiB],
                                name="itrain")
                ev = g.new_task(tnormal(rng, 40, 8),
                                inputs=[tr.outputs[0], isplit.outputs[f]],
                                outputs=[0.1 * MiB], name="ieval")
                scores.append(ev.outputs[0])
        select = g.new_task(tnormal(rng, 5, 1), inputs=scores,
                            outputs=[0.1 * MiB], name="select")
        retrain = g.new_task(tnormal(rng, 500, 70),
                             inputs=[select.outputs[0], osplit.outputs[o]],
                             outputs=[tnormal(rng, 45, 6) * MiB],
                             name="retrain")
        g.new_task(tnormal(rng, 60, 10),
                   inputs=[retrain.outputs[0], osplit.outputs[o]],
                   name="otest")
    return finish(g, seed)


GRAPHS = {
    "gridcat": gridcat,
    "crossv": crossv,
    "crossvx": crossvx,
    "fastcrossv": fastcrossv,
    "nestedcrossv": nestedcrossv,
    "mapreduce48": mapreduce48,
}
