"""The *elementary* dataset (paper Table 1, Fig. 2): 16 trivial graph
shapes exercising basic scheduling scenarios.  #T/#O match Table 1 exactly
(asserted by tests); TS targets the table column."""
from __future__ import annotations

import random

from ..taskgraph import TaskGraph, MiB
from .util import tnormal, texp, finish


def plain1n(seed=0):
    rng = random.Random(seed)
    g = TaskGraph("plain1n")
    for _ in range(380):
        g.new_task(tnormal(rng, 60, 15), name="plain")
    return finish(g, seed)


def plain1e(seed=0):
    rng = random.Random(seed)
    g = TaskGraph("plain1e")
    for _ in range(380):
        g.new_task(texp(rng, 60), name="plain")
    return finish(g, seed)


def plain1cpus(seed=0):
    rng = random.Random(seed)
    g = TaskGraph("plain1cpus")
    for _ in range(380):
        g.new_task(tnormal(rng, 60, 15), cpus=rng.randint(1, 4), name="plain")
    return finish(g, seed)


def triplets(seed=0):
    """110 independent triplets; middle task needs 4 cores (Fig 2h)."""
    rng = random.Random(seed)
    g = TaskGraph("triplets")
    for _ in range(110):
        t1 = g.new_task(tnormal(rng, 45, 8),
                        outputs=[tnormal(rng, 80, 10) * MiB], name="t1")
        t2 = g.new_task(tnormal(rng, 90, 20), inputs=t1.outputs, cpus=4,
                        outputs=[tnormal(rng, 80, 10) * MiB], name="t2")
        g.new_task(tnormal(rng, 30, 5), inputs=t2.outputs, name="t3")
    return finish(g, seed)


def merge_neighbours(seed=0):
    """107 producers; merge task i consumes outputs i and (i+1)%107."""
    rng = random.Random(seed)
    g = TaskGraph("merge_neighbours")
    prods = [g.new_task(tnormal(rng, 60, 10),
                        outputs=[tnormal(rng, 99, 5) * MiB], name="prod")
             for _ in range(107)]
    for i in range(107):
        g.new_task(tnormal(rng, 15, 3),
                   inputs=[prods[i].outputs[0],
                           prods[(i + 1) % 107].outputs[0]],
                   name="merge")
    return finish(g, seed)


def merge_triplets(seed=0):
    """111 producers; 37 merges of consecutive triplets."""
    rng = random.Random(seed)
    g = TaskGraph("merge_triplets")
    prods = [g.new_task(tnormal(rng, 60, 10),
                        outputs=[tnormal(rng, 99, 5) * MiB], name="prod")
             for _ in range(111)]
    for i in range(37):
        g.new_task(tnormal(rng, 15, 3),
                   inputs=[p.outputs[0] for p in prods[3 * i:3 * i + 3]],
                   name="merge")
    return finish(g, seed)


def merge_small_big(seed=0):
    """80 (small 0.5 MiB, big 99 MiB) pairs merged (Fig 2d)."""
    rng = random.Random(seed)
    g = TaskGraph("merge_sm-big")
    for _ in range(80):
        small = g.new_task(tnormal(rng, 30, 5), outputs=[0.5 * MiB],
                           name="small")
        big = g.new_task(tnormal(rng, 60, 10), outputs=[99 * MiB], name="big")
        g.new_task(tnormal(rng, 15, 3),
                   inputs=[small.outputs[0], big.outputs[0]], name="merge")
    return finish(g, seed)


def fork1(seed=0):
    """100 producers; 2 consumers share the same output (Fig 2b)."""
    rng = random.Random(seed)
    g = TaskGraph("fork1")
    for _ in range(100):
        p = g.new_task(tnormal(rng, 60, 10), outputs=[100 * MiB], name="prod")
        for _ in range(2):
            g.new_task(tnormal(rng, 30, 5), inputs=p.outputs, name="cons")
    return finish(g, seed)


def fork2(seed=0):
    """100 producers with two outputs; each consumer takes one (Fig 2c)."""
    rng = random.Random(seed)
    g = TaskGraph("fork2")
    for _ in range(100):
        p = g.new_task(tnormal(rng, 60, 10), outputs=[100 * MiB, 100 * MiB],
                       name="prod")
        g.new_task(tnormal(rng, 30, 5), inputs=[p.outputs[0]], name="cons")
        g.new_task(tnormal(rng, 30, 5), inputs=[p.outputs[1]], name="cons")
    return finish(g, seed)


def bigmerge(seed=0):
    """320 producers merged by a single task (variant of Fig 2f)."""
    rng = random.Random(seed)
    g = TaskGraph("bigmerge")
    prods = [g.new_task(tnormal(rng, 60, 10), outputs=[100 * MiB],
                        name="prod") for _ in range(320)]
    g.new_task(tnormal(rng, 30, 5), inputs=[p.outputs[0] for p in prods],
               name="merge")
    return finish(g, seed)


def duration_stairs(seed=0):
    """380 independent tasks, durations 1..190 s twice."""
    g = TaskGraph("duration_stairs")
    for rep in range(2):
        for d in range(1, 191):
            g.new_task(float(d), name="stair")
    return finish(g, seed)


def size_stairs(seed=0):
    """One producer with 190 outputs (0..189 MiB); 190 consumers."""
    rng = random.Random(seed)
    g = TaskGraph("size_stairs")
    p = g.new_task(tnormal(rng, 60, 10),
                   outputs=[i * MiB for i in range(190)], name="prod")
    for o in p.outputs:
        g.new_task(tnormal(rng, 30, 5), inputs=[o], name="cons")
    return finish(g, seed)


def _tree(g, rng, depth, split: bool):
    """255-task binary tree; split=True roots at 1 task (splitters),
    split=False merges 128 leaves down to 1 (conflux)."""
    if split:
        level = [g.new_task(tnormal(rng, 30, 5),
                            outputs=[tnormal(rng, 129, 8) * MiB],
                            name="split")]
        for _ in range(depth - 1):
            nxt = []
            for t in level:
                for _ in range(2):
                    nxt.append(g.new_task(tnormal(rng, 30, 5),
                                          inputs=[t.outputs[0]],
                                          outputs=[tnormal(rng, 129, 8) * MiB],
                                          name="split"))
            level = nxt
    else:
        level = [g.new_task(tnormal(rng, 30, 5),
                            outputs=[tnormal(rng, 128, 8) * MiB], name="leaf")
                 for _ in range(2 ** (depth - 1))]
        while len(level) > 1:
            nxt = []
            for i in range(0, len(level), 2):
                nxt.append(g.new_task(
                    tnormal(rng, 30, 5),
                    inputs=[level[i].outputs[0], level[i + 1].outputs[0]],
                    outputs=[tnormal(rng, 128, 8) * MiB], name="merge"))
            level = nxt
    return level


def splitters(seed=0):
    rng = random.Random(seed)
    g = TaskGraph("splitters")
    _tree(g, rng, 8, split=True)
    return finish(g, seed)


def conflux(seed=0):
    rng = random.Random(seed)
    g = TaskGraph("conflux")
    _tree(g, rng, 8, split=False)
    return finish(g, seed)


def grid(seed=0):
    """19x19 grid; task (i,j) consumes outputs of (i-1,j) and (i,j-1)."""
    rng = random.Random(seed)
    g = TaskGraph("grid")
    n = 19
    cells = {}
    for i in range(n):
        for j in range(n):
            inputs = []
            if i > 0:
                inputs.append(cells[i - 1, j].outputs[0])
            if j > 0:
                inputs.append(cells[i, j - 1].outputs[0])
            cells[i, j] = g.new_task(tnormal(rng, 30, 5), inputs=inputs,
                                     outputs=[tnormal(rng, 128, 8) * MiB],
                                     name="cell")
    return finish(g, seed)


def fern(seed=0):
    """Chain of 201 tasks; each of the first 200 also feeds a side task."""
    rng = random.Random(seed)
    g = TaskGraph("fern")
    prev = g.new_task(tnormal(rng, 20, 4),
                      outputs=[tnormal(rng, 28, 4) * MiB], name="stem")
    for i in range(200):
        g.new_task(tnormal(rng, 15, 3), inputs=[prev.outputs[0]],
                   outputs=[tnormal(rng, 28, 4) * MiB], name="side")
        prev = g.new_task(tnormal(rng, 20, 4), inputs=[prev.outputs[0]],
                          outputs=[tnormal(rng, 28, 4) * MiB], name="stem")
    return finish(g, seed)


ELEMENTARY = {
    "plain1n": plain1n,
    "plain1e": plain1e,
    "plain1cpus": plain1cpus,
    "triplets": triplets,
    "merge_neighbours": merge_neighbours,
    "merge_triplets": merge_triplets,
    "merge_sm-big": merge_small_big,
    "fork1": fork1,
    "fork2": fork2,
    "bigmerge": bigmerge,
    "duration_stairs": duration_stairs,
    "size_stairs": size_stairs,
    "splitters": splitters,
    "conflux": conflux,
    "grid": grid,
    "fern": fern,
}

# representatives for the paper-grid survey runner (benchmarks/survey.py),
# smallest first so mini-grid CI passes stay cheap
SURVEY = ("merge_triplets", "fork1", "size_stairs", "triplets")
