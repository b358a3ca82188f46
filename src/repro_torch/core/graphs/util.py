"""Shared helpers for dataset generators.

The exact durations/sizes of the published dataset live on Zenodo [8]
(unavailable offline); distribution parameters chosen here are documented
assumptions that reproduce Table 1's #T/#O exactly for the elementary set
and TS within tolerance (see tests/test_graphs.py).

``user``-imode estimates follow the paper: tasks/objects are grouped into
categories (we use the ``name`` tag); the user estimate for an element is a
fresh sample from its category's empirical distribution — i.e. a user who
knows category-level statistics but not individual values.
"""
from __future__ import annotations

import math
import random

from ..taskgraph import TaskGraph


def tnormal(rng: random.Random, mean, sd, lo=1e-3):
    """Truncated-at-lo normal sample."""
    return max(lo, rng.normalvariate(mean, sd))


def texp(rng: random.Random, mean, lo=1e-3):
    return max(lo, rng.expovariate(1.0 / mean))


def annotate_user_estimates(graph: TaskGraph, seed: int = 12345):
    """Fill ``expected_duration``/``expected_size`` by category sampling."""
    rng = random.Random(seed)
    cats: dict = {}
    for t in graph.tasks:
        cats.setdefault(t.name or "task", []).append(t)
    for tasks in cats.values():
        durs = [t.duration for t in tasks]
        mean = sum(durs) / len(durs)
        sd = math.sqrt(sum((d - mean) ** 2 for d in durs) / len(durs))
        for t in tasks:
            t.expected_duration = tnormal(rng, mean, sd) if sd > 0 else mean
    ocats: dict = {}
    for o in graph.objects:
        ocats.setdefault(o.parent.name or "task", []).append(o)
    for objs in ocats.values():
        sizes = [o.size for o in objs]
        mean = sum(sizes) / len(sizes)
        sd = math.sqrt(sum((s - mean) ** 2 for s in sizes) / len(sizes))
        for o in objs:
            o.expected_size = tnormal(rng, mean, sd, lo=1.0) if sd > 0 else mean
    return graph


def finish(graph: TaskGraph, seed: int) -> TaskGraph:
    graph.validate()
    annotate_user_estimates(graph, seed=seed ^ 0x5EED)
    return graph
