"""The reference's view of a task graph: dense arrays, the padding to a
shape bucket, and the estimates each information mode gives a
scheduler.  Worked out from the graphs alone, in numpy, by the rules
the simulator documents (estee's imodes; buckets by task-count edge,
objects and edges rounded up to a multiple of 32; padding inert)."""
from __future__ import annotations

import numpy as np

T_EDGES = (32, 160, 512, 2048)
PAD_MULTIPLE = 32
FIELDS = ("durations", "cpus", "sizes", "producer", "edge_task", "edge_obj",
          "n_inputs", "task_valid", "obj_valid", "edge_valid")


def round_up(n: int, multiple: int = PAD_MULTIPLE) -> int:
    return 0 if n == 0 else -(-n // multiple) * multiple


def t_bucket(n_tasks: int) -> int:
    """The smallest task-count edge that holds ``n_tasks``; past the
    last edge, the next multiple of it."""
    for e in T_EDGES:
        if n_tasks <= e:
            return e
    return round_up(n_tasks, T_EDGES[-1])


def dense(graph) -> dict:
    """The graph as unpadded arrays: per task its duration, cores and
    input count; per object its size and producer; per input edge (in
    task order, then input order) its consumer and object."""
    et = [t.id for t in graph.tasks for _ in t.inputs]
    eo = [o.id for t in graph.tasks for o in t.inputs]
    return dict(
        durations=np.array([t.duration for t in graph.tasks], np.float32),
        cpus=np.array([t.cpus for t in graph.tasks], np.int32),
        sizes=np.array([o.size for o in graph.objects], np.float32),
        producer=np.array([o.parent.id for o in graph.objects], np.int32),
        edge_task=np.array(et, np.int32),
        edge_obj=np.array(eo, np.int32),
        n_inputs=np.array([len(t.inputs) for t in graph.tasks], np.int32))


def shape_of(graphs) -> tuple:
    """The padded ``(T, O, E)`` that holds every graph of one bucket."""
    edges = {t_bucket(g.task_count) for g in graphs}
    if len(edges) != 1:
        raise ValueError(f"graphs span several task buckets {sorted(edges)}")
    return (edges.pop(),
            round_up(max(g.object_count for g in graphs)),
            round_up(max(sum(len(t.inputs) for t in g.tasks)
                         for g in graphs)))


def buckets(graphs) -> list:
    """``[(shape, [graph, ...]), ...]``: the graphs grouped by task
    bucket, in bucket order and in input order within one."""
    by_edge = {}
    for g in graphs:
        by_edge.setdefault(t_bucket(g.task_count), []).append(g)
    return [(shape_of(gs), gs) for _, gs in sorted(by_edge.items())]


def _pad(a, n, fill):
    out = np.full((n,), fill, a.dtype)
    out[:len(a)] = a
    return out


def padded(graph, shape) -> dict:
    """``dense(graph)`` grown to ``shape`` with inert filler (zero
    durations and sizes, one-core tasks, index-0 links) and the masks of
    the real prefix."""
    T, O, E = shape
    d = dense(graph)
    return dict(
        durations=_pad(d["durations"], T, 0.0), cpus=_pad(d["cpus"], T, 1),
        sizes=_pad(d["sizes"], O, 0.0), producer=_pad(d["producer"], O, 0),
        edge_task=_pad(d["edge_task"], E, 0),
        edge_obj=_pad(d["edge_obj"], E, 0),
        n_inputs=_pad(d["n_inputs"], T, 0),
        task_valid=np.arange(T) < len(d["durations"]),
        obj_valid=np.arange(O) < len(d["sizes"]),
        edge_valid=np.arange(E) < len(d["edge_task"]))


def estimates(graph, imode: str, shape) -> tuple:
    """``(est_durations f32[T], est_sizes f32[O])`` a scheduler sees for
    unfinished work under ``imode``, padded with zeros: ``exact`` the
    true values, ``user`` the generator's per-category estimates (true
    values where there are none), ``mean`` the graph's mean duration and
    mean size."""
    T, O, _ = shape
    tasks, objs = graph.tasks, graph.objects
    if imode == "exact":
        d = [t.duration for t in tasks]
        s = [o.size for o in objs]
    elif imode == "user":
        d = [t.duration if t.expected_duration is None else t.expected_duration
             for t in tasks]
        s = [o.size if o.expected_size is None else o.expected_size
             for o in objs]
    elif imode == "mean":
        md = sum(t.duration for t in tasks) / len(tasks) if tasks else 0.0
        ms = sum(o.size for o in objs) / len(objs) if objs else 0.0
        d, s = [md] * len(tasks), [ms] * len(objs)
    else:
        raise KeyError(f"unknown imode {imode!r}")
    return (_pad(np.asarray(d, np.float32), T, 0.0),
            _pad(np.asarray(s, np.float32), O, 0.0))


def parse_cluster(name: str) -> list:
    """``"<n>x<c>"`` is n workers of c cores; ``+`` joins segments."""
    cores = []
    for part in name.split("+"):
        n, c = part.split("x")
        cores.extend([int(c)] * int(n))
    return cores


def w_bucket(n_workers: int) -> int:
    """Worker counts pad to the next power of two."""
    w = 1
    while w < n_workers:
        w *= 2
    return w
