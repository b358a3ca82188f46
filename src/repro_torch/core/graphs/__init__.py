"""Task graph datasets (paper Table 1) + random graphs for property tests.

A copy of ``repro.core.graphs`` for the PyTorch port: the generators are
framework-free and must give the same graphs, so the parity suites
compare the two packages field by field.  WfFormat files (``wf:<path>``)
are not resolved by the port yet."""
from __future__ import annotations

import random

from ..taskgraph import TaskGraph, MiB
from . import elementary as _elementary, irw as _irw, pegasus as _pegasus
from .elementary import ELEMENTARY
from .irw import IRW
from .pegasus import PEGASUS
from .util import finish, tnormal

def _recipe_instance(iname):
    """Registered fixed-size instance of a ``workloads`` recipe (lazy
    import, mirroring the reference package's layering)."""
    def gen(seed=0):
        from ...workloads import make_instance
        return make_instance(iname, seed=seed)
    gen.__name__ = iname
    return gen


# fixed-size recipe instances registered like any generator; sizes are
# the PEGASUS_EQUIVALENT counts (plus a small mapreduce) so the recipe
# layer provably reproduces the Table-1 structures
RECIPE_INSTANCES = ("montage-77-s0", "cybershake-104-s0",
                    "epigenomics-204-s0", "mapreduce-64-s0")

DATASETS = {"elementary": ELEMENTARY, "irw": IRW, "pegasus": PEGASUS,
            "recipes": {n: _recipe_instance(n) for n in RECIPE_INSTANCES}}

# per-family survey representatives (ordered smallest-first by the
# dataset modules); the survey runner slices these per grid size.
# mapreduce-64 is registered but not a representative: its dense m x m
# shuffle would inflate the shared bucket's padded edge count.
SURVEY_GRAPHS = {"elementary": _elementary.SURVEY, "irw": _irw.SURVEY,
                 "pegasus": _pegasus.SURVEY,
                 "recipes": ("montage-77-s0", "cybershake-104-s0",
                             "epigenomics-204-s0")}

GENERATORS = {}
for _ds in DATASETS.values():
    GENERATORS.update(_ds)

GRAPH_NAMES = list(GENERATORS)


def make_graph(name: str, seed: int = 0) -> TaskGraph:
    """Build a graph by name: a registered generator, a seed-suffixed
    variant (``crossv@s3`` == ``crossv`` at seed+3 — how dataset
    manifests pin per-instance seeds without colliding) or a recipe
    instance (``montage-220-s1``).  WfFormat files (``wf:<path>``)
    raise ``NotImplementedError`` until the port carries the WfFormat
    reader (ROADMAP, still to port)."""
    gen = GENERATORS.get(name)
    if gen is None and "@s" in name:
        base, _, sfx = name.rpartition("@s")
        if sfx.isdigit() and base in GENERATORS:
            gen, seed = GENERATORS[base], seed + int(sfx)
    if gen is not None:
        return gen(seed=seed)
    from ...workloads import resolve_workload
    g = resolve_workload(name, seed=seed)
    if g is None:
        raise KeyError(f"unknown graph {name!r}: not a registered "
                       f"generator, '<name>@s<seed>' variant, recipe "
                       f"instance ('<family>-<n>-s<seed>')")
    return g


def dataset_of(name: str) -> str:
    for ds, gens in DATASETS.items():
        if name in gens:
            return ds
    raise KeyError(name)


def survey_names(per_family: int = 1):
    """First ``per_family`` survey representatives of every graph family,
    in dataset order — the graph axis of the survey grid."""
    out = []
    for fam in DATASETS:
        out.extend(SURVEY_GRAPHS[fam][:per_family])
    return out


def encode_graph_batch(names, seed: int = 0, bucket: bool = False,
                       t_edges=None, overflow: str = "derive"):
    """Batch-encoding helper for grid sweeps: build each named graph and
    its dense ``GraphSpec`` exactly once, returning ``{name: (graph,
    spec)}`` — survey runners fan many (scheduler x cluster x netmodel)
    runners out of one encoding (DESIGN.md §5).

    ``names`` accepts every ``make_graph`` grammar; per-instance seeds
    ride in the names (``crossv@s3``, ``montage-220-s1``) so manifest
    entries of the same family never alias, and ``seed`` offsets all of
    them.  Items may also be prebuilt ``(name, TaskGraph)`` pairs
    (e.g. ``workloads.build_dataset(...).items()``) — those are encoded
    as-is instead of rebuilt.

    With ``bucket=True`` the encoded specs are additionally grouped into
    padded shape buckets (``vectorized.specs.pad_specs``; ``t_edges``
    overrides the task-count bucket edges — e.g. the dataset-derived
    ``workloads.compute_bucket_edges`` — and ``overflow`` picks the
    beyond-last-edge policy) and the return value becomes ``(encoded,
    groups)`` with ``groups`` a ``[BucketGroup, ...]`` — one jit
    compilation per group serves every member graph."""
    from ..vectorized import encode_graph, pad_specs
    from ..vectorized.specs import T_EDGES

    out = {}
    for item in names:
        if isinstance(item, tuple):
            name, g = item
        else:
            name, g = item, make_graph(item, seed=seed)
        out[name] = (g, encode_graph(g))
    if not bucket:
        return out
    groups = pad_specs({n: spec for n, (_, spec) in out.items()},
                       t_edges=T_EDGES if t_edges is None else t_edges,
                       overflow=overflow)
    return out, groups


def random_graph(seed: int, n_tasks: int = 20, edge_p: float = 0.25,
                 max_cpus: int = 4, multi_output_p: float = 0.3) -> TaskGraph:
    """Random layered DAG for property-based testing."""
    rng = random.Random(seed)
    g = TaskGraph(f"random-{seed}")
    tasks = []
    for i in range(n_tasks):
        n_out = 1 + (rng.random() < multi_output_p)
        t = g.new_task(tnormal(rng, 30, 20),
                       outputs=[tnormal(rng, 50, 40) * MiB
                                for _ in range(n_out)],
                       cpus=rng.randint(1, max_cpus), name="rnd")
        # edges only to earlier tasks => acyclic
        for p in tasks:
            if rng.random() < edge_p / max(1, len(tasks) ** 0.5):
                o = rng.choice(p.outputs)
                if o not in t.inputs:
                    g.add_dependencies(t, [o])
        tasks.append(t)
    return finish(g, seed)
