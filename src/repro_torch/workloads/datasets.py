"""Dataset manifests + adaptive bucket derivation (DESIGN.md §6).

A ``Manifest`` names a *dataset*: an ordered tuple of graph instance
names — registered generators (``merge_triplets``), seed-suffixed
variants (``crossv@s3``), recipe instances (``montage-220-s1``) or
WfFormat files (``wf:<path>``) — everything ``core.graphs.make_graph``
resolves.  The survey runner's ``--dataset`` axis is a manifest name.

``compute_bucket_edges`` closes the ROADMAP "adaptive bucket edges"
item: instead of the hard-coded ``specs.T_EDGES = (32, 160, 512,
2048)`` (tuned to the original survey representatives), it derives
task-count bucket edges from the *actual* dataset — the upper
empirical ``k``-quantiles of the member task counts, rounded up to
``specs.PAD_MULTIPLE`` — so every bucket is as tight as the data
allows and the last edge always covers the largest member (no
overflow).  ``w_bucket``/``compute_w_buckets`` are the cluster-side
counterpart: padded worker counts are the next power of two, so
same-bucket clusters share one compiled program via the traced-cores
axis (DESIGN.md §3).

A copy of ``repro.workloads.datasets`` for the PyTorch port, which
imports nothing of the reference package: the logic is the reference's,
only the imports differ.  ``w_bucket`` is the port's one in
``core/cluster.py``, re-exported here."""
from __future__ import annotations

import dataclasses
import math

from ..core.cluster import w_bucket
from ..core.vectorized.specs import PAD_MULTIPLE, round_up


@dataclasses.dataclass(frozen=True)
class Manifest:
    """A named dataset: instance names + bucket-derivation knobs."""
    name: str
    instances: tuple           # names resolvable by core.graphs.make_graph
    bucket_k: int = 2          # quantile bucket count for derived edges
    description: str = ""

    def __post_init__(self):
        if not self.instances:
            raise ValueError(f"manifest {self.name!r} has no instances")
        if len(set(self.instances)) != len(self.instances):
            raise ValueError(f"manifest {self.name!r} has duplicate "
                             f"instances")


# >= 3 recipe families x 2 scales each: the small scales share today's
# mid bucket, the large ones stress the derived-edge path (CI's
# `--dataset wfcommons-mini` smoke)
WFCOMMONS_MINI = Manifest(
    name="wfcommons-mini",
    instances=(
        "montage-77-s0", "montage-220-s1",
        "cybershake-104-s0", "cybershake-257-s1",
        "epigenomics-84-s0", "epigenomics-204-s1",
    ),
    bucket_k=2,
    description="3 recipe families x 2 scales (CI survey smoke)",
)

MANIFESTS = {m.name: m for m in (WFCOMMONS_MINI,)}


def default_manifest(per_family: int = 1) -> Manifest:
    """The survey's classic graph axis as a manifest: the first
    ``per_family`` representatives of every registered family."""
    from ..core.graphs import survey_names
    return Manifest(name="default", instances=tuple(survey_names(per_family)),
                    description="per-family survey representatives")


def get_manifest(name, per_family: int = 1) -> Manifest:
    """Resolve a manifest by name (``Manifest`` instances pass
    through)."""
    if isinstance(name, Manifest):
        return name
    if name == "default":
        return default_manifest(per_family)
    try:
        return MANIFESTS[name]
    except KeyError:
        raise KeyError(f"unknown dataset {name!r} (have 'default', "
                       f"{sorted(MANIFESTS)})") from None


def build_dataset(manifest, seed: int = 0) -> dict:
    """Build every instance of a manifest: ``{name: TaskGraph}`` in
    manifest order.  Per-instance seeds ride in the names (``-s<k>`` /
    ``@s<k>`` grammars); ``seed`` offsets all of them (for ``wf:``
    members the trace data is fixed — only their user-imode estimate
    sampling moves)."""
    from ..core.graphs import make_graph
    man = get_manifest(manifest)
    return {n: make_graph(n, seed=seed) for n in man.instances}


def _task_counts(dataset, seed: int = 0):
    """Member task counts of a dataset given as a manifest (name or
    instance), a ``{name: TaskGraph-or-spec}`` mapping, or an iterable
    of counts/graphs/specs."""
    if isinstance(dataset, (str, Manifest)):
        dataset = build_dataset(dataset, seed=seed).values()
    elif isinstance(dataset, dict):
        dataset = dataset.values()
    counts = []
    for item in dataset:
        if isinstance(item, (int, float)):
            counts.append(int(item))
        elif hasattr(item, "task_count"):
            counts.append(int(item.task_count))
        elif hasattr(item, "T"):
            counts.append(int(item.T))
        else:
            raise TypeError(f"cannot derive a task count from "
                            f"{type(item).__name__}")
    if not counts:
        raise ValueError("empty dataset")
    return counts


def compute_bucket_edges(dataset, k: int | None = None,
                         multiple: int = PAD_MULTIPLE, seed: int = 0):
    """Derive ``T_EDGES``-style task-count bucket edges from a dataset.

    Edges are the upper empirical ``i/k``-quantiles (i = 1..k) of the
    member task counts, rounded up to ``multiple`` and deduplicated —
    ascending, with the last edge >= the largest member, so
    ``specs.pad_specs(..., t_edges=edges)`` never overflows on the
    dataset it was derived from.  ``k`` defaults to the manifest's
    ``bucket_k`` (2 elsewhere).  Fewer than ``k`` edges come back when
    quantiles collide after rounding (a tightly clustered dataset is
    one bucket)."""
    if k is None:
        k = (get_manifest(dataset).bucket_k
             if isinstance(dataset, (str, Manifest)) else 2)
    if k < 1:
        raise ValueError(f"need k >= 1 bucket edges, got {k}")
    counts = sorted(_task_counts(dataset, seed=seed))
    edges = []
    for i in range(1, k + 1):
        q = counts[math.ceil(i * len(counts) / k) - 1]
        e = round_up(q, multiple)
        if not edges or e > edges[-1]:
            edges.append(e)
    return tuple(edges)


def compute_w_buckets(cluster_names):
    """Padded worker-count buckets a set of named clusters occupies
    (``core.parse_cluster`` grammar), ascending."""
    from ..core import parse_cluster
    return tuple(sorted({w_bucket(len(parse_cluster(c)))
                         for c in cluster_names}))
