"""Dense-graph data model of the port's vectorized simulator — the
counterpart of ``repro.core.vectorized.specs``.

Two layers, as in the reference package:

* ``GraphSpec`` — one task graph as dense numpy arrays
  (``encode_graph``), exactly the shapes the graph has;
* ``BucketedGraphSpec`` — the *padded* view: arrays grown to a shared
  shape bucket with explicit validity masks (``task_valid`` /
  ``obj_valid`` / ``edge_valid``), optionally stacked along a leading
  batch axis.  Padding is semantically inert — padded tasks are born
  finished, padded edges never carry flows, padded objects have zero
  size — so one batched simulator call serves every graph in a bucket.

Encoding, padding and stacking stay in numpy on the host.  A spec is
moved to a device with ``BucketedGraphSpec.to(device)`` (leaves become
tensors with the same dtypes: f32 / i32 / bool), and
``spec_from_numpy`` builds one from another package's fields given as
numpy arrays — the parity tests feed both packages the identical graph
that way.

Bucketing rule (``pad_specs``): graphs are grouped by the task-count
bucket edge (``T_EDGES``, e.g. T <= 160); within one group the object
and edge dimensions are padded to the group maximum rounded up to a
multiple of ``PAD_MULTIPLE``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# task-count bucket edges; beyond the last edge sizes round up to a
# multiple of it (survey representatives land in the 160 bucket:
# merge_triplets T=148, fastcrossv T=88, sipht T=64)
T_EDGES = (32, 160, 512, 2048)
PAD_MULTIPLE = 32


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    """Static structure of a task graph as dense arrays."""
    durations: np.ndarray      # f32[T]
    cpus: np.ndarray           # i32[T]
    sizes: np.ndarray          # f32[O]
    producer: np.ndarray       # i32[O]
    edge_task: np.ndarray      # i32[E]  consumer task of each input edge
    edge_obj: np.ndarray       # i32[E]
    n_inputs: np.ndarray       # i32[T]

    @property
    def T(self):
        return len(self.durations)

    @property
    def O(self):
        return len(self.sizes)

    @property
    def E(self):
        return len(self.edge_task)


def encode_graph(graph) -> GraphSpec:
    T = graph.task_count
    durations = np.array([t.duration for t in graph.tasks], np.float32)
    cpus = np.array([t.cpus for t in graph.tasks], np.int32)
    sizes = np.array([o.size for o in graph.objects], np.float32)
    producer = np.array([o.parent.id for o in graph.objects], np.int32)
    et, eo = [], []
    for t in graph.tasks:
        for o in t.inputs:
            et.append(t.id)
            eo.append(o.id)
    edge_task = np.array(et, np.int32) if et else np.zeros(0, np.int32)
    edge_obj = np.array(eo, np.int32) if eo else np.zeros(0, np.int32)
    n_inputs = np.zeros(T, np.int32)
    for t in graph.tasks:
        n_inputs[t.id] = len(t.inputs)
    return GraphSpec(durations, cpus, sizes, producer, edge_task, edge_obj,
                     n_inputs)


_DTYPES = {"durations": np.float32, "cpus": np.int32, "sizes": np.float32,
           "producer": np.int32, "edge_task": np.int32,
           "edge_obj": np.int32, "n_inputs": np.int32,
           "task_valid": np.bool_, "obj_valid": np.bool_,
           "edge_valid": np.bool_}


@dataclasses.dataclass(frozen=True)
class BucketedGraphSpec:
    """Padded (optionally batched) ``GraphSpec`` with validity masks.

    Leaves are numpy arrays on the host or tensors on a device
    (``to``).  Shapes are ``[..., T]`` / ``[..., O]`` / ``[..., E]``
    with an optional shared leading batch axis.  Mask semantics:
    invalid tasks are born started+finished and are never assigned;
    invalid edges never count toward readiness, never carry flows and
    never claim a download-dedup key; invalid objects have zero size.
    Padding targets (``producer`` / ``edge_task`` / ``edge_obj`` of
    invalid entries) are index 0 — every consumer masks them out
    explicitly, so the value is arbitrary.
    """
    durations: np.ndarray      # f32[..., T]
    cpus: np.ndarray           # i32[..., T]
    sizes: np.ndarray          # f32[..., O]
    producer: np.ndarray       # i32[..., O]
    edge_task: np.ndarray      # i32[..., E]
    edge_obj: np.ndarray       # i32[..., E]
    n_inputs: np.ndarray       # i32[..., T]
    task_valid: np.ndarray     # bool[..., T]
    obj_valid: np.ndarray      # bool[..., O]
    edge_valid: np.ndarray     # bool[..., E]

    @property
    def T(self):
        return self.durations.shape[-1]

    @property
    def O(self):
        return self.sizes.shape[-1]

    @property
    def E(self):
        return self.edge_task.shape[-1]

    @property
    def B(self):
        """Leading batch size, or None when unbatched."""
        return None if self.durations.ndim == 1 else self.durations.shape[0]

    @property
    def shape(self):
        return (self.T, self.O, self.E)

    def fields(self) -> dict:
        return {f: getattr(self, f) for f in _BSPEC_FIELDS}

    def numpy(self) -> dict:
        """The leaves as host numpy arrays, keyed by field name."""
        return {f: (v.detach().cpu().numpy() if torch.is_tensor(v)
                    else np.asarray(v)) for f, v in self.fields().items()}

    def to(self, device) -> "BucketedGraphSpec":
        """The spec with every leaf a tensor on ``device`` (dtypes kept:
        f32, i32, bool)."""
        return spec_from_numpy(self.numpy(), device)

    def map(self, fn) -> "BucketedGraphSpec":
        """Apply ``fn`` to every leaf (e.g. a row gather)."""
        return BucketedGraphSpec(*(fn(getattr(self, f))
                                   for f in _BSPEC_FIELDS))


_BSPEC_FIELDS = [f.name for f in dataclasses.fields(BucketedGraphSpec)]


def spec_from_numpy(fields: dict, device) -> BucketedGraphSpec:
    """Build a ``BucketedGraphSpec`` of tensors on ``device`` from a
    mapping of field name -> numpy array (e.g. the fields of the
    reference package's spec).  Every field is required; dtypes are
    normalised to the spec's (f32 / i32 / bool)."""
    missing = set(_BSPEC_FIELDS) - set(fields)
    if missing:
        raise KeyError(f"spec_from_numpy: missing fields {sorted(missing)}")
    dev = torch.device(device)
    return BucketedGraphSpec(**{
        f: torch.from_numpy(np.ascontiguousarray(
            np.asarray(fields[f]).astype(_DTYPES[f]))).to(dev)
        for f in _BSPEC_FIELDS})


def spec_rows(bspec, R, device) -> BucketedGraphSpec:
    """The spec as tensors on ``device`` with exactly ``R`` rows (an
    unbatched spec is repeated)."""
    if not all(torch.is_tensor(v) and v.device == device
               for v in bspec.fields().values()):
        bspec = bspec.to(device)
    if bspec.B is None:
        return bspec.map(lambda x: x.unsqueeze(0).expand(R, -1).contiguous())
    if bspec.B != R:
        raise ValueError(f"spec has {bspec.B} rows but the call has {R}")
    return bspec


def _pad1(a, n, fill):
    if len(a) == n:
        return np.asarray(a).copy()
    out = np.full((n,), fill, np.asarray(a).dtype)
    out[:len(a)] = a
    return out


def as_bucketed(spec) -> BucketedGraphSpec:
    """A ``GraphSpec`` as a zero-padding ``BucketedGraphSpec`` (all-valid
    masks) — the compatibility path for the per-graph entry points."""
    if isinstance(spec, BucketedGraphSpec):
        return spec
    return pad_spec(spec, (spec.T, spec.O, spec.E))


def pad_spec(spec: GraphSpec, shape) -> BucketedGraphSpec:
    """Pad one ``GraphSpec`` to ``shape = (T, O, E)`` with inert filler:
    zero durations/sizes, one-core tasks, index-0 link targets, and
    masks marking the real prefix."""
    T, O, E = shape
    if T < spec.T or O < spec.O or E < spec.E:
        raise ValueError(f"bucket shape {shape} smaller than graph shape "
                         f"{(spec.T, spec.O, spec.E)}")
    return BucketedGraphSpec(
        durations=_pad1(spec.durations, T, 0.0),
        cpus=_pad1(spec.cpus, T, 1),
        sizes=_pad1(spec.sizes, O, 0.0),
        producer=_pad1(spec.producer, O, 0),
        edge_task=_pad1(spec.edge_task, E, 0),
        edge_obj=_pad1(spec.edge_obj, E, 0),
        n_inputs=_pad1(spec.n_inputs, T, 0),
        task_valid=np.arange(T) < spec.T,
        obj_valid=np.arange(O) < spec.O,
        edge_valid=np.arange(E) < spec.E,
    )


def stack_specs(bspecs) -> BucketedGraphSpec:
    """Stack same-shape ``BucketedGraphSpec``s along a new leading batch
    axis (the graph axis of one bucketed grid call)."""
    bspecs = list(bspecs)
    shapes = {b.shape for b in bspecs}
    if len(shapes) != 1:
        raise ValueError(f"cannot stack mixed bucket shapes {sorted(shapes)}")
    return BucketedGraphSpec(*(
        np.stack([np.asarray(getattr(b, f)) for b in bspecs])
        for f in _BSPEC_FIELDS))


def pad_to(a, n, fill=0.0):
    """Pad a per-task/object vector (e.g. an ``encode_imode`` estimate)
    to the bucket length with an inert fill."""
    return _pad1(np.asarray(a), n, fill)


def round_up(n: int, multiple: int = PAD_MULTIPLE) -> int:
    return 0 if n == 0 else ((n + multiple - 1) // multiple) * multiple


# floor of the derived frontier capacities: buckets at or below it get
# full coverage (capacity == axis length), so the frontier can never
# overflow.  256 keeps fork-heavy mid-size graphs inside the list while
# the large survey buckets still run at n // 4
FRONTIER_FLOOR = 256


def frontier_cap(n: int, floor: int = FRONTIER_FLOOR) -> int:
    """Derived ready-frontier capacity for an axis of length ``n``.
    Small buckets get full coverage (``cap == n``); large buckets get
    ``n // 4`` rounded up to ``PAD_MULTIPLE``.  A frontier overflow at
    run time is recorded and poisons ``ok`` (honest failure, never
    silent truncation); callers can widen via ``frontier_caps``."""
    if n <= floor:
        return n
    return min(n, max(floor, round_up(n // 4)))


def frontier_caps_for(shape, floor: int = FRONTIER_FLOOR):
    """``(flow_cap, task_cap)`` for a bucket shape ``(T, O, E)`` — the
    derived sizes of the candidate-flow and ready-task frontiers."""
    T, _O, E = shape
    return frontier_cap(E, floor), frontier_cap(T, floor)


def frontier_caps_for_spec(bspec, floor: int = FRONTIER_FLOOR):
    """Root-aware ``(flow_cap, task_cap)`` for a *concrete* spec: the
    shape-derived ``frontier_caps_for``, with the task cap raised to
    cover the graph's roots (every root is ready at t=0)."""
    T, _O, E = bspec.shape
    CF, CT = frontier_caps_for((T, _O, E), floor)
    f = bspec.numpy()
    roots = f["task_valid"] & (f["n_inputs"] == 0)
    n_roots = int(np.max(np.sum(roots, axis=-1))) if roots.size else 0
    return CF, min(T, max(CT, round_up(n_roots)))


def t_bucket(T: int, t_edges=T_EDGES, overflow: str = "derive") -> int:
    """Bucket edge for a task count: the smallest configured edge >= T.
    Beyond the last edge the ``overflow`` policy decides: ``"derive"``
    (default) grows an extra bucket at the next multiple of the last
    edge; ``"error"`` raises."""
    if overflow not in ("derive", "error"):
        raise ValueError(f"unknown overflow policy {overflow!r} "
                         f"(have 'derive', 'error')")
    for e in t_edges:
        if T <= e:
            return e
    if overflow == "error":
        raise ValueError(
            f"task count {T} exceeds the largest bucket edge "
            f"{t_edges[-1]} (t_edges={tuple(t_edges)}); pass edges "
            f"covering the dataset or overflow='derive'")
    return round_up(T, t_edges[-1])


def bucket_shape(specs, t_edges=T_EDGES, overflow: str = "derive"):
    """Common padded shape for a set of specs sharing one T bucket:
    (T bucket edge, max O rounded up, max E rounded up)."""
    specs = list(specs)
    edges = {t_bucket(s.T, t_edges, overflow) for s in specs}
    if len(edges) != 1:
        raise ValueError(f"specs span several T buckets {sorted(edges)}")
    return (edges.pop(),
            round_up(max(s.O for s in specs)),
            round_up(max(s.E for s in specs)))


@dataclasses.dataclass(frozen=True)
class BucketGroup:
    """One shape bucket of the grid: member names, their unpadded specs,
    the common padded shape and the batch-stacked padded spec."""
    shape: tuple              # (T, O, E) padded
    names: tuple              # member graph names, batch order
    specs: tuple              # unpadded GraphSpecs, batch order
    batch: BucketedGraphSpec  # stacked [B, ...] arrays + masks

    @property
    def label(self):
        T, O, E = self.shape
        return f"T{T}xO{O}xE{E}"


def pad_specs(named_specs, t_edges=T_EDGES, overflow: str = "derive"):
    """The bucketing layer: group ``{name: GraphSpec}`` (or ``(name,
    spec)`` pairs) by T bucket, pad every member to its group's common
    shape and stack — returns ``[BucketGroup, ...]`` ordered by bucket
    size."""
    items = (list(named_specs.items()) if isinstance(named_specs, dict)
             else list(named_specs))
    by_edge = {}
    for name, spec in items:
        by_edge.setdefault(t_bucket(spec.T, t_edges, overflow),
                           []).append((name, spec))
    groups = []
    for edge in sorted(by_edge):
        members = by_edge[edge]
        shape = bucket_shape([s for _, s in members], t_edges, overflow)
        batch = stack_specs([pad_spec(s, shape) for _, s in members])
        groups.append(BucketGroup(shape=shape,
                                  names=tuple(n for n, _ in members),
                                  specs=tuple(s for _, s in members),
                                  batch=batch))
    return groups
