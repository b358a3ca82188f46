"""Parameterized recipe generators (DESIGN.md §6).

A ``Recipe`` is the scalable counterpart of the fixed-size dataset
generators in ``core/graphs``: it names a workflow *family* (the
structural shape — montage, cybershake, epigenomics, mapreduce), a
target task count, a seed and three sampling distributions, and
``build()`` produces a ``TaskGraph`` of that family at that scale.
The architecture follows the WfCommons/WorkflowHub recipe layer
(``from_num_jobs`` + per-category runtime/size distributions): each
family derives its structural parameters (stage widths, chain depths)
from ``n_tasks`` and samples durations/sizes/cpus per task *category*
through the shared ``core/graphs/util`` truncated samplers, finishing
with ``annotate_user_estimates`` so every instance carries ``user``
imode estimates out of the box.

The stylised Pegasus shapes of ``core/graphs/pegasus.py`` (and irw's
``mapreduce``) are the *fixed-size instances* of these recipes: at the
``PEGASUS_EQUIVALENT`` task counts the derived structure parameters
reproduce the paper's Table-1 stage widths exactly (asserted by
``tests/test_workloads.py``), and every other count scales the same
shape up or down.

Recipe invariants (the dataset-manifest contract, DESIGN.md §6):

* **deterministic** — ``build()`` is a pure function of
  ``(name, n_tasks, seed, *dists)``;
* **collision-free** — the underlying RNG stream is seeded from a hash
  of ``(family, n_tasks, seed)`` (``instance_rng_seed``), so two
  instances differing in *any* coordinate sample independent streams —
  same-family different-seed manifests never alias;
* **approximately sized** — ``task_count`` equals ``n_tasks`` exactly
  where the family's structural arithmetic allows and lands within a
  few tasks otherwise (the instance *name* always carries the requested
  count);
* **annotated** — graphs validate and carry user-imode estimates.

Instance-name grammar: ``"<family>-<n_tasks>-s<seed>"`` (e.g.
``montage-220-s1``), parsed by ``parse_instance`` and resolvable
through ``core.graphs.make_graph`` like any registered generator name.

Distributions are ``(kind, *params)`` tuples — ``("tnormal", mean,
sd)``, ``("texp", mean)``, ``("uniform", lo, hi)``, ``("const", v)``,
``("randint", lo, hi)`` — sampled via ``sample_dist``.  The duration
and size dists are *unit jitters*: each task category has a family
mean which the sampled factor multiplies, so one knob reshapes a whole
instance (heavier tails, exponential runtimes, ...) without touching the
structure.
"""
from __future__ import annotations

import dataclasses
import random
import re
import zlib

from ..core.taskgraph import TaskGraph, MiB
from ..core.graphs.util import tnormal, texp, finish


def sample_dist(rng: random.Random, dist, scale: float = 1.0) -> float:
    """One sample from a ``(kind, *params)`` distribution spec."""
    kind = dist[0]
    if kind == "tnormal":
        return tnormal(rng, dist[1] * scale, dist[2] * scale)
    if kind == "texp":
        return texp(rng, dist[1] * scale)
    if kind == "uniform":
        return max(1e-3, rng.uniform(dist[1], dist[2]) * scale)
    if kind == "const":
        return dist[1] * scale
    if kind == "randint":
        return float(rng.randint(dist[1], dist[2]))
    raise KeyError(f"unknown distribution kind {kind!r} "
                   f"(have tnormal/texp/uniform/const/randint)")


def instance_rng_seed(family: str, n_tasks: int, seed: int) -> int:
    """Stable RNG seed mixing family, size and instance seed — the fix
    for the cross-family / cross-instance seed collisions a flat
    ``random.Random(seed)`` would produce in dataset manifests."""
    return zlib.crc32(f"{family}:{n_tasks}:{seed}".encode())


class _Sampler:
    """Per-build sampling context: category mean -> jittered sample."""

    def __init__(self, rng: random.Random, recipe: "Recipe"):
        self.rng = rng
        self.recipe = recipe

    def dur(self, mean: float) -> float:
        return mean * sample_dist(self.rng, self.recipe.duration_dist)

    def size(self, mib: float) -> float:
        return mib * sample_dist(self.rng, self.recipe.size_dist) * MiB

    def cpus(self) -> int:
        """Core requirement of a 'heavy' stage (paper: at most 4)."""
        return max(1, int(sample_dist(self.rng, self.recipe.cpus_dist)))


# ----------------------------------------------------------- families
#
# Each builder derives its structure parameters from n_tasks so that at
# the PEGASUS_EQUIVALENT count it reproduces the fixed generator's
# stage widths exactly; category means follow core/graphs/pegasus.py.

def _montage(g: TaskGraph, s: _Sampler, n: int):
    """Astronomy mosaic: W projections -> ~1.55W diff-fits -> concat ->
    bgmodel -> W backgrounds -> imgtbl -> add -> shrink -> jpeg."""
    W = max(2, round((n - 6) / 3.55))
    D = max(1, round(1.55 * W))
    proj = [g.new_task(s.dur(15), outputs=[s.size(4), s.size(1)],
                       name="mProjectPP") for _ in range(W)]
    diffs = [g.new_task(s.dur(10),
                        inputs=[proj[i % W].outputs[0],
                                proj[(i + 1) % W].outputs[0]],
                        outputs=[s.size(0.6), s.size(0.2)], name="mDiffFit")
             for i in range(D)]
    concat = g.new_task(s.dur(25), inputs=[d.outputs[0] for d in diffs],
                        outputs=[s.size(1)], name="mConcatFit")
    bgmodel = g.new_task(s.dur(40), inputs=concat.outputs,
                         outputs=[s.size(0.2)], name="mBgModel")
    bgs = [g.new_task(s.dur(12), inputs=[p.outputs[0], bgmodel.outputs[0]],
                      outputs=[s.size(4), s.size(1)], name="mBackground")
           for p in proj]
    imgtbl = g.new_task(s.dur(8), inputs=[b.outputs[0] for b in bgs],
                        outputs=[s.size(0.5)], name="mImgtbl")
    madd = g.new_task(s.dur(60), cpus=s.cpus(),
                      inputs=[imgtbl.outputs[0], *(b.outputs[0] for b in bgs)],
                      outputs=[s.size(30), s.size(15), s.size(1)],
                      name="mAdd")
    shrink = g.new_task(s.dur(10), inputs=[madd.outputs[0]],
                        outputs=[s.size(4)], name="mShrink")
    g.new_task(s.dur(4), inputs=shrink.outputs, outputs=[s.size(1)],
               name="mJPEG")


def _cybershake(g: TaskGraph, s: _Sampler, n: int):
    """Seismic hazard: S sites x (extract -> V syntheses, first <=10 get
    peak-value calcs); ZipSeis + ZipPSA collect everything."""
    S = max(1, round((n - 2) / 51))
    V = max(3, round((n - 2) / S) - 11)
    P = min(10, V)
    seis_all, peaks = [], []
    for _ in range(S):
        ex = g.new_task(s.dur(110), cpus=s.cpus(), outputs=[s.size(150)],
                        name="ExtractSGT")
        for v in range(V):
            t = g.new_task(s.dur(45), inputs=ex.outputs,
                           outputs=[s.size(3)], name="SeismogramSynthesis")
            seis_all.append(t)
            if v < P:
                peaks.append(g.new_task(s.dur(6), inputs=t.outputs,
                                        outputs=[s.size(0.1)],
                                        name="PeakValCalc"))
    g.new_task(s.dur(30), inputs=[t.outputs[0] for t in seis_all],
               outputs=[s.size(100), s.size(10)], name="ZipSeis")
    g.new_task(s.dur(20), inputs=[p.outputs[0] for p in peaks],
               outputs=[s.size(2), s.size(0.5)], name="ZipPSA")


def _epigenomics(g: TaskGraph, s: _Sampler, n: int):
    """Genome sequencing: L lanes x C chunks, per-chunk chain of
    filter -> sol2sanger -> fastq2bfq -> map, lane merges + global."""
    L = max(1, round((n - 4) / 50))
    C = max(1, round(((n - 4) / L - 2) / 4))
    lane_merges = []
    for _ in range(L):
        split = g.new_task(s.dur(40), outputs=[s.size(25) for _ in range(C)],
                           name="fastQSplit")
        maps = []
        for c in range(C):
            f = g.new_task(s.dur(20), inputs=[split.outputs[c]],
                           outputs=[s.size(22), s.size(1)],
                           name="filterContams")
            ss = g.new_task(s.dur(15), inputs=f.outputs,
                            outputs=[s.size(22)], name="sol2sanger")
            q = g.new_task(s.dur(12), inputs=ss.outputs,
                           outputs=[s.size(12)], name="fastq2bfq")
            maps.append(g.new_task(s.dur(90), cpus=s.cpus(), inputs=q.outputs,
                                   outputs=[s.size(9)], name="map"))
        lane_merges.append(g.new_task(s.dur(35),
                                      inputs=[m.outputs[0] for m in maps],
                                      outputs=[s.size(90), s.size(5)],
                                      name="mapMerge"))
    gm = g.new_task(s.dur(50), inputs=[m.outputs[0] for m in lane_merges],
                    outputs=[s.size(320), s.size(10), s.size(10)],
                    name="mapMergeAll")
    idx = g.new_task(s.dur(45), inputs=[gm.outputs[0]],
                     outputs=[s.size(3), s.size(1)], name="maqIndex")
    pu = g.new_task(s.dur(30), inputs=[idx.outputs[0]],
                    outputs=[s.size(1), s.size(1)], name="pileup")
    g.new_task(s.dur(10), inputs=[pu.outputs[0]],
               outputs=[s.size(0.5), s.size(0.2)], name="display")


def _mapreduce(g: TaskGraph, s: _Sampler, n: int):
    """MapReduce: m maps each feeding one shard to each of m reduces,
    one collector (irw's ``mapreduce`` at m = 160)."""
    m = max(2, round((n - 1) / 2))
    maps = [g.new_task(s.dur(120), outputs=[s.size(17.4) for _ in range(m)],
                       name="map") for _ in range(m)]
    reds = [g.new_task(s.dur(80), inputs=[mp.outputs[r] for mp in maps],
                       outputs=[s.size(20)], name="reduce")
            for r in range(m)]
    g.new_task(s.dur(30), inputs=[r.outputs[0] for r in reds],
               name="collect")


RECIPE_FAMILIES = {
    "montage": _montage,
    "cybershake": _cybershake,
    "epigenomics": _epigenomics,
    "mapreduce": _mapreduce,
}

# task counts at which the recipes reproduce the fixed generators'
# structural parameters (core/graphs/pegasus.py, core/graphs/irw.py)
PEGASUS_EQUIVALENT = {"montage": 77, "cybershake": 104,
                      "epigenomics": 204, "mapreduce": 321}


@dataclasses.dataclass(frozen=True)
class Recipe:
    """One buildable synthetic-workflow instance spec."""
    name: str                  # family, key into RECIPE_FAMILIES
    n_tasks: int               # requested scale (see module docstring)
    seed: int = 0
    cpus_dist: tuple = ("randint", 2, 4)
    duration_dist: tuple = ("tnormal", 1.0, 0.2)
    size_dist: tuple = ("tnormal", 1.0, 0.2)

    def __post_init__(self):
        if self.name not in RECIPE_FAMILIES:
            raise KeyError(f"unknown recipe family {self.name!r} "
                           f"(have {sorted(RECIPE_FAMILIES)})")
        if self.n_tasks < 4:
            raise ValueError(f"n_tasks {self.n_tasks} too small (need >= 4)")

    @property
    def instance_name(self) -> str:
        return f"{self.name}-{self.n_tasks}-s{self.seed}"

    def build(self) -> TaskGraph:
        rseed = instance_rng_seed(self.name, self.n_tasks, self.seed)
        rng = random.Random(rseed)
        g = TaskGraph(self.instance_name)
        RECIPE_FAMILIES[self.name](g, _Sampler(rng, self), self.n_tasks)
        return finish(g, rseed)


_INSTANCE_RE = re.compile(r"^([a-z0-9_]+)-(\d+)-s(\d+)$")


def parse_instance(name: str):
    """``Recipe`` for an instance name, or ``None`` when the name does
    not match the ``<family>-<n>-s<seed>`` grammar."""
    m = _INSTANCE_RE.match(name)
    if not m or m.group(1) not in RECIPE_FAMILIES:
        return None
    return Recipe(m.group(1), int(m.group(2)), int(m.group(3)))


def make_instance(name: str, seed: int = 0) -> TaskGraph:
    """Build a recipe instance by name.  ``seed`` *offsets* the seed
    embedded in the name (``make_graph``'s seed plumbing: the default 0
    reproduces the named instance exactly)."""
    rec = parse_instance(name)
    if rec is None:
        raise KeyError(f"not a recipe instance name: {name!r} "
                       f"(grammar '<family>-<n>-s<seed>', families "
                       f"{sorted(RECIPE_FAMILIES)})")
    if seed:
        rec = dataclasses.replace(rec, seed=rec.seed + seed)
    return rec.build()
