"""Frozen copy of the estee dataset generators the benchmark makes its
inputs with: the 16 *elementary* graphs and the 5 stylised *pegasus*
workflows (paper Table 1; estee's ``benchmarks/README.md``, zenodo
10.5281/zenodo.2630384).  Structure (tasks, objects, edges, cores) is
fixed per graph; ``seed`` draws the durations, sizes and the ``user``
imode's category estimates, so every seed gives the same shapes.

Both the program and the reference read the graphs made here."""
from __future__ import annotations

import math
import random

from .taskgraph import MiB, TaskGraph


# --------------------------------------------------------------- util
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


# --------------------------------------------------------- elementary
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


# ------------------------------------------------------------ pegasus
def montage(seed=0):
    """Astronomy mosaic: 20 mProjectPP -> 31 mDiffFit -> mConcatFit ->
    mBgModel -> 20 mBackground -> mImgtbl -> mAdd -> mShrink -> mJPEG."""
    rng = random.Random(seed)
    g = TaskGraph("montage")
    proj = [g.new_task(tnormal(rng, 15, 3),
                       outputs=[tnormal(rng, 4, 0.5) * MiB,
                                tnormal(rng, 1, 0.2) * MiB], name="mProjectPP")
            for _ in range(20)]
    diffs = []
    for i in range(31):
        a, b = proj[i % 20], proj[(i + 1) % 20]
        diffs.append(g.new_task(tnormal(rng, 10, 2),
                                inputs=[a.outputs[0], b.outputs[0]],
                                outputs=[tnormal(rng, 0.6, 0.1) * MiB,
                                         tnormal(rng, 0.2, 0.05) * MiB],
                                name="mDiffFit"))
    concat = g.new_task(tnormal(rng, 25, 4),
                        inputs=[d.outputs[0] for d in diffs],
                        outputs=[tnormal(rng, 1, 0.1) * MiB],
                        name="mConcatFit")
    bgmodel = g.new_task(tnormal(rng, 40, 6), inputs=concat.outputs,
                         outputs=[tnormal(rng, 0.2, 0.02) * MiB],
                         name="mBgModel")
    bgs = [g.new_task(tnormal(rng, 12, 2),
                      inputs=[p.outputs[0], bgmodel.outputs[0]],
                      outputs=[tnormal(rng, 4, 0.5) * MiB,
                               tnormal(rng, 1, 0.2) * MiB], name="mBackground")
           for p in proj]
    imgtbl = g.new_task(tnormal(rng, 8, 1),
                        inputs=[b.outputs[0] for b in bgs],
                        outputs=[tnormal(rng, 0.5, 0.05) * MiB],
                        name="mImgtbl")
    madd = g.new_task(tnormal(rng, 60, 8),
                      inputs=[imgtbl.outputs[0], *(b.outputs[0] for b in bgs)],
                      outputs=[tnormal(rng, 30, 3) * MiB,
                               tnormal(rng, 15, 2) * MiB,
                               tnormal(rng, 1, 0.2) * MiB], name="mAdd")
    shrink = g.new_task(tnormal(rng, 10, 2), inputs=[madd.outputs[0]],
                        outputs=[tnormal(rng, 4, 0.5) * MiB], name="mShrink")
    g.new_task(tnormal(rng, 4, 0.5), inputs=shrink.outputs,
               outputs=[tnormal(rng, 1, 0.2) * MiB], name="mJPEG")
    return finish(g, seed)


def cybershake(seed=0):
    """Seismic hazard: 2 ExtractSGT fan out to 40 SeismogramSynthesis each;
    10 PeakValCalc per site; ZipSeis + ZipPSA collect everything."""
    rng = random.Random(seed)
    g = TaskGraph("cybershake")
    peaks = []
    seis_all = []
    for site in range(2):
        ex = g.new_task(tnormal(rng, 110, 15),
                        outputs=[tnormal(rng, 150, 15) * MiB],
                        name="ExtractSGT", cpus=2)
        for v in range(40):
            s = g.new_task(tnormal(rng, 45, 8), inputs=ex.outputs,
                           outputs=[tnormal(rng, 3, 0.4) * MiB],
                           name="SeismogramSynthesis")
            seis_all.append(s)
            if v < 10:
                p = g.new_task(tnormal(rng, 6, 1), inputs=s.outputs,
                               outputs=[tnormal(rng, 0.1, 0.02) * MiB],
                               name="PeakValCalc")
                peaks.append(p)
    g.new_task(tnormal(rng, 30, 4),
               inputs=[s.outputs[0] for s in seis_all],
               outputs=[tnormal(rng, 100, 8) * MiB,
                        tnormal(rng, 10, 2) * MiB], name="ZipSeis")
    g.new_task(tnormal(rng, 20, 3),
               inputs=[p.outputs[0] for p in peaks],
               outputs=[tnormal(rng, 2, 0.2) * MiB,
                        tnormal(rng, 0.5, 0.1) * MiB], name="ZipPSA")
    return finish(g, seed)


def epigenomics(seed=0):
    """Genome sequencing pipeline: 4 lanes x 12 chunks, per-chunk chain of
    filter->sol2sanger->fastq2bfq->map, then per-lane merge chain + global."""
    rng = random.Random(seed)
    g = TaskGraph("epigenomics")
    lane_merges = []
    for lane in range(4):
        fastqsplit = g.new_task(tnormal(rng, 40, 6),
                                outputs=[tnormal(rng, 25, 3) * MiB
                                         for _ in range(12)],
                                name="fastQSplit")
        maps = []
        for c in range(12):
            f = g.new_task(tnormal(rng, 20, 3),
                           inputs=[fastqsplit.outputs[c]],
                           outputs=[tnormal(rng, 22, 3) * MiB,
                                    tnormal(rng, 1, 0.2) * MiB],
                           name="filterContams")
            s = g.new_task(tnormal(rng, 15, 2), inputs=f.outputs,
                           outputs=[tnormal(rng, 22, 3) * MiB],
                           name="sol2sanger")
            q = g.new_task(tnormal(rng, 12, 2), inputs=s.outputs,
                           outputs=[tnormal(rng, 12, 2) * MiB],
                           name="fastq2bfq")
            m = g.new_task(tnormal(rng, 90, 12), inputs=q.outputs, cpus=4,
                           outputs=[tnormal(rng, 9, 1) * MiB], name="map")
            maps.append(m)
        mm = g.new_task(tnormal(rng, 35, 5),
                        inputs=[m.outputs[0] for m in maps],
                        outputs=[tnormal(rng, 90, 10) * MiB,
                                 tnormal(rng, 5, 1) * MiB], name="mapMerge")
        lane_merges.append(mm)
    gm = g.new_task(tnormal(rng, 50, 7),
                    inputs=[m.outputs[0] for m in lane_merges],
                    outputs=[tnormal(rng, 320, 25) * MiB,
                             tnormal(rng, 10, 2) * MiB,
                             tnormal(rng, 10, 2) * MiB], name="mapMergeAll")
    idx = g.new_task(tnormal(rng, 45, 6), inputs=[gm.outputs[0]],
                     outputs=[tnormal(rng, 3, 0.4) * MiB,
                              tnormal(rng, 1, 0.2) * MiB], name="maqIndex")
    pu = g.new_task(tnormal(rng, 30, 4), inputs=[idx.outputs[0]],
                    outputs=[tnormal(rng, 1, 0.2) * MiB,
                             tnormal(rng, 1, 0.2) * MiB], name="pileup")
    g.new_task(tnormal(rng, 10, 2), inputs=[pu.outputs[0]],
               outputs=[tnormal(rng, 0.5, 0.1) * MiB,
                        tnormal(rng, 0.2, 0.05) * MiB], name="display")
    return finish(g, seed)


def ligo(seed=0):
    """Gravitational-wave inspiral: 2 blocks of (23 TmpltBank -> 23
    Inspiral -> Thinca -> 22 TrigBank -> 23 Inspiral2 -> Thinca2)."""
    rng = random.Random(seed)
    g = TaskGraph("ligo")
    for block in range(2):
        banks = [g.new_task(tnormal(rng, 35, 5),
                            outputs=[tnormal(rng, 1.2, 0.2) * MiB],
                            name="TmpltBank") for _ in range(23)]
        insp = [g.new_task(tnormal(rng, 160, 25), inputs=b.outputs, cpus=2,
                           outputs=[tnormal(rng, 2.4, 0.3) * MiB],
                           name="Inspiral") for b in banks]
        th = g.new_task(tnormal(rng, 10, 2),
                        inputs=[i.outputs[0] for i in insp],
                        outputs=[tnormal(rng, 1, 0.1) * MiB], name="Thinca")
        trig = [g.new_task(tnormal(rng, 8, 1), inputs=th.outputs,
                           outputs=[tnormal(rng, 1.1, 0.15) * MiB],
                           name="TrigBank") for _ in range(22)]
        insp2 = [g.new_task(tnormal(rng, 140, 22),
                            inputs=trig[min(i, 21)].outputs, cpus=2,
                            outputs=[tnormal(rng, 2.2, 0.3) * MiB],
                            name="Inspiral2") for i in range(23)]
        g.new_task(tnormal(rng, 10, 2),
                   inputs=[i.outputs[0] for i in insp2],
                   outputs=[tnormal(rng, 1, 0.1) * MiB], name="Thinca2")
    return finish(g, seed)


def sipht(seed=0):
    """sRNA identification: parallel annotate/blast stages feeding SRNA,
    then FFN/patser aggregation (single instance)."""
    rng = random.Random(seed)
    g = TaskGraph("sipht")
    patsers = [g.new_task(tnormal(rng, 12, 2),
                          outputs=[tnormal(rng, 0.8, 0.1) * MiB,
                                   tnormal(rng, 0.3, 0.05) * MiB],
                          name="Patser") for _ in range(21)]
    pc = g.new_task(tnormal(rng, 5, 1),
                    inputs=[p.outputs[0] for p in patsers],
                    outputs=[tnormal(rng, 1.5, 0.2) * MiB,
                             tnormal(rng, 0.5, 0.1) * MiB],
                    name="PatserConcat")
    blasts = []
    for name in ("BlastAll", "BlastSynteny", "BlastCand", "BlastQRNA",
                 "BlastParalog"):
        blasts.append(g.new_task(
            tnormal(rng, 90, 12), cpus=2,
            outputs=[tnormal(rng, 12, 2) * MiB, tnormal(rng, 6, 1) * MiB,
                     tnormal(rng, 3, 0.5) * MiB, tnormal(rng, 1, 0.2) * MiB],
            name=name))
    annots = [g.new_task(tnormal(rng, 25, 4),
                         outputs=[tnormal(rng, 3, 0.4) * MiB,
                                  tnormal(rng, 1, 0.2) * MiB],
                         name="Annotate") for _ in range(30)]
    srna = g.new_task(tnormal(rng, 60, 8),
                      inputs=([pc.outputs[0]] +
                              [b.outputs[0] for b in blasts] +
                              [a.outputs[0] for a in annots]),
                      outputs=[tnormal(rng, 8, 1) * MiB
                               for _ in range(5)], name="SRNA")
    ffn = g.new_task(tnormal(rng, 20, 3), inputs=[srna.outputs[0]],
                     outputs=[tnormal(rng, 2, 0.3) * MiB,
                              tnormal(rng, 1, 0.2) * MiB], name="FFN_Parse")
    for _ in range(5):
        g.new_task(tnormal(rng, 15, 2),
                   inputs=[ffn.outputs[0], srna.outputs[1]],
                   outputs=[tnormal(rng, 1, 0.1) * MiB], name="SRNA_Annotate")
    return finish(g, seed)


PEGASUS = {
    "montage": montage,
    "cybershake": cybershake,
    "epigenomics": epigenomics,
    "ligo": ligo,
    "sipht": sipht,
}


DATASETS = {"elementary": ELEMENTARY, "pegasus": PEGASUS}


def make_graph(dataset: str, name: str, seed: int) -> TaskGraph:
    """Graph ``name`` of ``dataset`` drawn with ``seed``."""
    return DATASETS[dataset][name](seed=seed)
