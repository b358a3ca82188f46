"""Stylised Pegasus scientific workflows (paper Table 1): montage,
cybershake, epigenomics, ligo, sipht.  Shapes follow the Synthetic Workflow
Generator structure [Silva et al. 2014]; node counts are tuned to Table 1
(#T exact; #O exact or within a few objects — tests assert an envelope).
Each task needs at most 4 cores, as in the paper."""
from __future__ import annotations

import random

from ..taskgraph import TaskGraph, MiB
from .util import tnormal, finish


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

# representatives for the paper-grid survey runner (benchmarks/survey.py)
SURVEY = ("sipht", "montage", "cybershake")
