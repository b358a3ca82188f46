"""The port's roofline model and pipeline planner against the reference
package's.

Given the reference's own hardware constants (a ``Hardware`` built from
``repro.launch.roofline``'s ``PEAK_FLOPS``, ``HBM_BW`` and ``LINK_BW``),
``repro_torch.launch.roofline`` and ``repro_torch.planner`` must give the
reference's numbers exactly: ``model_flops`` on every config and shape,
``terms_from_totals``, ``plan_graph`` task by task, ``plan_assignment``,
and ``autotune``'s ranking (names and makespans).  With their default,
``H100_SXM``, every task lasts the reference's time scaled by the ratio of
the two bf16 peaks, and the modules hold none of the reference's figures.
"""
import dataclasses
import pathlib

import pytest

pytest.importorskip("torch")

from repro import configs as jcfgs  # noqa: E402
from repro import planner as jplanner  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch import planner  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402

REF_HW = roofline.Hardware(name="reference", peak_flops_bf16=jroof.PEAK_FLOPS,
                           peak_flops_f32=jroof.PEAK_FLOPS,
                           hbm_bw=jroof.HBM_BW, link_bw=jroof.LINK_BW)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _shape(name):
    s = jcfgs.SHAPES[name]
    return tcfgs.ShapeSpec(s.name, s.seq_len, s.global_batch, s.kind)


@pytest.mark.parametrize("arch", jcfgs.ARCH_NAMES)
def test_model_flops_equal_the_reference(arch):
    for name in jcfgs.SHAPE_NAMES:
        want = jroof.model_flops(jcfgs.get_config(arch), jcfgs.SHAPES[name])
        got = roofline.model_flops(tcfgs.get_config(arch), _shape(name))
        assert got == want, (arch, name)
        assert tcfgs.SHAPES[name] == _shape(name)


@pytest.mark.parametrize("kw", [
    dict(flops=3e14, hbm_bytes=2e11, coll_bytes=1e10, n_chips=4,
         model_flops=9e14),
    dict(flops=1e12, hbm_bytes=8e12, coll_bytes=0.0, n_chips=1),
    dict(flops=0.0, hbm_bytes=1.0, coll_bytes=5e12, n_chips=64,
         model_flops=1e15),
])
def test_terms_from_totals_equal_the_reference(kw):
    assert roofline.terms_from_totals(**kw, hw=REF_HW) == \
        jroof.terms_from_totals(**kw)
    got = roofline.terms_from_totals(**kw)
    assert got["compute_s"] == kw["flops"] / 989e12
    assert got["memory_s"] == kw["hbm_bytes"] / 3.35e12
    assert got["collective_s"] == kw["coll_bytes"] / 450e9


def _tasks(g):
    """Each task's name, duration, output sizes and inputs (producer
    task id, output index), in id order."""
    out = []
    for t in g.tasks:
        out.append((t.id, t.name, t.duration, t.cpus,
                    [o.size for o in t.outputs],
                    [(o.parent.id, o.parent.outputs.index(o))
                     for o in t.inputs]))
    return out


def _plan_pair(arch, shape, plan_kw, hw=REF_HW):
    jplan = jplanner.PipelinePlan(**plan_kw)
    tplan = planner.PipelinePlan(**plan_kw)
    assert jplan.name == tplan.name
    jg = jplanner.plan_graph(jcfgs.get_config(arch), jcfgs.SHAPES[shape],
                             jplan)
    tg = planner.plan_graph(tcfgs.get_config(arch), _shape(shape), tplan,
                            hw=hw)
    return jplan, tplan, jg, tg


def _candidates(arch, shape, stage=(2, 4, 8), micro=(4, 8, 16, 32),
                rules=("depth", "micro"), total=64):
    """Every plan ``autotune`` tries at its defaults."""
    cfg, s = jcfgs.get_config(arch), jcfgs.SHAPES[shape]
    return [dict(n_stages=K, n_micro=M, priority_rule=r,
                 chips_per_stage=total // K)
            for K in stage if not cfg.n_layers % K
            for M in micro if not s.global_batch % M and M >= K
            for r in rules]


PLAN_CASES = [dict(n_stages=4, n_micro=8), dict(n_stages=4, n_micro=4),
              dict(n_stages=4, n_micro=32),
              dict(n_stages=2, n_micro=8, priority_rule="micro")]
PLAN_CASES += _candidates("qwen3-32b", "train_4k")


@pytest.mark.parametrize("plan_kw", PLAN_CASES,
                         ids=lambda kw: planner.PipelinePlan(**kw).name
                         + f"-c{kw.get('chips_per_stage', 8)}")
def test_plan_graph_and_assignment_equal_the_reference(plan_kw):
    jplan, tplan, jg, tg = _plan_pair("qwen3-32b", "train_4k", plan_kw)
    tg.validate()
    assert tg.name == jg.name and tg.task_count == jg.task_count
    assert _tasks(tg) == _tasks(jg)
    ja, jp = jplanner.plan_assignment(jg, jplan)
    ta, tp = planner.plan_assignment(tg, tplan)
    assert {t.id: w for t, w in ta.items()} == \
        {t.id: w for t, w in ja.items()}
    assert {t.id: p for t, p in tp.items()} == \
        {t.id: p for t, p in jp.items()}


@pytest.mark.parametrize("arch", ["qwen3-32b", "mixtral-8x22b"])
@pytest.mark.parametrize("netmodel", ["maxmin", "simple"])
def test_autotune_ranking_equals_the_reference(arch, netmodel):
    kw = dict(stage_candidates=(2, 4, 8), micro_candidates=(4, 8, 16, 32),
              netmodel=netmodel)
    jbest, jrank = jplanner.autotune(jcfgs.get_config(arch),
                                     jcfgs.SHAPES["train_4k"], **kw)
    best, rank = planner.autotune(tcfgs.get_config(arch),
                                  _shape("train_4k"), hw=REF_HW, **kw)
    assert best.name == jbest.name
    assert [(m, p.name) for m, p, _ in rank] == \
        [(m, p.name) for m, p, _ in jrank]
    assert len(rank) >= 4


def test_h100_durations_scale_by_the_peak_ratio():
    for plan_kw in PLAN_CASES[:4]:
        _, _, jg, tg = _plan_pair("qwen3-32b", "train_4k", plan_kw,
                                  hw=roofline.H100_SXM)
        for a, b in zip(tg.tasks, jg.tasks):
            assert a.duration == pytest.approx(
                b.duration * jroof.PEAK_FLOPS / 989e12, rel=1e-12)
            assert [o.size for o in a.outputs] == \
                [o.size for o in b.outputs]
    # and the H100 link in the simulation: a faster card, a shorter step
    plan = dict(n_stages=4, n_micro=8)
    h100 = planner.simulate_plan(tcfgs.get_config("qwen3-32b"),
                                 _shape("train_4k"),
                                 planner.PipelinePlan(**plan)).makespan
    ref = jplanner.simulate_plan(jcfgs.get_config("qwen3-32b"),
                                 jcfgs.SHAPES["train_4k"],
                                 jplanner.PipelinePlan(**plan)).makespan
    assert 0 < h100 < ref


def test_simulate_plan_takes_the_link_from_hw():
    cfg, shape = tcfgs.get_config("qwen3-32b"), _shape("train_4k")
    plan = planner.PipelinePlan(4, 8)
    ib = dataclasses.replace(roofline.H100_SXM, link_bw=50e9)
    nv = planner.simulate_plan(cfg, shape, plan).makespan
    assert planner.simulate_plan(cfg, shape, plan, hw=ib).makespan > nv
    want = jplanner.simulate_plan(jcfgs.get_config("qwen3-32b"),
                                  jcfgs.SHAPES["train_4k"],
                                  jplanner.PipelinePlan(4, 8)).makespan
    assert planner.simulate_plan(cfg, shape, plan,
                                 hw=REF_HW).makespan == want


def test_the_port_holds_no_reference_figure():
    """The H100's rates are the defaults; the reference's TPU figures
    (197e12, 819e9) appear nowhere in the new modules."""
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == \
        (989e12, 3.35e12, 450e9)
    assert roofline.H100_SXM.peak_flops_f32 == 67e12
    port = ROOT / "src" / "repro_torch"
    for path in [port / "launch" / "roofline.py",
                 *(port / "planner").glob("*.py")]:
        text = path.read_text()
        for figure in ("197e12", "819e9", "TPU", "v5e", "ICI"):
            assert figure not in text, (path.name, figure)
