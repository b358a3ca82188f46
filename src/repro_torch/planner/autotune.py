"""Scheduler-in-the-loop plan autotuning.

Candidate pipeline plans (stage count x microbatches x schedule rule) are
ranked by their simulated makespan under the paper's *max-min fairness*
network model — the paper's F1 finding (the `simple` model mis-estimates
by up to an order of magnitude) is exactly why the realistic model sits in
this loop.  Returns the best plan + the full ranking.  The simulator is
the port's copy of the reference event loop, on the host; ``hw`` (default
``roofline.H100_SXM``) gives the stages' peak and the link bandwidth.
"""
from __future__ import annotations

from ..core.schedulers.fixed import FixedScheduler
from ..core.simulator import Simulator
from ..core.worker import Worker
from ..launch.roofline import H100_SXM, Hardware
from .extract import PipelinePlan, plan_assignment, plan_graph


def simulate_plan(cfg, shape, plan: PipelinePlan, netmodel="maxmin",
                  hw: Hardware = H100_SXM):
    g = plan_graph(cfg, shape, plan, hw=hw)
    assign, prio = plan_assignment(g, plan)
    workers = [Worker(k, 1) for k in range(plan.n_stages)]
    sched = FixedScheduler(assign, prio)
    rep = Simulator(g, workers, sched, netmodel=netmodel,
                    bandwidth=hw.link_bw, imode="exact",
                    msd=0.0, decision_delay=0.0).run()
    return rep


def autotune(cfg, shape, stage_candidates=(2, 4, 8),
             micro_candidates=(4, 8, 16, 32),
             rules=("depth", "micro"), netmodel="maxmin",
             total_chips=64, hw: Hardware = H100_SXM):
    """Grid-search plans; returns (best_plan, ranking list)."""
    results = []
    for K in stage_candidates:
        if cfg.n_layers % K:
            continue
        for M in micro_candidates:
            if shape.global_batch % M or M < K:
                continue
            for rule in rules:
                plan = PipelinePlan(n_stages=K, n_micro=M,
                                    priority_rule=rule,
                                    chips_per_stage=total_chips // K)
                rep = simulate_plan(cfg, shape, plan, netmodel=netmodel,
                                    hw=hw)
                results.append((rep.makespan, plan, rep))
    results.sort(key=lambda r: r[0])
    return results[0][1], results
