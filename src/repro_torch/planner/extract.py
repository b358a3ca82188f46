"""Export distributed-execution plans of the 10 LM architectures as ESTEE
task graphs — the bridge that makes the paper's scheduler simulator a
first-class feature of the training framework.

A pipeline-parallel training step of (cfg, shape) partitioned into K
stages with M microbatches becomes a DAG: forward task (m, k) produces the
boundary activation consumed by (m, k+1); backward task (m, k) consumes
the forward activation of (m, k) plus the gradient from (m, k+1); a final
optimizer task per stage consumes that stage's last backward.  Durations
come from analytic per-stage FLOPs at the card's bf16 peak (``hw``,
default ``roofline.H100_SXM``); activation / gradient object sizes from
the boundary tensor shape; the link bandwidth bounds transfers via the
paper's max-min model (``autotune.simulate_plan``).  The logic is the
reference's (``repro/planner/extract.py``); only the hardware differs.
"""
from __future__ import annotations

import dataclasses

from ..core.taskgraph import TaskGraph
from ..launch.roofline import H100_SXM, Hardware


@dataclasses.dataclass(frozen=True)
class PipelinePlan:
    n_stages: int
    n_micro: int
    priority_rule: str = "depth"     # "depth" (1F1B-ish) | "micro" (GPipe)
    chips_per_stage: int = 8

    @property
    def name(self):
        return (f"K{self.n_stages}xM{self.n_micro}-{self.priority_rule}")


def plan_graph(cfg, shape, plan: PipelinePlan, efficiency=0.4,
               hw: Hardware = H100_SXM):
    """Build the ESTEE task graph of one pipeline-parallel train step."""
    K, M = plan.n_stages, plan.n_micro
    assert cfg.n_layers % K == 0, (cfg.n_layers, K)
    assert shape.global_batch % M == 0, (shape.global_batch, M)
    micro_b = shape.global_batch // M
    tokens = micro_b * shape.seq_len

    # per-stage forward flops (active params split evenly over stages)
    n_active = cfg.active_param_count()
    fwd_flops = 2.0 * (n_active / K) * tokens
    fwd_s = fwd_flops / (hw.peak_flops_bf16 * plan.chips_per_stage
                         * efficiency)
    bwd_s = 2.0 * fwd_s
    act_bytes = float(micro_b * shape.seq_len * cfg.d_model * 2)  # bf16
    opt_s = 0.1 * fwd_s

    g = TaskGraph(f"{cfg.name}-{plan.name}")
    fwd = {}
    bwd = {}
    for m in range(M):
        for k in range(K):
            inputs = [fwd[m, k - 1].outputs[0]] if k else []
            fwd[m, k] = g.new_task(fwd_s, outputs=[act_bytes],
                                   inputs=inputs, name=f"fwd{k}")
        for k in reversed(range(K)):
            inputs = [fwd[m, k].outputs[0]]
            if k < K - 1:
                inputs.append(bwd[m, k + 1].outputs[0])
            bwd[m, k] = g.new_task(bwd_s, outputs=[act_bytes],
                                   inputs=inputs, name=f"bwd{k}")
    for k in range(K):
        g.new_task(opt_s, inputs=[bwd[m, k].outputs[0] for m in range(M)],
                   name=f"opt{k}")
    return g


def plan_assignment(g, plan: PipelinePlan):
    """Fixed placement (stage tasks live with their weights) + priorities
    encoding the microbatch schedule."""
    assign = {}
    prio = {}
    n = len(g.tasks)
    for t in g.tasks:
        kind, k = t.name[:3], int(t.name[3:])
        assign[t] = k
        idx = t.id
        if plan.priority_rule == "micro":        # GPipe: finish fwd wave
            prio[t] = float(n - idx)
        else:                                     # depth-first (1F1B-ish)
            # prefer draining backward early: bwd > fwd at same position
            base = 2.0 * n if kind == "bwd" else n
            prio[t] = base - idx
    return assign, prio
