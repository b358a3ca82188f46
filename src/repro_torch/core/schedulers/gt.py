"""Greedy-transfer variants (paper §4.3): blevel-gt, tlevel-gt, mcp-gt.

The "greedy transfer" heuristic keeps the list scheduler's static task
priorities but performs worker selection *online* against actual cluster
state: an assigned task goes to a worker that has enough free cores and
needs the minimal amount of data transferred (sum of sizes of input objects
not yet present there).  When a task needing ``c`` cores cannot be placed,
the list walk continues, but subsequent tasks may only consider workers
with fewer than ``c`` total cores (they could never run the blocked task,
so occupying them cannot delay it).  With a homogeneous cluster this
degrades to ordinary list scheduling, as the paper notes.

A copy of ``repro.core.schedulers.gt`` for the PyTorch port, which
imports nothing of the reference package: the logic is the reference's,
only the imports differ."""
from __future__ import annotations

from ..worker import Assignment
from .base import (SchedulerBase, compute_blevel, compute_tlevel,
                   compute_alap)


class GreedyTransferScheduler(SchedulerBase):
    name = "gt-base"

    def static_priority(self):
        """task -> larger-is-scheduled-earlier priority."""
        raise NotImplementedError

    def init(self, view):
        super().init(view)
        prio = self.static_priority()
        jitter = {t: self.rng.random() for t in view.graph.tasks}
        self._prio = {t: (prio[t], jitter[t]) for t in view.graph.tasks}
        self._pending = []

    def schedule(self, new_ready, new_finished):
        view = self.view
        self._pending.extend(t for t in new_ready
                             if view.assigned_worker(t) is None)
        self._pending.sort(key=lambda t: self._prio[t], reverse=True)
        free = {w: w.free_cores for w in view.workers}
        out = []
        still_pending = []
        blocked_limit = None        # workers must have < blocked_limit cores
        for t in self._pending:
            cand = [w for w in view.workers
                    if w.cores >= t.cpus and free[w] >= t.cpus]
            if blocked_limit is not None:
                cand = [w for w in cand if w.cores < blocked_limit]
            if not cand:
                blocked_limit = (t.cpus if blocked_limit is None
                                 else min(blocked_limit, t.cpus))
                still_pending.append(t)
                continue
            best, best_cost = [], None
            for w in cand:
                cost = view.transfer_cost(t, w)
                if best_cost is None or cost < best_cost - 1e-9:
                    best, best_cost = [w], cost
                elif abs(cost - best_cost) <= 1e-9:
                    best.append(w)
            w = self.rng.choice(best)
            free[w] -= t.cpus
            out.append(Assignment(t, w, priority=self._prio[t][0]))
        self._pending = still_pending
        return out


class BlevelGTScheduler(GreedyTransferScheduler):
    name = "blevel-gt"

    def static_priority(self):
        return compute_blevel(self.view)


class TlevelGTScheduler(GreedyTransferScheduler):
    name = "tlevel-gt"

    def static_priority(self):
        tl = compute_tlevel(self.view)
        return {t: -v for t, v in tl.items()}      # smaller t-level first


class MCPGTScheduler(GreedyTransferScheduler):
    name = "mcp-gt"

    def static_priority(self):
        alap = compute_alap(self.view)
        return {t: -v for t, v in alap.items()}    # smaller ALAP first
