"""Classic static list schedulers (paper §4.3): blevel/HLFET, tlevel/SCFET,
dls, mcp, etf — implemented as closely as possible to their original
descriptions, with the paper's "simple estimation" worker selection.

A copy of ``repro.core.schedulers.list_schedulers`` for the PyTorch
port, which imports nothing of the reference package: the logic is the
reference's, only the imports differ."""
from __future__ import annotations

from ..worker import Assignment
from .base import (SchedulerBase, StaticListScheduler, EarliestStartPlacer,
                   compute_blevel, compute_tlevel, compute_alap)


class BlevelScheduler(StaticListScheduler):
    """HLFET [Adam et al. 1974]: decreasing static b-level."""

    name = "blevel"

    def task_order(self):
        bl = compute_blevel(self.view)
        tasks = self._shuffled(self.view.graph.tasks)     # random tie-break
        return sorted(tasks, key=lambda t: -bl[t])


class TlevelScheduler(StaticListScheduler):
    """SCFET [Kwok & Ahmad 1999]: increasing t-level (smallest co-level)."""

    name = "tlevel"

    def task_order(self):
        tl = compute_tlevel(self.view)
        tasks = self._shuffled(self.view.graph.tasks)
        return sorted(tasks, key=lambda t: tl[t])


class MCPScheduler(StaticListScheduler):
    """Modified Critical Path [Wu & Gajski 1990]: ascending ALAP, worker
    allowing the earliest execution."""

    name = "mcp"

    def task_order(self):
        alap = compute_alap(self.view)
        tasks = self._shuffled(self.view.graph.tasks)
        return sorted(tasks, key=lambda t: alap[t])


class DLSScheduler(SchedulerBase):
    """Dynamic Level Scheduling [Sih & Lee 1993]: at each step pick the
    (task, worker) pair maximising  DL = SL(t) - EST(t, w)."""

    name = "dls"

    def init(self, view):
        super().init(view)
        self._assigned = False

    def schedule(self, new_ready, new_finished):
        if self._assigned:
            return []
        self._assigned = True
        view = self.view
        graph = view.graph
        sl = compute_blevel(view)
        placer = EarliestStartPlacer(view, self.rng)
        unscheduled = set(graph.tasks)
        n = len(graph.tasks)
        out = []
        rank = 0
        while unscheduled:
            frontier = [t for t in unscheduled
                        if all(p not in unscheduled for p in t.parents)]
            best, best_dl = [], None
            for t in frontier:
                for w in placer.candidates(t):
                    dl = sl[t] - placer.est_start(t, w)
                    if best_dl is None or dl > best_dl + 1e-12:
                        best, best_dl = [(t, w)], dl
                    elif abs(dl - best_dl) <= 1e-12:
                        best.append((t, w))
            t, w = self.rng.choice(best)
            placer.commit(t, w, placer.est_start(t, w))
            unscheduled.remove(t)
            out.append(Assignment(t, w, priority=float(n - rank)))
            rank += 1
        return out


class ETFScheduler(SchedulerBase):
    """Earliest Time First [Hwang et al. / Dolev & Warmuth]: pick the
    (ready task, worker) pair with the earliest start; ties by higher
    static b-level, then random."""

    name = "etf"

    def init(self, view):
        super().init(view)
        self._assigned = False

    def schedule(self, new_ready, new_finished):
        if self._assigned:
            return []
        self._assigned = True
        view = self.view
        graph = view.graph
        bl = compute_blevel(view)
        placer = EarliestStartPlacer(view, self.rng)
        unscheduled = set(graph.tasks)
        n = len(graph.tasks)
        out = []
        rank = 0
        while unscheduled:
            frontier = [t for t in unscheduled
                        if all(p not in unscheduled for p in t.parents)]
            best, best_key = [], None
            for t in frontier:
                for w in placer.candidates(t):
                    est = placer.est_start(t, w)
                    key = (est, -bl[t])
                    if best_key is None or key < best_key:
                        best, best_key = [(t, w)], key
                    elif key == best_key:
                        best.append((t, w))
            t, w = self.rng.choice(best)
            placer.commit(t, w, placer.est_start(t, w))
            unscheduled.remove(t)
            out.append(Assignment(t, w, priority=float(n - rank)))
            rank += 1
        return out
