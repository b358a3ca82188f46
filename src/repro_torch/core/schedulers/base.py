"""Scheduler base classes and shared machinery (paper §4.3).

Conventions:

* priorities handed to workers are larger-is-more-important;
* every indistinguishable decision is broken by an explicit RNG (paper:
  "All scheduler implementations use a random choice when an
  indistinguishable decision in the algorithm occurs");
* static list schedulers assign every task on the first invocation using
  imode-filtered estimates; the worker-selection estimator is the paper's
  "simple estimation of the earliest start time based on the currently
  running and already scheduled tasks of a worker and an estimated transfer
  cost based on uncontended network bandwidth".

A copy of ``repro.core.schedulers.base`` for the PyTorch port, which
imports nothing of the reference package: the logic is the reference's,
only the imports differ."""
from __future__ import annotations

import random

from ..worker import Assignment


class SchedulerBase:
    name = "base"

    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)
        self.view = None

    def init(self, view):
        self.view = view
        max_cores = max(w.cores for w in view.workers)
        for t in view.graph.tasks:
            if t.cpus > max_cores:
                raise ValueError(
                    f"{t} needs {t.cpus} cores but the largest worker has "
                    f"{max_cores}")

    def schedule(self, new_ready, new_finished):
        raise NotImplementedError

    # ------------------------------------------------------------- utils
    def _shuffled(self, seq):
        seq = list(seq)
        self.rng.shuffle(seq)
        return seq


# ---------------------------------------------------------------- levels
def compute_blevel(view):
    """b-level: longest path (in task durations) from task to any leaf,
    including the task itself.  Object sizes are not used (paper §4.3)."""
    graph = view.graph
    bl = {}
    for t in reversed(graph.topo_order()):
        bl[t] = view.duration(t) + max((bl[c] for c in t.children), default=0.0)
    return bl


def compute_tlevel(view):
    """t-level: longest path from any source to the task (excl. the task):
    the earliest time the task can start (no comm costs)."""
    graph = view.graph
    tl = {}
    for t in graph.topo_order():
        tl[t] = max((tl[p] + view.duration(p) for p in t.parents), default=0.0)
    return tl


def compute_alap(view):
    """ALAP start time: latest start not increasing the critical-path
    makespan; equals CP_length - blevel."""
    bl = compute_blevel(view)
    cp = max(bl.values(), default=0.0)
    return {t: cp - b for t, b in bl.items()}


def topological_repair(graph, order):
    """Reorder ``order`` into a topological order deviating minimally from
    it (stable Kahn keyed by the position in ``order``)."""
    import heapq
    pos = {t: i for i, t in enumerate(order)}
    indeg = {t: len(t.parents) for t in graph.tasks}
    heap = [(pos[t], t.id) for t in graph.tasks if indeg[t] == 0]
    heapq.heapify(heap)
    by_id = {t.id: t for t in graph.tasks}
    out = []
    while heap:
        _, tid = heapq.heappop(heap)
        t = by_id[tid]
        out.append(t)
        for c in t.children:
            indeg[c] -= 1
            if indeg[c] == 0:
                heapq.heappush(heap, (pos[c], c.id))
    assert len(out) == len(graph.tasks)
    return out


# ------------------------------------------------- earliest-start placer
class EarliestStartPlacer:
    """Estimates earliest start times on a simulated cluster timeline.

    Each worker is modelled as ``cores`` slots with individual free times;
    data readiness assumes uncontended bandwidth (the paper's stated
    simplification for the non-gt list schedulers).
    """

    def __init__(self, view, rng):
        self.view = view
        self.rng = rng
        self.slots = {w: [0.0] * w.cores for w in view.workers}
        self.placed = {}        # task -> (worker, est_finish)

    def data_ready(self, task, worker) -> float:
        ready = 0.0
        bw = self.view.bandwidth
        for o in task.inputs:
            pw, pf = self.placed[o.parent]
            cost = 0.0 if pw is worker else self.view.size(o) / bw
            ready = max(ready, pf + cost)
        return ready

    def core_ready(self, worker, cpus) -> float:
        s = sorted(self.slots[worker])
        return s[cpus - 1]

    def est_start(self, task, worker) -> float:
        return max(self.core_ready(worker, task.cpus),
                   self.data_ready(task, worker))

    def candidates(self, task):
        return [w for w in self.view.workers if w.cores >= task.cpus]

    def place_earliest(self, task):
        """Pick the worker with the earliest est. start (random ties)."""
        best, best_s = [], None
        for w in self.candidates(task):
            s = self.est_start(task, w)
            if best_s is None or s < best_s - 1e-12:
                best, best_s = [w], s
            elif abs(s - best_s) <= 1e-12:
                best.append(w)
        w = self.rng.choice(best)
        self.commit(task, w, best_s)
        return w

    def commit(self, task, worker, start):
        dur = self.view.duration(task)
        slots = self.slots[worker]
        idx = sorted(range(len(slots)), key=lambda i: slots[i])[:task.cpus]
        for i in idx:
            slots[i] = start + dur
        self.placed[task] = (worker, start + dur)

    def makespan(self) -> float:
        return max((f for _, f in self.placed.values()), default=0.0)


class StaticListScheduler(SchedulerBase):
    """Assigns all tasks on the first invocation, in ``task_order()`` order,
    each to the earliest-start worker; priority = reverse list rank."""

    def task_order(self):
        raise NotImplementedError

    def init(self, view):
        super().init(view)
        self._assigned = False

    def schedule(self, new_ready, new_finished):
        if self._assigned:
            return []
        self._assigned = True
        order = topological_repair(self.view.graph, self.task_order())
        placer = EarliestStartPlacer(self.view, self.rng)
        n = len(order)
        out = []
        for rank, t in enumerate(order):
            w = placer.place_earliest(t)
            out.append(Assignment(t, w, priority=float(n - rank)))
        return out


def estimate_makespan(view, assignment: dict, order=None) -> float:
    """Fast makespan estimate for a complete ``task -> worker`` map
    (used as the genetic scheduler's fitness)."""
    graph = view.graph
    if order is None:
        bl = compute_blevel(view)
        order = sorted(graph.tasks, key=lambda t: -bl[t])
        order = topological_repair(graph, order)
    placer = EarliestStartPlacer(view, random.Random(0))
    for t in order:
        w = assignment[t]
        placer.commit(t, w, max(placer.core_ready(w, t.cpus),
                                placer.data_ready(t, w)))
    return placer.makespan()
