"""A scheduler that applies a pre-computed assignment (used to validate the
vectorized simulator against the reference simulator, and by the planner to
replay externally-optimized schedules).

A copy of ``repro.core.schedulers.fixed`` for the PyTorch port, which
imports nothing of the reference package: the logic is the reference's,
only the imports differ."""
from __future__ import annotations

from ..worker import Assignment
from .base import SchedulerBase


class FixedScheduler(SchedulerBase):
    name = "fixed"

    def __init__(self, assignment: dict, priorities: dict | None = None,
                 seed: int = 0):
        """assignment: task -> worker id (int) or Worker;
        priorities: task -> float (defaults to reverse task id)."""
        super().__init__(seed)
        self.assignment = assignment
        self.priorities = priorities

    def init(self, view):
        super().init(view)
        self._assigned = False

    def schedule(self, new_ready, new_finished):
        if self._assigned:
            return []
        self._assigned = True
        workers = {w.id: w for w in self.view.workers}
        n = len(self.view.graph.tasks)
        out = []
        for t in self.view.graph.tasks:
            w = self.assignment[t]
            if isinstance(w, int):
                w = workers[w]
            p = (self.priorities[t] if self.priorities is not None
                 else float(n - t.id))
            out.append(Assignment(t, w, priority=p))
        return out
