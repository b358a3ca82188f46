"""Worker with inner scheduler (*w-scheduler*, paper Appendix A).

The global scheduler only assigns ``(task, worker, priority p_t,
blocking b_t)`` with ``b_t <= p_t``.  The worker then autonomously:

* starts downloads of missing inputs as soon as the producing task has
  finished and a download slot is free.  Download priority of an object is
  the maximum priority over tasks that need it; the priority of a *ready*
  task (all inputs computed somewhere) is boosted by a constant.  Downloads
  are uninterruptible.  Slot limits come from the network model (max-min: at
  most 4 concurrent downloads, at most 2 from the same source worker;
  simple: unlimited).
* starts enabled tasks: with ``f`` free cores, ``E`` enabled non-running
  tasks and ``X = {t in E : t.cpus > f}``, it repeatedly picks the highest-
  priority ``t in E \\ X`` such that ``b_s <= p_t`` for every ``s in X``
  (big blocked tasks guard their place in the queue via their blocking
  value) and starts it.

A copy of ``repro.core.worker`` for the PyTorch port, which imports
nothing of the reference package: the logic is the reference's, only the
imports differ."""
from __future__ import annotations

import dataclasses

READY_BOOST = 1_000_000.0   # priority boost for objects needed by ready tasks


@dataclasses.dataclass
class Assignment:
    task: object
    worker: "Worker"
    priority: float = 0.0
    blocking: float | None = None      # defaults to priority

    def __post_init__(self):
        if self.blocking is None:
            self.blocking = self.priority
        assert self.blocking <= self.priority + 1e-9


@dataclasses.dataclass
class RunningTask:
    task: object
    finish_time: float


class Worker:
    def __init__(self, worker_id: int, cores: int):
        self.id = worker_id
        self.cores = cores
        self.assignments: dict = {}       # task -> Assignment
        self.running: dict = {}           # task -> RunningTask
        self.store: set = set()           # DataObjects present
        self.downloading: dict = {}       # DataObject -> Flow
        self.scheduled_order: list = []   # assignment arrival order (fifo tie)

    # -------------------------------------------------------------- state
    @property
    def free_cores(self) -> int:
        return self.cores - sum(t.cpus for t in self.running)

    def has_object(self, obj) -> bool:
        return obj in self.store

    def assign(self, assignment: Assignment):
        self.assignments[assignment.task] = assignment
        self.scheduled_order.append(assignment.task)

    def unassign(self, task) -> bool:
        """Returns False if the task is running/finished (reschedule fails)."""
        if task in self.running:
            return False
        if task in self.assignments:
            del self.assignments[task]
        return True

    # ---------------------------------------------------------- downloads
    def missing_inputs(self):
        """Objects needed by assigned tasks, not present and not downloading."""
        needed = {}
        for task, a in self.assignments.items():
            if task in self.running:
                continue
            for o in task.inputs:
                if o in self.store or o in self.downloading:
                    continue
                needed.setdefault(o, []).append((task, a))
        return needed

    def download_priority(self, obj, needing, runtime) -> float:
        """Max task priority; boosted when the needing task is ready."""
        best = -float("inf")
        for task, a in needing:
            p = a.priority
            if runtime.is_task_ready(task):
                p += READY_BOOST
            best = max(best, p)
        return best

    # -------------------------------------------------------------- tasks
    def enabled_tasks(self):
        """Assigned, not running, all inputs present in the local store."""
        out = []
        for task, a in self.assignments.items():
            if task in self.running:
                continue
            if all(o in self.store for o in task.inputs):
                out.append((task, a))
        return out

    def pick_startable_tasks(self):
        """Appendix A task-start rule; returns tasks to start (in order)."""
        started = []
        while True:
            f = self.free_cores - sum(t.cpus for t in started)
            enabled = [(t, a) for t, a in self.enabled_tasks()
                       if t not in started]
            if not enabled:
                break
            blocked = [(t, a) for t, a in enabled if t.cpus > f]
            fitting = [(t, a) for t, a in enabled if t.cpus <= f]
            if not fitting:
                break
            max_block = max((a.blocking for _, a in blocked), default=-float("inf"))
            candidates = [(t, a) for t, a in fitting if a.priority >= max_block]
            if not candidates:
                break
            candidates.sort(key=lambda ta: (-ta[1].priority,
                                            self.scheduled_order.index(ta[0])
                                            if ta[0] in self.scheduled_order else 0))
            started.append(candidates[0][0])
        return started

    def __repr__(self):
        return f"<Worker {self.id} cores={self.cores} free={self.free_cores}>"
