"""Event-driven reference simulator (paper §4, Fig. 1).

The Simulator owns global time and coordinates the Scheduler, Workers and
the network model.  Between two events all transfer rates are constant, so
the loop jumps to the earliest of:

* a running task finishing,
* an active download finishing (at current max-min / simple rates),
* a scheduler invocation becoming allowed (MSD) while events are pending,
* a batch of scheduler assignments being applied (50 ms decision delay).

Semantics follow the paper:

* scheduler invocations are rate-limited by the *minimal scheduling delay*
  (MSD); events arriving in between are batched into the next invocation;
* the scheduler's decision reaches the workers ``decision_delay`` seconds
  after the invocation;
* the scheduler sees durations/sizes through an *imode* filter and may
  reschedule non-running tasks;
* workers act autonomously per Appendix A (see ``worker.py``).

A copy of ``repro.core.simulator`` for the PyTorch port, which imports
nothing of the reference package: the logic is the reference's, only the
imports differ.  The reference defines ``parse_cluster`` here and again
for its survey; the port keeps one, in ``core/cluster.py``, and this
module re-exports it."""
from __future__ import annotations

import dataclasses

import numpy as np

from .cluster import parse_cluster  # noqa: F401 — one grammar, re-exported
from .netmodels import Flow, make_netmodel, NetModelBase
from .imodes import make_imode, ImodeBase
from .worker import Worker, Assignment

EPS = 1e-9


def resolve_workers(workers):
    """Shared cluster encoding: accept ``[Worker, ...]`` or a sequence of
    per-worker core counts and return Worker objects.  Used by the
    reference simulator, the benchmark harness and the vectorized parity
    tests so every path names a cluster the same way."""
    workers = list(workers)
    if workers and isinstance(workers[0], (int, np.integer)):
        return [Worker(i, int(c)) for i, c in enumerate(workers)]
    return workers


@dataclasses.dataclass
class TaskRecord:
    worker: int
    start: float
    finish: float


@dataclasses.dataclass
class Report:
    makespan: float
    transferred_bytes: float
    n_transfers: int
    scheduler_invocations: int
    task_records: dict
    graph_name: str = ""
    scheduler_name: str = ""

    def __repr__(self):
        return (f"<Report {self.graph_name}/{self.scheduler_name} "
                f"makespan={self.makespan:.2f}s "
                f"transfers={self.transferred_bytes / (1024**2):.0f}MiB>")


class SimView:
    """What the scheduler is allowed to see (imode-filtered)."""

    def __init__(self, sim: "Simulator"):
        self._sim = sim

    @property
    def graph(self):
        return self._sim.graph

    @property
    def workers(self):
        return self._sim.workers

    @property
    def bandwidth(self):
        return self._sim.netmodel.bandwidth

    @property
    def now(self):
        return self._sim.time

    def duration(self, task) -> float:
        return self._sim.imode.duration(task)

    def size(self, obj) -> float:
        return self._sim.imode.size(obj)

    def is_finished(self, task) -> bool:
        return task in self._sim.finished

    def is_running(self, task) -> bool:
        return self._sim.task_worker_running.get(task) is not None

    def assigned_worker(self, task):
        return self._sim.task_assignment.get(task)

    def object_placement(self, obj) -> set:
        return {w.id for w in self._sim.workers if obj in w.store}

    def transfer_cost(self, task, worker) -> float:
        """Bytes that would have to be moved to run ``task`` on ``worker``
        (estimated sizes for unproduced objects)."""
        total = 0.0
        for o in task.inputs:
            if o not in worker.store and o not in worker.downloading:
                total += self.size(o)
        return total


class RuntimeInfo:
    """Ground-truth runtime predicates (for imodes and w-schedulers)."""

    def __init__(self, sim):
        self._sim = sim

    def is_finished(self, task) -> bool:
        return task in self._sim.finished

    def is_produced(self, obj) -> bool:
        return obj.parent in self._sim.finished

    def is_task_ready(self, task) -> bool:
        return all(o.parent in self._sim.finished for o in task.inputs)


class Simulator:
    def __init__(self, graph, workers, scheduler, netmodel="maxmin",
                 bandwidth=100.0 * 1024 * 1024, imode="exact",
                 msd: float = 0.0, decision_delay: float = 0.0,
                 max_events: int | None = None, trace: bool = False):
        self.graph = graph
        self.workers = resolve_workers(workers)
        self.scheduler = scheduler
        if isinstance(netmodel, str):
            netmodel = make_netmodel(netmodel, bandwidth)
        self.netmodel: NetModelBase = netmodel
        if isinstance(imode, str):
            imode = make_imode(imode, graph)
        self.imode: ImodeBase = imode
        self.msd = msd
        self.decision_delay = decision_delay
        self.max_events = max_events or (40 * (len(graph.tasks) + len(graph.objects) + 16) + 10_000)
        self.trace = trace

        # runtime state
        self.time = 0.0
        self.finished: set = set()
        self.task_assignment: dict = {}          # task -> Worker
        self.task_worker_running: dict = {}      # task -> Worker
        self.task_records: dict = {}             # task -> TaskRecord
        self.transferred_bytes = 0.0
        self.n_transfers = 0
        self.scheduler_invocations = 0

        self.runtime = RuntimeInfo(self)
        self.imode.attach_runtime(self.runtime)
        self.view = SimView(self)

        self._pending_new_ready: list = []
        self._pending_new_finished: list = []
        self._last_invocation = -float("inf")
        self._pending_assignments: list = []     # (apply_time, [Assignment])
        self._events_pending = True              # initial invocation at t=0
        self._notified_ready: set = set()

    # --------------------------------------------------------------- run
    def run(self) -> Report:
        self.graph.validate()
        self.scheduler.init(self.view)
        self._collect_ready()
        steps = 0
        total = len(self.graph.tasks)
        while len(self.finished) < total:
            steps += 1
            if steps > self.max_events:
                raise RuntimeError(
                    f"simulation exceeded {self.max_events} events "
                    f"({len(self.finished)}/{total} tasks finished) — "
                    f"scheduler {getattr(self.scheduler, 'name', '?')} likely "
                    f"left tasks unassigned")
            self._step()
        return Report(
            makespan=self.time,
            transferred_bytes=self.transferred_bytes,
            n_transfers=self.n_transfers,
            scheduler_invocations=self.scheduler_invocations,
            task_records=self.task_records,
            graph_name=self.graph.name,
            scheduler_name=getattr(self.scheduler, "name", "?"),
        )

    # -------------------------------------------------------------- step
    def _step(self):
        # 1. everything that can happen *now*
        self._apply_due_assignments()
        sched_time = self._next_scheduler_time()
        if sched_time is not None and sched_time <= self.time + EPS:
            self._invoke_scheduler()
            self._apply_due_assignments()
        self._workers_act()

        # 2. find the next event time
        self.netmodel.recompute([w.id for w in self.workers])
        nxt = float("inf")
        for w in self.workers:
            for rt in w.running.values():
                nxt = min(nxt, rt.finish_time)
        ec = self.netmodel.earliest_completion()
        if ec < float("inf"):
            nxt = min(nxt, self.time + ec)
        for t_apply, _ in self._pending_assignments:
            nxt = min(nxt, t_apply)
        sched_time = self._next_scheduler_time()
        if sched_time is not None:
            nxt = min(nxt, sched_time)
        if nxt == float("inf"):
            raise RuntimeError(
                f"deadlock at t={self.time:.3f}: no runnable event; "
                f"{len(self.finished)}/{len(self.graph.tasks)} finished; "
                f"unassigned={sum(1 for t in self.graph.tasks if t not in self.task_assignment and t not in self.finished)}")

        # 3. advance and process completions
        dt = max(0.0, nxt - self.time)
        self.netmodel.advance(dt)
        self.time = nxt
        self._process_download_completions()
        self._process_task_completions()

    # ---------------------------------------------------------- scheduler
    def _next_scheduler_time(self):
        if not self._events_pending:
            return None
        return max(self.time, self._last_invocation + self.msd)

    def _collect_ready(self):
        for t in self.graph.tasks:
            if t in self.finished or t in self._notified_ready:
                continue
            if all(o.parent in self.finished for o in t.inputs):
                self._notified_ready.add(t)
                self._pending_new_ready.append(t)
                self._events_pending = True

    def _invoke_scheduler(self):
        new_ready = self._pending_new_ready
        new_finished = self._pending_new_finished
        self._pending_new_ready = []
        self._pending_new_finished = []
        self._events_pending = False
        self._last_invocation = self.time
        self.scheduler_invocations += 1
        assignments = self.scheduler.schedule(new_ready, new_finished) or []
        if assignments:
            self._pending_assignments.append(
                (self.time + self.decision_delay, assignments))

    def _apply_due_assignments(self):
        due = [a for a in self._pending_assignments if a[0] <= self.time + EPS]
        self._pending_assignments = [a for a in self._pending_assignments
                                     if a[0] > self.time + EPS]
        for _, assignments in due:
            for a in assignments:
                self._apply_assignment(a)

    def _apply_assignment(self, a: Assignment):
        task = a.task
        if task in self.finished or task in self.task_worker_running:
            return  # reschedule failed: already running or finished
        old = self.task_assignment.get(task)
        if old is a.worker:
            old.assignments[task].priority = a.priority
            old.assignments[task].blocking = a.blocking
            return
        if old is not None and not old.unassign(task):
            return
        self.task_assignment[task] = a.worker
        a.worker.assign(a)

    # ------------------------------------------------------------ workers
    def _workers_act(self):
        for w in self.workers:
            self._start_downloads(w)
        for w in self.workers:
            for task in w.pick_startable_tasks():
                self._start_task(w, task)

    def _start_downloads(self, w: Worker):
        needed = w.missing_inputs()
        candidates = []
        for obj, needing in needed.items():
            if obj.parent not in self.finished:
                continue  # not produced yet
            # the producing worker always holds the object
            producer_w = self.workers[self.task_records[obj.parent].worker]
            if producer_w is w:
                continue  # already local (store updated on finish)
            holders = [producer_w]
            prio = w.download_priority(obj, needing, self.runtime)
            candidates.append((prio, obj, holders))
        candidates.sort(key=lambda c: -c[0])

        per_worker = self.netmodel.max_downloads_per_worker
        per_source = self.netmodel.max_downloads_per_source
        active = len(w.downloading)
        per_src_count = {}
        for f in w.downloading.values():
            per_src_count[f.src] = per_src_count.get(f.src, 0) + 1

        for prio, obj, holders in candidates:
            if per_worker is not None and active >= per_worker:
                break
            if per_source is not None:
                holders = [h for h in holders
                           if per_src_count.get(h.id, 0) < per_source]
                if not holders:
                    continue
            # spread load: pick the holder with the fewest active uploads
            uploads = {h.id: 0 for h in holders}
            for f in self.netmodel.flows:
                if f.src in uploads:
                    uploads[f.src] += 1
            src = min(holders, key=lambda h: (uploads[h.id], h.id))
            flow = Flow(src=src.id, dst=w.id, obj=obj,
                        remaining=obj.size, start_time=self.time)
            w.downloading[obj] = flow
            self.netmodel.add_flow(flow)
            active += 1
            per_src_count[src.id] = per_src_count.get(src.id, 0) + 1

    def _start_task(self, w: Worker, task):
        assert task not in self.task_worker_running
        assert w.free_cores >= task.cpus
        from .worker import RunningTask
        w.running[task] = RunningTask(task, self.time + task.duration)
        self.task_worker_running[task] = w
        self.task_records[task] = TaskRecord(w.id, self.time, None)

    # ------------------------------------------------------- completions
    def _process_download_completions(self):
        for f in list(self.netmodel.completed_flows()):
            self.netmodel.remove_flow(f)
            dst = self.workers[f.dst]
            dst.store.add(f.obj)
            del dst.downloading[f.obj]
            self.transferred_bytes += f.obj.size
            self.n_transfers += 1

    def _process_task_completions(self):
        for w in self.workers:
            done = [t for t, rt in w.running.items()
                    if rt.finish_time <= self.time + EPS]
            for t in done:
                del w.running[t]
                del self.task_worker_running[t]
                w.assignments.pop(t, None)
                self.finished.add(t)
                for o in t.outputs:
                    w.store.add(o)
                self.task_records[t].finish = self.time
                self._pending_new_finished.append(t)
                self._events_pending = True
        self._collect_ready()


def run_single_simulation(graph, n_workers, cores, scheduler, **kw) -> Report:
    """Convenience wrapper: homogeneous cluster ``n_workers x cores``."""
    return Simulator(graph, resolve_workers([cores] * n_workers),
                     scheduler, **kw).run()
