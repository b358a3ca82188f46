"""Work-stealing, genetic and naive schedulers (paper §4.3).

A copy of ``repro.core.schedulers.others`` for the PyTorch port, which
imports nothing of the reference package: the logic is the reference's,
only the imports differ."""
from __future__ import annotations

from ..worker import Assignment
from .base import (SchedulerBase, compute_blevel, estimate_makespan,
                   topological_repair)


class SingleScheduler(SchedulerBase):
    """All tasks to the worker with the most cores — never transfers."""

    name = "single"

    def init(self, view):
        super().init(view)
        self._assigned = False

    def schedule(self, new_ready, new_finished):
        if self._assigned:
            return []
        self._assigned = True
        w = max(self.view.workers, key=lambda w: w.cores)
        bl = compute_blevel(self.view)
        return [Assignment(t, w, priority=bl[t])
                for t in self.view.graph.tasks]


class RandomScheduler(SchedulerBase):
    """Static: every task to a uniformly random (valid) worker."""

    name = "random"

    def init(self, view):
        super().init(view)
        self._assigned = False

    def schedule(self, new_ready, new_finished):
        if self._assigned:
            return []
        self._assigned = True
        bl = compute_blevel(self.view)
        out = []
        for t in self.view.graph.tasks:
            cand = [w for w in self.view.workers if w.cores >= t.cpus]
            out.append(Assignment(t, self.rng.choice(cand), priority=bl[t]))
        return out


class WorkStealingScheduler(SchedulerBase):
    """Dynamic work-stealing: each ready task goes to the worker where it
    can start with minimal transfer cost; when a worker starves, a portion
    of the queued tasks of the most-loaded worker is rescheduled to it."""

    name = "ws"

    def init(self, view):
        super().init(view)
        self._bl = compute_blevel(view)
        self._queued = {w: set() for w in view.workers}   # assigned, not running

    def _sync_queues(self):
        """Drop tasks that started/finished since the last invocation."""
        view = self.view
        for w, q in self._queued.items():
            for t in list(q):
                if view.is_finished(t) or view.is_running(t):
                    q.discard(t)

    def schedule(self, new_ready, new_finished):
        view = self.view
        self._sync_queues()
        out = []

        # 1. place new ready tasks at min transfer cost
        for t in new_ready:
            if view.assigned_worker(t) is not None:
                continue
            best, best_key = [], None
            for w in view.workers:
                if w.cores < t.cpus:
                    continue
                load = len(self._queued[w])
                key = (view.transfer_cost(t, w), load)
                if best_key is None or key < best_key:
                    best, best_key = [w], key
                elif key == best_key:
                    best.append(w)
            w = self.rng.choice(best)
            out.append(Assignment(t, w, priority=self._bl[t]))
            self._queued[w].add(t)

        # 2. steal for starving workers
        loads = {w: sum(view.duration(t) for t in q) / w.cores
                 for w, q in self._queued.items()}
        for w in self._shuffled(view.workers):
            if self._queued[w]:
                continue                       # not starving
            donor = max(view.workers, key=lambda d: loads[d])
            donor_q = [t for t in self._queued[donor]
                       if not view.is_running(t) and w.cores >= t.cpus]
            if len(donor_q) < 2:
                continue
            donor_q.sort(key=lambda t: self._bl[t])       # steal low priority
            for t in donor_q[:len(donor_q) // 2]:
                out.append(Assignment(t, w, priority=self._bl[t]))
                self._queued[donor].discard(t)
                self._queued[w].add(t)
            loads[donor] = sum(view.duration(t)
                               for t in self._queued[donor]) / donor.cores
            loads[w] = sum(view.duration(t)
                           for t in self._queued[w]) / w.cores
        return out


class GeneticScheduler(SchedulerBase):
    """GA over complete task->worker maps; mutation/crossover operators per
    Omara & Arafa (2010); fitness = estimated makespan of the assignment
    (list-simulated with core slots + uncontended transfer costs).  Only
    valid schedules (worker.cores >= task.cpus) are generated."""

    name = "genetic"

    def __init__(self, seed: int = 0, population: int = 24,
                 generations: int = 32, mutation_rate: float = 0.05,
                 crossover_rate: float = 0.8, elite: int = 2):
        super().__init__(seed)
        self.population = population
        self.generations = generations
        self.mutation_rate = mutation_rate
        self.crossover_rate = crossover_rate
        self.elite = elite

    def init(self, view):
        super().init(view)
        self._assigned = False

    def _random_chromosome(self, tasks, cand):
        return [self.rng.choice(cand[t]) for t in tasks]

    def _mutate(self, chrom, tasks, cand):
        chrom = list(chrom)
        for i, t in enumerate(tasks):
            if self.rng.random() < self.mutation_rate:
                chrom[i] = self.rng.choice(cand[t])
        return chrom

    def _crossover(self, a, b):
        if len(a) < 2 or self.rng.random() > self.crossover_rate:
            return list(a), list(b)
        p = self.rng.randrange(1, len(a))
        return a[:p] + b[p:], b[:p] + a[p:]

    def schedule(self, new_ready, new_finished):
        if self._assigned:
            return []
        self._assigned = True
        view = self.view
        tasks = list(view.graph.tasks)
        bl = compute_blevel(view)
        order = topological_repair(view.graph,
                                   sorted(tasks, key=lambda t: -bl[t]))
        cand = {t: [w for w in view.workers if w.cores >= t.cpus]
                for t in tasks}

        def fitness(chrom):
            assignment = {t: w for t, w in zip(tasks, chrom, strict=True)}
            return estimate_makespan(view, assignment, order)

        pop = [self._random_chromosome(tasks, cand)
               for _ in range(self.population)]
        scored = sorted((fitness(c), i, c) for i, c in enumerate(pop))
        for _ in range(self.generations):
            nxt = [c for _, _, c in scored[:self.elite]]
            while len(nxt) < self.population:
                # tournament selection
                a = min(self.rng.sample(scored, 2))[2]
                b = min(self.rng.sample(scored, 2))[2]
                c1, c2 = self._crossover(a, b)
                nxt.append(self._mutate(c1, tasks, cand))
                if len(nxt) < self.population:
                    nxt.append(self._mutate(c2, tasks, cand))
            scored = sorted((fitness(c), i, c) for i, c in enumerate(nxt))
        best = scored[0][2]
        n = len(tasks)
        ranked = sorted(range(n), key=lambda i: -bl[tasks[i]])
        prio = {}
        for r, i in enumerate(ranked):
            prio[tasks[i]] = float(n - r)
        return [Assignment(t, w, priority=prio[t])
                for t, w in zip(tasks, best, strict=True)]
