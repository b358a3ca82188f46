"""Deterministic reference twins of the vectorized in-loop schedulers.

The stochastic schedulers (paper: "a random choice when an
indistinguishable decision occurs") cannot be replicated bit-for-bit
inside ``jax.lax`` loops, so the vectorized simulator ships a
deterministic twin for every ``VEC_SCHEDULERS`` entry, with every tie
broken by the smallest index instead.  These classes are the
event-driven (reference-simulator) implementations of exactly the same
decision rules; the parity suite in ``tests/test_vectorized_dynamic.py``
holds the two sides together (DESIGN.md §3).

* ``blevel-det`` — blevel/HLFET list scheduling with earliest-start
  worker selection, deterministic ties: task order by (-blevel, id),
  worker by (est. start, id).  Mirrors
  ``vectorized.scheduling.make_static_blevel_scheduler``.
* ``tlevel-det`` — SCFET: ascending t-level task order, same worker
  rule.  Mirrors ``make_static_tlevel_scheduler``.
* ``mcp-det`` — simplified MCP: ascending ALAP task order (== the
  blevel-det order, since ALAP = CP - blevel), same worker rule.
  Mirrors ``make_static_mcp_scheduler``.
* ``etf-det`` — ETF/DLS-style placer: at every step commit the
  (frontier task, worker) pair minimising (est. start, -blevel,
  task id, worker id).  Mirrors ``make_etf_scheduler``.
* ``random-det`` — counter-based random placement: task t goes to the
  ``_mix32(seed, t) mod n_eligible``-th eligible worker; the hash
  constants are shared with ``vectorized.scheduling._mix32``.  Mirrors
  ``make_random_scheduler``.
* ``greedy`` — ws-style greedy worker selection for ready tasks at every
  invocation, no work stealing: worker by (estimated transfer cost,
  queued load, id), tasks processed in id order, priority = rank in
  decreasing estimated b-level.  Mirrors
  ``vectorized.scheduling.make_greedy_placer``.

A copy of ``repro.core.schedulers.det`` for the PyTorch port, which
imports nothing of the reference package: the logic is the reference's,
only the imports differ."""
from __future__ import annotations

import random

from ..worker import Assignment
from .base import (SchedulerBase, EarliestStartPlacer, compute_blevel,
                   compute_tlevel, compute_alap, topological_repair)


def _rank_priorities(view):
    """priority = T - rank in decreasing-estimated-b-level order (ties by
    id): globally distinct, like ``vectorized.scheduling
    .rank_priorities``."""
    bl = compute_blevel(view)
    tasks = sorted(view.graph.tasks, key=lambda t: (-bl[t], t.id))
    return {t: float(len(tasks) - r) for r, t in enumerate(tasks)}


def _mix32(x: int) -> int:
    """32-bit splitmix-style finalizer — bit-identical to the JAX
    ``vectorized.scheduling._mix32`` (same constants, wrapping u32
    arithmetic)."""
    M = 0xFFFFFFFF
    x &= M
    x ^= x >> 16
    x = (x * 0x7FEB352D) & M
    x ^= x >> 15
    x = (x * 0x846CA68B) & M
    x ^= x >> 16
    return x


def counter_choice(seed: int, counter: int, n: int) -> int:
    """Counter-based uniform index in [0, n): the deterministic,
    seed-parameterized replacement for ``rng.choice`` shared (constant
    for constant) with the vectorized ``random`` scheduler."""
    return _mix32((seed * 0x9E3779B9 + counter + 1) & 0xFFFFFFFF) % n


class _DetStaticListScheduler(SchedulerBase):
    """Static list scheduling with deterministic tie-breaks: tasks in
    ``det_order`` (ties by id), each to the worker with the earliest
    estimated start (ties by worker id)."""

    def det_order(self, view):
        raise NotImplementedError

    def init(self, view):
        super().init(view)
        self._assigned = False

    def schedule(self, new_ready, new_finished):
        if self._assigned:
            return []
        self._assigned = True
        view = self.view
        order = topological_repair(view.graph, self.det_order(view))
        placer = EarliestStartPlacer(view, random.Random(0))
        n = len(order)
        out = []
        for rank, t in enumerate(order):
            best_w, best_s = None, None
            for w in placer.candidates(t):      # worker id order
                s = placer.est_start(t, w)
                if best_s is None or s < best_s - 1e-9:
                    best_w, best_s = w, s
            placer.commit(t, best_w, best_s)
            out.append(Assignment(t, best_w, priority=float(n - rank)))
        return out


class DetBlevelScheduler(_DetStaticListScheduler):
    """Static blevel list scheduler with deterministic tie-breaks."""

    name = "blevel-det"

    def det_order(self, view):
        bl = compute_blevel(view)
        return sorted(view.graph.tasks, key=lambda t: (-bl[t], t.id))


class DetTlevelScheduler(_DetStaticListScheduler):
    """SCFET with deterministic tie-breaks: ascending t-level."""

    name = "tlevel-det"

    def det_order(self, view):
        tl = compute_tlevel(view)
        return sorted(view.graph.tasks, key=lambda t: (tl[t], t.id))


class DetMCPScheduler(_DetStaticListScheduler):
    """Simplified MCP with deterministic tie-breaks: ascending ALAP."""

    name = "mcp-det"

    def det_order(self, view):
        alap = compute_alap(view)
        return sorted(view.graph.tasks, key=lambda t: (alap[t], t.id))


class DetETFScheduler(SchedulerBase):
    """ETF/DLS-style earliest-start placer, deterministic: at every step
    commit the (frontier task, worker) pair with the lexicographically
    smallest (est. start, -blevel, task id, worker id)."""

    name = "etf-det"

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
        placer = EarliestStartPlacer(view, random.Random(0))
        unscheduled = set(graph.tasks)
        n = len(graph.tasks)
        out = []
        rank = 0
        while unscheduled:
            frontier = sorted(
                (t for t in unscheduled
                 if all(p not in unscheduled for p in t.parents)),
                key=lambda t: t.id)
            best, best_key = None, None
            for t in frontier:
                for w in placer.candidates(t):      # worker id order
                    key = (placer.est_start(t, w), -bl[t], t.id, w.id)
                    if best_key is None or key < best_key:
                        best, best_key = (t, w), key
            t, w = best
            placer.commit(t, w, best_key[0])
            unscheduled.remove(t)
            out.append(Assignment(t, w, priority=float(n - rank)))
            rank += 1
        return out


class DetRandomScheduler(SchedulerBase):
    """Counter-based random static placement: stateless per-task hash of
    (seed, task id) over the eligible workers in id order, so decisions
    are reproducible across processes and match the vectorized
    ``random`` scheduler exactly."""

    name = "random-det"

    def __init__(self, seed: int = 0):
        super().__init__(seed)
        self.seed = seed

    def init(self, view):
        super().init(view)
        self._assigned = False

    def schedule(self, new_ready, new_finished):
        if self._assigned:
            return []
        self._assigned = True
        view = self.view
        prio = _rank_priorities(view)
        out = []
        for t in view.graph.tasks:
            cand = [w for w in view.workers if w.cores >= t.cpus]
            w = cand[counter_choice(self.seed, t.id, len(cand))]
            out.append(Assignment(t, w, priority=prio[t]))
        return out


class GreedyWorkerScheduler(SchedulerBase):
    """ws-style greedy worker selection, deterministic, no stealing."""

    name = "greedy"

    def init(self, view):
        super().init(view)
        self._prio = _rank_priorities(view)
        self._queued = {w: set() for w in view.workers}

    def schedule(self, new_ready, new_finished):
        view = self.view
        for q in self._queued.values():         # drop started/finished
            for t in list(q):
                if view.is_finished(t) or view.is_running(t):
                    q.discard(t)
        out = []
        for t in sorted(new_ready, key=lambda t: t.id):
            if view.assigned_worker(t) is not None:
                continue
            best_w, best_key = None, None
            for w in view.workers:              # worker id order
                if w.cores < t.cpus:
                    continue
                key = (view.transfer_cost(t, w), len(self._queued[w]))
                if best_key is None or key < best_key:
                    best_w, best_key = w, key
            out.append(Assignment(t, best_w, priority=self._prio[t]))
            self._queued[best_w].add(t)
        return out
