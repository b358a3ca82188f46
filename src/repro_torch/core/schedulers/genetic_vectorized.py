"""Genetic scheduler with exact batched fitness — the port's
``genetic-vec`` (counterpart of
``repro.core.schedulers.genetic_vectorized``).

The paper's genetic scheduler scores chromosomes with a cheap makespan
estimate (uncontended transfers).  Here the whole population is scored
by the static simulator (``vectorized.api.build`` with no scheduler) in
one batched call per generation, one row per chromosome: exact fitness
under network contention, through the waterfill kernel on the card.
The genetic algorithm itself (its RNG, selection, crossover and
mutation) is the reference's, unchanged, so with bitwise equal fitness
the two packages pick the same schedule.  A chromosome whose
simulation fails (``ok`` False) scores NaN and sorts last.
"""
from __future__ import annotations

import numpy as np

from ..worker import Assignment
from .base import SchedulerBase, compute_blevel


class GeneticVectorizedScheduler(SchedulerBase):
    name = "genetic-vec"

    def __init__(self, seed: int = 0, population: int = 32,
                 generations: int = 16, mutation_rate: float = 0.05,
                 crossover_rate: float = 0.8, elite: int = 2,
                 netmodel: str = "maxmin",
                 bandwidth: float = 100 * 1024 * 1024,
                 device="cuda", waterfill_impl: str = "auto"):
        super().__init__(seed)
        self.population = population
        self.generations = generations
        self.mutation_rate = mutation_rate
        self.crossover_rate = crossover_rate
        self.elite = elite
        self.netmodel = netmodel
        self.bandwidth = bandwidth
        self.device = device
        self.waterfill_impl = waterfill_impl

    def init(self, view):
        super().init(view)
        self._assigned = False

    def schedule(self, new_ready, new_finished):
        if self._assigned:
            return []
        self._assigned = True
        from ..vectorized import build, encode_graph

        view = self.view
        graph = view.graph
        workers = list(view.workers)
        W = len(workers)
        T = len(graph.tasks)
        rng = np.random.default_rng(self.rng.randrange(2 ** 31))

        # valid workers per task (enough cores)
        cores = np.array([w.cores for w in workers], np.int32)
        valid = np.stack([cores >= t.cpus for t in graph.tasks])   # [T,W]
        bl = compute_blevel(view)
        prio = np.array([bl[t] for t in graph.tasks], np.float32)

        spec = encode_graph(graph)
        run = build(spec, n_workers=W, cores=cores, netmodel=self.netmodel,
                    device=self.device, waterfill_impl=self.waterfill_impl)
        bw = np.float32(self.bandwidth)

        def batch_ms(pop):
            # one simulator call, one row per chromosome
            return run(pop, prio, bandwidth=bw).makespan.cpu().numpy()

        def sample(n):
            probs = valid / valid.sum(1, keepdims=True)
            return np.stack([
                np.array([rng.choice(W, p=probs[t]) for t in range(T)],
                         np.int32) for _ in range(n)])

        pop = sample(self.population)
        fitness = batch_ms(pop)
        for _ in range(self.generations):
            order = np.argsort(fitness)
            pop, fitness = pop[order], fitness[order]
            nxt = [pop[i] for i in range(self.elite)]
            while len(nxt) < self.population:
                # tournament selection
                i = min(rng.integers(0, self.population, 2))
                j = min(rng.integers(0, self.population, 2))
                a, b = pop[i].copy(), pop[j].copy()
                if T > 1 and rng.random() < self.crossover_rate:
                    pt = rng.integers(1, T)
                    a[:pt], b[:pt] = b[:pt].copy(), a[:pt].copy()
                for c in (a, b):
                    if len(nxt) >= self.population:
                        break
                    mut = rng.random(T) < self.mutation_rate
                    for t in np.nonzero(mut)[0]:
                        cand = np.nonzero(valid[t])[0]
                        c[t] = rng.choice(cand)
                    nxt.append(c)
            pop = np.stack(nxt)
            fitness = batch_ms(pop)
        best = pop[int(np.argmin(fitness))]
        return [Assignment(t, workers[int(best[i])], priority=float(prio[i]))
                for i, t in enumerate(graph.tasks)]
