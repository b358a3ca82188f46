"""Information modes (paper §2 "Information modes").

What the (global) scheduler knows about unfinished tasks / not-yet-produced
objects:

* ``exact`` — true durations and sizes of everything.
* ``user``  — user-provided estimates (``expected_duration`` /
  ``expected_size`` attributes, sampled per task *category* by the dataset
  generators); true values only for finished elements.
* ``mean``  — only the mean task duration and mean object size of the whole
  graph; true values for finished elements.

Finished tasks / produced objects always report true values (the scheduler
can observe the past in every mode).
"""
from __future__ import annotations


class ImodeBase:
    name = "base"

    def __init__(self, graph):
        self.graph = graph

    def attach_runtime(self, runtime_info):
        """runtime_info: object with is_finished(task) / is_produced(obj)."""
        self.runtime = runtime_info

    def duration(self, task) -> float:
        if self.runtime.is_finished(task):
            return task.duration
        return self._estimate_duration(task)

    def size(self, obj) -> float:
        if self.runtime.is_produced(obj):
            return obj.size
        return self._estimate_size(obj)

    def _estimate_duration(self, task):
        raise NotImplementedError

    def _estimate_size(self, obj):
        raise NotImplementedError


class ExactImode(ImodeBase):
    name = "exact"

    def _estimate_duration(self, task):
        return task.duration

    def _estimate_size(self, obj):
        return obj.size


class UserImode(ImodeBase):
    """Per-category user estimates; falls back to the true value when the
    generator did not annotate a category estimate."""

    name = "user"

    def _estimate_duration(self, task):
        if task.expected_duration is not None:
            return task.expected_duration
        return task.duration

    def _estimate_size(self, obj):
        if obj.expected_size is not None:
            return obj.expected_size
        return obj.size


class MeanImode(ImodeBase):
    name = "mean"

    def __init__(self, graph):
        super().__init__(graph)
        tasks = graph.tasks
        objs = graph.objects
        self._mean_duration = (sum(t.duration for t in tasks) / len(tasks)
                               if tasks else 0.0)
        self._mean_size = (sum(o.size for o in objs) / len(objs)
                           if objs else 0.0)

    def _estimate_duration(self, task):
        return self._mean_duration

    def _estimate_size(self, obj):
        return self._mean_size


IMODES = {"exact": ExactImode, "user": UserImode, "mean": MeanImode}


def make_imode(name: str, graph) -> ImodeBase:
    return IMODES[name](graph)


def encode_imode(graph, name: str):
    """Dense-array view of an imode for the vectorized simulator
    (DESIGN.md §3): ``(est_durations f32[T], est_sizes f32[O])`` — the
    *estimates* a scheduler sees for unfinished tasks / unproduced objects.
    The switch to true values for finished elements happens inside the
    simulator loop (``where(done, true, estimate)``), mirroring
    ``ImodeBase.duration``/``size``.
    """
    import numpy as np

    if name not in IMODES:
        raise KeyError(f"unknown imode {name!r} (have {sorted(IMODES)})")
    im = IMODES[name](graph)      # single source of truth for estimates
    dur = [im._estimate_duration(t) for t in graph.tasks]
    size = [im._estimate_size(o) for o in graph.objects]
    return (np.asarray(dur, np.float32), np.asarray(size, np.float32))
