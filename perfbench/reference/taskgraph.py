"""Task graph model (paper §2), frozen for the benchmark's inputs.

TG = (T, O, A): tasks T, data objects O, arcs A subset of (T x O) union (O x T).
Each object is produced by exactly one task; tasks may have multiple
outputs (first-class, no dummy tasks). Tasks carry a duration (seconds),
a CPU-core requirement, and optional user-provided estimates (for the
`user` imode). Objects carry a size (bytes) and optional estimates.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

MiB = 1024.0 * 1024.0


@dataclasses.dataclass
class DataObject:
    id: int
    size: float                      # bytes
    parent: "Task" = None            # producing task (exactly one)
    consumers: list = dataclasses.field(default_factory=list)
    expected_size: float | None = None      # user-imode estimate (bytes)

    def __hash__(self):
        return self.id

    def __eq__(self, other):
        return self is other

    def __repr__(self):
        return f"<O{self.id} {self.size / MiB:.1f}MiB>"


@dataclasses.dataclass
class Task:
    id: int
    duration: float                  # seconds (ground truth)
    cpus: int = 1                    # core requirement
    outputs: list = dataclasses.field(default_factory=list)
    inputs: list = dataclasses.field(default_factory=list)   # DataObjects
    expected_duration: float | None = None  # user-imode estimate (seconds)
    name: str = ""

    def __hash__(self):
        return self.id

    def __eq__(self, other):
        return self is other

    @property
    def parents(self) -> set:
        return {o.parent for o in self.inputs}

    @property
    def children(self) -> set:
        out = set()
        for o in self.outputs:
            out.update(o.consumers)
        return out

    def __repr__(self):
        return f"<T{self.id} '{self.name}' d={self.duration:.1f}s c={self.cpus}>"


class TaskGraph:
    """A finite DAG of tasks and data objects."""

    def __init__(self, name: str = ""):
        self.name = name
        self.tasks: list[Task] = []
        self.objects: list[DataObject] = []

    # ---------------------------------------------------------------- build
    def new_task(self, duration: float, *, outputs: Sequence[float] = (),
                 inputs: Iterable[DataObject] = (), cpus: int = 1,
                 expected_duration: float | None = None,
                 expected_sizes: Sequence[float] = None,
                 name: str = "") -> Task:
        """Create a task producing len(outputs) objects of the given sizes."""
        t = Task(id=len(self.tasks), duration=float(duration), cpus=int(cpus),
                 expected_duration=expected_duration, name=name)
        self.tasks.append(t)
        for i, size in enumerate(outputs):
            o = DataObject(id=len(self.objects), size=float(size), parent=t)
            if expected_sizes is not None:
                o.expected_size = float(expected_sizes[i])
            self.objects.append(o)
            t.outputs.append(o)
        for o in inputs:
            self._add_input(t, o)
        return t

    def _add_input(self, t: Task, o: DataObject):
        assert o.parent is not t, "task cannot consume its own output"
        t.inputs.append(o)
        o.consumers.append(t)

    # ------------------------------------------------------------ analysis
    @property
    def task_count(self) -> int:
        return len(self.tasks)

    @property
    def object_count(self) -> int:
        return len(self.objects)

    def topo_order(self) -> list[Task]:
        """Kahn topological order; raises on cycles."""
        indeg = {t: len(t.parents) for t in self.tasks}
        stack = [t for t in self.tasks if indeg[t] == 0]
        order = []
        while stack:
            t = stack.pop()
            order.append(t)
            for c in sorted(t.children, key=lambda x: x.id):
                indeg[c] -= 1
                if indeg[c] == 0:
                    stack.append(c)
        if len(order) != len(self.tasks):
            raise ValueError("task graph contains a cycle")
        return order

    def validate(self):
        for o in self.objects:
            assert o.parent is not None, f"{o} has no producer"
            assert o in o.parent.outputs
            for c in o.consumers:
                assert o in c.inputs
        for t in self.tasks:
            assert t.duration >= 0
            assert t.cpus >= 1
            for o in t.inputs:
                assert t in o.consumers
        self.topo_order()  # acyclic
        return True

    def __repr__(self):
        return (f"<TaskGraph '{self.name}' #T={self.task_count} "
                f"#O={self.object_count}>")
