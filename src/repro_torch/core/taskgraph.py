"""Task graph model (paper §2).

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
GiB = 1024.0 * MiB


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

    @property
    def output_size(self) -> float:
        return sum(o.size for o in self.outputs)

    @property
    def input_size(self) -> float:
        return sum(o.size for o in self.inputs)

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

    def new_object(self, task: Task, size: float) -> DataObject:
        """Append one output object to an existing task (loaders use
        this for e.g. zero-size control-dependency objects)."""
        o = DataObject(id=len(self.objects), size=float(size), parent=task)
        self.objects.append(o)
        task.outputs.append(o)
        return o

    def _add_input(self, t: Task, o: DataObject):
        assert o.parent is not t, "task cannot consume its own output"
        t.inputs.append(o)
        o.consumers.append(t)

    def add_dependencies(self, t: Task, objects: Iterable[DataObject]):
        for o in objects:
            self._add_input(t, o)

    # ------------------------------------------------------------ analysis
    @property
    def task_count(self) -> int:
        return len(self.tasks)

    @property
    def object_count(self) -> int:
        return len(self.objects)

    @property
    def total_size(self) -> float:
        """TS column of Table 1 (bytes)."""
        return sum(o.size for o in self.objects)

    @property
    def total_duration(self) -> float:
        return sum(t.duration for t in self.tasks)

    def source_tasks(self) -> list[Task]:
        return [t for t in self.tasks if not t.inputs]

    def leaf_tasks(self) -> list[Task]:
        return [t for t in self.tasks if not t.children]

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

    def longest_path(self) -> int:
        """LP column of Table 1: #tasks on the longest oriented path."""
        depth = {}
        for t in self.topo_order():
            depth[t] = 1 + max((depth[p] for p in t.parents), default=0)
        return max(depth.values(), default=0)

    def critical_path_time(self, durations=None) -> float:
        """Longest path measured in task durations (no transfer costs)."""
        durations = durations or {t: t.duration for t in self.tasks}
        ft = {}
        for t in self.topo_order():
            ft[t] = durations[t] + max((ft[p] for p in t.parents), default=0.0)
        return max(ft.values(), default=0.0)

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

    def normalize(self):
        """Re-number ids to be dense (after graph surgery)."""
        for i, t in enumerate(self.tasks):
            t.id = i
        for i, o in enumerate(self.objects):
            o.id = i

    def stats(self) -> dict:
        return {
            "name": self.name,
            "tasks": self.task_count,
            "objects": self.object_count,
            "total_size_gib": self.total_size / GiB,
            "longest_path": self.longest_path(),
            "total_duration": self.total_duration,
        }

    def __repr__(self):
        return (f"<TaskGraph '{self.name}' #T={self.task_count} "
                f"#O={self.object_count}>")


def merge_graphs(graphs: Sequence[TaskGraph], name: str = "") -> TaskGraph:
    """Disjoint union of several task graphs (used by e.g. crossvx)."""
    out = TaskGraph(name=name)
    for g in graphs:
        tmap = {}
        for t in g.tasks:
            nt = out.new_task(t.duration, outputs=[o.size for o in t.outputs],
                              cpus=t.cpus, expected_duration=t.expected_duration,
                              name=t.name)
            for o, no in zip(t.outputs, nt.outputs, strict=True):
                no.expected_size = o.expected_size
            tmap[t] = nt
        for t in g.tasks:
            nt = tmap[t]
            for o in t.inputs:
                parent_new = tmap[o.parent]
                idx = o.parent.outputs.index(o)
                out._add_input(nt, parent_new.outputs[idx])
    return out
