"""WfCommons WfFormat ingestion and export (DESIGN.md §6).

``load_wfformat`` parses a WfFormat JSON workflow instance
(https://github.com/wfcommons/wfformat) into the repo's ``TaskGraph``
model; ``dump_wfformat``/``save_wfformat`` write a graph back out, and
the two round-trip: ``load(dump(load(J)))`` is identical to
``load(J)`` (asserted by ``tests/test_wfformat.py``).

Supported shapes — the pragmatic subset real instances use:

* flat v1.x: ``workflow.tasks[]`` with per-task ``files[]``
  (``link`` = ``input``/``output``, ``sizeInBytes`` or ``size``),
  ``runtimeInSeconds``/``runtime``, ``cores``, ``machine`` and
  ``parents``; machine catalog in ``workflow.machines[]``;
* split v1.5: ``workflow.specification.tasks[]`` (``inputFiles``/
  ``outputFiles`` ids into ``specification.files[]``) with runtimes,
  core counts and machine assignments in ``workflow.execution.tasks[]``
  and machines in ``workflow.execution.machines[]``.

Mapping rules:

* every file produced by some task becomes a ``DataObject`` of that
  task; files consumed but produced by no task are *external inputs*
  (staged in, not transferred between workers) and are dropped — the
  count is recorded in ``graph.wf_external_inputs``;
* a ``parents`` edge with no shared file becomes a zero-size control
  object, preserving the precedence constraint without adding transfer
  volume (exported like any other file, so round-trips are stable);
* **machine normalization**: when the instance carries machine CPU
  speeds, each task's measured runtime is rescaled onto the fastest
  machine (``duration = runtime * speed / max_speed``) so durations
  from heterogeneous traces are comparable; disable with
  ``normalize_machines=False``;
* task *categories* (the ``name`` used by the ``user`` imode's
  per-category estimate sampling) strip the WfFormat ``_00000001``
  instance suffix; imported graphs get ``annotate_user_estimates`` so
  they run under every information mode.

A copy of ``repro.workloads.wfformat`` for the PyTorch port, which
imports nothing of the reference package: the logic is the reference's,
only the imports differ."""
from __future__ import annotations

import json
import os
import re
import zlib

from ..core.taskgraph import TaskGraph
from ..core.graphs.util import finish

_ID_SUFFIX = re.compile(r"_(?:ID)?\d+$")


def _category(task_name: str) -> str:
    """WfFormat task id -> category name (``mProject_00000002`` ->
    ``mProject``)."""
    return _ID_SUFFIX.sub("", task_name) or "task"


def _file_size(f: dict) -> float:
    for key in ("sizeInBytes", "size"):
        if key in f:
            return float(f[key])
    return 0.0


def _task_records(wf: dict):
    """Normalize both WfFormat layouts into
    ``[(name, runtime, cores, machine, inputs, outputs, out_sizes)]``
    where inputs/outputs are file-name lists and out_sizes maps
    produced file name -> bytes."""
    spec = wf.get("specification")
    if spec is not None and "tasks" in spec:
        sizes = {f.get("id", f.get("name")): _file_size(f)
                 for f in spec.get("files", ())}
        ex = {t.get("id", t.get("name")): t
              for t in wf.get("execution", {}).get("tasks", ())}
        records = []
        for t in spec["tasks"]:
            name = t.get("id", t.get("name"))
            e = ex.get(name, {})
            machines = e.get("machines") or ()
            records.append((
                name,
                float(e.get("runtimeInSeconds", t.get("runtimeInSeconds",
                                                      0.0))),
                int(e.get("coreCount", t.get("cores", 1)) or 1),
                machines[0] if machines else None,
                list(t.get("inputFiles", ())),
                list(t.get("outputFiles", ())),
                {f: sizes.get(f, 0.0) for f in t.get("outputFiles", ())},
                list(t.get("parents", ())),
            ))
        return records
    records = []
    for t in wf.get("tasks", ()):
        name = t.get("id") or t.get("name")
        ins = [f.get("id", f.get("name")) for f in t.get("files", ())
               if f.get("link") == "input"]
        outs = [(f.get("id", f.get("name")), _file_size(f))
                for f in t.get("files", ()) if f.get("link") == "output"]
        records.append((
            name,
            float(t.get("runtimeInSeconds", t.get("runtime", 0.0))),
            int(t.get("cores", t.get("coreCount", 1)) or 1),
            t.get("machine"),
            ins,
            [f for f, _ in outs],
            dict(outs),
            list(t.get("parents", ())),
        ))
    return records


def _machine_speeds(wf: dict) -> dict:
    machines = wf.get("machines") or wf.get("execution", {}).get(
        "machines") or ()
    speeds = {}
    for m in machines:
        speed = (m.get("cpu") or {}).get("speed")
        if speed:
            speeds[m.get("nodeName", m.get("name"))] = float(speed)
    return speeds


def load_wfformat(src, normalize_machines: bool = True,
                  seed: int = 0) -> TaskGraph:
    """Parse a WfFormat instance (path, JSON string or parsed dict)
    into a validated, estimate-annotated ``TaskGraph``.

    The trace data (structure, durations, sizes) is fixed by the file;
    ``seed`` only offsets the user-imode estimate sampling — the one
    stochastic part of an import (``make_graph("wf:...", seed=k)``
    plumbs through here)."""
    if isinstance(src, dict):
        data = src
    elif isinstance(src, (str, os.PathLike)) and not str(src).lstrip(
            ).startswith("{"):
        with open(src) as f:
            data = json.load(f)
    else:
        data = json.loads(src)
    wf = data.get("workflow", data)
    records = _task_records(wf)
    if not records:
        raise ValueError("WfFormat instance has no tasks")
    speeds = _machine_speeds(wf) if normalize_machines else {}
    ref_speed = max(speeds.values()) if speeds else None

    produced = {}                          # file name -> producer task name
    for name, *_rest in records:
        for fname in _rest[4]:             # outputs
            if fname in produced:
                raise ValueError(f"file {fname!r} produced by both "
                                 f"{produced[fname]!r} and {name!r}")
            produced[fname] = name
    by_name = {r[0]: r for r in records}
    if len(by_name) != len(records):
        raise ValueError("duplicate task names in WfFormat instance")

    # dependency map (file edges + explicit parents), then topo order
    deps = {}
    for name, _rt, _c, _m, ins, outs, _sz, parents in records:
        selfloop = set(ins) & set(outs)
        if selfloop:
            raise ValueError(f"task {name!r} consumes its own output "
                             f"file(s) {sorted(selfloop)} — the task-"
                             f"graph model forbids self-dependencies")
        d = {produced[f] for f in ins if f in produced}
        d.update(p for p in parents if p in by_name)
        d.discard(name)
        deps[name] = d
    order = []
    ready = sorted((n for n in deps if not deps[n]), reverse=True)
    pending = {n: set(d) for n, d in deps.items()}
    children = {}
    for n, d in deps.items():
        for p in d:
            children.setdefault(p, set()).add(n)
    while ready:
        n = ready.pop()                    # smallest name first
        order.append(n)
        for c in children.get(n, ()):
            pending[c].discard(n)
            if not pending[c]:
                ready.append(c)
        ready.sort(reverse=True)
    if len(order) != len(records):
        stuck = sorted(set(deps) - set(order))[:5]
        raise ValueError(f"WfFormat instance has a dependency cycle "
                         f"(unresolvable tasks: {stuck})")

    g = TaskGraph(data.get("name", wf.get("name", "wfformat")))
    objects = {}                           # file name -> DataObject
    tasks = {}
    external = 0
    for name in order:
        _n, runtime, cores, machine, ins, outs, out_sizes, parents = \
            by_name[name]
        duration = runtime
        if ref_speed and machine in speeds:
            duration = runtime * speeds[machine] / ref_speed
        inputs = []
        for f in ins:
            if f in objects:
                inputs.append(objects[f])
            elif f not in produced:
                external += 1              # staged-in input, dropped
        t = g.new_task(duration, inputs=inputs, cpus=max(1, cores),
                       outputs=[out_sizes[f] for f in outs],
                       name=_category(name))
        for f, o in zip(outs, t.outputs, strict=True):
            objects[f] = o
        # parents declared without a shared file: zero-size control edge
        covered = {o.parent for o in inputs}
        for p in parents:
            pt = tasks.get(p)
            if pt is not None and pt not in covered:
                g.add_dependencies(t, [g.new_object(pt, 0.0)])
        tasks[name] = t
    g.wf_external_inputs = external
    # estimate-annotation seed from the instance name: deterministic,
    # and stable across export/import round trips (the name survives)
    return finish(g, zlib.crc32(g.name.encode()) + seed)


def dump_wfformat(graph: TaskGraph, name: str | None = None,
                  schema_version: str = "1.4") -> dict:
    """``TaskGraph`` -> WfFormat dict (flat v1.x layout).  Inverse of
    ``load_wfformat`` up to the import-time mapping rules (external
    inputs are gone; control edges are zero-size files)."""
    tnames = {t: f"{t.name or 'task'}_{t.id + 1:08d}" for t in graph.tasks}
    fnames = {o: f"{tnames[o.parent]}_out{o.parent.outputs.index(o)}.dat"
              for o in graph.objects}
    tasks = []
    for t in graph.tasks:
        files = [{"name": fnames[o], "link": "output",
                  "sizeInBytes": round(o.size, 6)} for o in t.outputs]
        files += [{"name": fnames[o], "link": "input",
                   "sizeInBytes": round(o.size, 6)} for o in t.inputs]
        tasks.append({
            "name": tnames[t],
            "id": tnames[t],
            "type": "compute",
            "runtimeInSeconds": round(t.duration, 9),
            "cores": int(t.cpus),
            "parents": sorted(tnames[p] for p in t.parents),
            "children": sorted(tnames[c] for c in t.children),
            "files": files,
        })
    return {
        "name": name or graph.name or "taskgraph",
        "schemaVersion": schema_version,
        "workflow": {"tasks": tasks, "machines": []},
    }


def save_wfformat(graph: TaskGraph, path, name: str | None = None) -> str:
    """Write ``dump_wfformat(graph)`` as JSON; returns the path."""
    with open(path, "w") as f:
        json.dump(dump_wfformat(graph, name=name), f, indent=2,
                  sort_keys=True)
        f.write("\n")
    return os.fspath(path)
