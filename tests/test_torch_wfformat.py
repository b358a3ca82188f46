"""The port's WfFormat reader and writer (``repro_torch.workloads
.wfformat``) against the reference package's on the same inputs: the
golden fixture's import, machine normalization, the round trip, the
v1.5 split layout, the rejected broken instances and ``wf:<path>``
through ``make_graph``."""
import json
import os

import pytest

torch = pytest.importorskip("torch")

from repro.core.graphs import make_graph as j_make_graph  # noqa: E402
from repro.workloads import dump_wfformat as j_dump  # noqa: E402
from repro.workloads import load_wfformat as j_load  # noqa: E402
from repro_torch.core.graphs import make_graph  # noqa: E402
from repro_torch.workloads import (dump_wfformat, load_wfformat,  # noqa: E402
                                   save_wfformat)

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "wfformat_golden.json")


def graph_signature(g):
    """Order-independent structural fingerprint: per task (category,
    duration, cpus, sorted output sizes, sorted input keys)."""
    def tkey(t):
        return (t.name, round(t.duration, 9), t.cpus,
                tuple(sorted(round(o.size, 6) for o in t.outputs)))
    sig = []
    for t in g.tasks:
        ins = tuple(sorted((tkey(o.parent), round(o.size, 6))
                           for o in t.inputs))
        sig.append((tkey(t), ins))
    return sorted(sig)


def exact(g):
    """Every field in order, for port-vs-reference equality."""
    return (g.name, getattr(g, "wf_external_inputs", None),
            [(t.id, t.name, t.duration, t.cpus, t.expected_duration,
              [(o.id, o.size, o.expected_size) for o in t.outputs],
              [o.id for o in t.inputs]) for t in g.tasks])


def test_golden_import():
    g = load_wfformat(GOLDEN)
    g.validate()
    assert exact(g) == exact(j_load(GOLDEN))
    assert g.name == "golden-mini"
    assert g.task_count == 7
    # 7 produced files + 1 zero-size control edge (mConcat -> mBgModel)
    assert g.object_count == 8
    assert sum(1 for o in g.objects if o.size == 0.0) == 1
    # the external staged-in input is dropped, once per consumer
    assert g.wf_external_inputs == 2
    cats = {t.name for t in g.tasks}
    assert cats == {"mProject", "mDiff", "mConcat", "mBgModel", "mAdd"}
    assert max(t.cpus for t in g.tasks) == 4


def test_machine_normalization():
    g = load_wfformat(GOLDEN)
    by_cat = {}
    for t in g.tasks:
        by_cat.setdefault(t.name, []).append(t)
    # slow machine (1200 MHz) runtimes rescale onto the 2400 MHz ref
    assert sorted(t.duration for t in by_cat["mProject"]) == [6.0, 10.0]
    assert sorted(t.duration for t in by_cat["mDiff"]) == [3.0, 5.0]
    # tasks without a machine keep their measured runtime
    assert by_cat["mConcat"][0].duration == 8.0
    raw = load_wfformat(GOLDEN, normalize_machines=False)
    assert exact(raw) == exact(j_load(GOLDEN, normalize_machines=False))
    assert sorted(t.duration for t in raw.tasks)[-1] == 30.0
    assert sum(t.duration for t in raw.tasks) == 91.0


def test_roundtrip_idempotent(tmp_path):
    g1 = load_wfformat(GOLDEN)
    path = str(tmp_path / "roundtrip.json")
    save_wfformat(g1, path)
    g2 = load_wfformat(path)
    assert graph_signature(g1) == graph_signature(g2)
    # a second full cycle is byte-stable, not just structure-stable
    d2 = dump_wfformat(g2)
    g3 = load_wfformat(json.dumps(d2))
    assert dump_wfformat(g3) == d2
    # the port writes what the reference writes, and each reads the other
    assert d2 == j_dump(j_load(path))
    assert exact(j_load(json.dumps(d2))) == exact(g3)
    # user-imode annotations are regenerated deterministically
    assert ([t.expected_duration for t in g1.tasks]
            == [t.expected_duration for t in g2.tasks])


def test_v15_specification_layout():
    """The split specification/execution layout parses to the same
    graph as the flat one."""
    flat = load_wfformat(GOLDEN)
    with open(GOLDEN) as f:
        data = json.load(f)
    tasks, efiles, etasks = [], [], []
    for t in data["workflow"]["tasks"]:
        ins = [f["name"] for f in t["files"] if f["link"] == "input"]
        outs = [f["name"] for f in t["files"] if f["link"] == "output"]
        efiles += [{"id": f["name"], "sizeInBytes": f["sizeInBytes"]}
                   for f in t["files"]]
        tasks.append({"id": t["name"], "parents": t["parents"],
                      "inputFiles": ins, "outputFiles": outs})
        etasks.append({"id": t["name"],
                       "runtimeInSeconds": t["runtimeInSeconds"],
                       "coreCount": t["cores"],
                       "machines": ([t["machine"]] if "machine" in t
                                    else [])})
    v15 = {"name": "golden-mini", "schemaVersion": "1.5",
           "workflow": {
               "specification": {"tasks": tasks, "files": efiles},
               "execution": {"tasks": etasks,
                             "machines": data["workflow"]["machines"]}}}
    g = load_wfformat(v15)
    assert graph_signature(g) == graph_signature(flat)
    assert exact(g) == exact(j_load(v15))


BROKEN = {
    "no tasks": {"workflow": {"tasks": []}},
    "produced by both": {"workflow": {"tasks": [
        {"name": "a_1", "runtimeInSeconds": 1.0,
         "files": [{"name": "x.dat", "link": "output", "sizeInBytes": 1}]},
        {"name": "a_2", "runtimeInSeconds": 1.0,
         "files": [{"name": "x.dat", "link": "output", "sizeInBytes": 1}]},
    ]}},
    "cycle": {"workflow": {"tasks": [
        {"name": "a_1", "runtimeInSeconds": 1.0, "parents": ["b_2"]},
        {"name": "b_2", "runtimeInSeconds": 1.0, "parents": ["a_1"]},
    ]}},
    "its own output": {"workflow": {"tasks": [
        {"name": "a_1", "runtimeInSeconds": 1.0, "files": [
            {"name": "x.dat", "link": "output", "sizeInBytes": 1},
            {"name": "x.dat", "link": "input", "sizeInBytes": 1},
        ]},
    ]}},
}


@pytest.mark.parametrize("match", sorted(BROKEN))
def test_loader_rejects_broken_instances(match):
    for load in (load_wfformat, j_load):
        with pytest.raises(ValueError, match=match):
            load(BROKEN[match])


def test_make_graph_wf_prefix():
    g = make_graph(f"wf:{GOLDEN}")
    assert g.task_count == 7
    assert all(t.expected_duration is not None for t in g.tasks)
    assert exact(g) == exact(j_make_graph(f"wf:{GOLDEN}"))
    # seed leaves the trace data fixed and only moves the user-imode
    # estimate sampling
    g2 = make_graph(f"wf:{GOLDEN}", seed=5)
    assert exact(g2) == exact(j_make_graph(f"wf:{GOLDEN}", seed=5))
    assert [t.duration for t in g2.tasks] == [t.duration for t in g.tasks]
    assert ([t.expected_duration for t in g2.tasks]
            != [t.expected_duration for t in g.tasks])


def test_wf_graph_runs_through_the_port_simulators():
    """An imported instance runs through the port's event loop and its
    batched simulator, as in the reference."""
    import numpy as np
    from repro_torch.core import MiB, Simulator, resolve_workers
    from repro_torch.core.vectorized import simulate_dynamic_grid
    from repro_torch.core.schedulers import make_scheduler
    g = make_graph(f"wf:{GOLDEN}")
    point = dict(bandwidth=50 * MiB, imode="exact", msd=0.0)
    rep = Simulator(g, resolve_workers([4, 4, 4]),
                    make_scheduler("blevel-det"),
                    bandwidth=point["bandwidth"]).run()
    ms, _ = simulate_dynamic_grid(g, "blevel", 3, 4, [point], device="cpu")
    np.testing.assert_allclose(float(ms[0]), rep.makespan, rtol=2e-3)
