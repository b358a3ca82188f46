"""The benchmark is driven by data: a configuration, a traffic mix, a
per-layer metric and a cell are added as new files and new entries of
``BENCHMARK.json``, and found by name; no file that is there changes.
Importing the harness, the reference and the program loads nothing of
JAX or of the JAX package."""
from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT, add_cells, copy_benchmark

from perfbench import bench, run


def _files(root):
    return {p.relative_to(root): p.read_bytes()
            for p in (root / "perfbench").rglob("*") if p.is_file()}


def test_new_config_traffic_metric_found_by_name(tmp_path):
    root = copy_benchmark(tmp_path)
    before = _files(root)
    pb = root / "perfbench"
    (pb / "traffic" / "tiny-grid.json").write_text(json.dumps({
        "kind": "grid", "scheduler": "greedy", "netmodel": "simple",
        "points": {"msds": [0.4]}}))
    (pb / "metrics" / "rows_per_call.grid.py").write_text(
        "def read(run):\n"
        "    cs = run['calls']\n"
        "    return sum(c['rows'] for c in cs) / len(cs) if cs else None\n")
    config = {"name": "new-elementary", "source": "test",
              "dataset": "elementary", "graphs": ["fork1", "fern"],
              "clusters": ["8x4", "7x8"], "bandwidths_mib": [64],
              "imodes": ["mean"], "msds": [0.0, 0.4], "decision_delay": 0.1}
    (pb / "configs" / "new-elementary.json").write_text(json.dumps(config))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "new-elementary", "source": "test",
                         "file": "perfbench/configs/new-elementary.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "new.tiny-grid", "config": "new-elementary",
                           "traffic": "tiny-grid", "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "rows_per_call.grid", "unit": "rows",
                           "better": "higher", "source": "program_counter",
                           "layer": "grid engine", "moves": "sims_per_s",
                           "workloads": ["new.tiny-grid"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    w = bench.cell("new.tiny-grid", root)
    assert w["config_data"] == config
    assert w["traffic_data"]["scheduler"] == "greedy"
    assert [m["name"] for m in w["per_layer"]] == ["rows_per_call.grid"]
    assert "setup_s" in [m["name"] for m in w["end_to_end"]]
    wl = bench.Workload(w, seed=2 ** 31 + 5)
    assert [p["msd"] for p in wl.points] == [0.4]
    assert wl.points[0]["decision_delay"] == 0.1
    assert wl.W == 8 and wl.cores.tolist()[1] == [8] * 7 + [0]
    assert wl.units == [(("fork1", "fern"), (0, 1))]
    read = run.reader("rows_per_call.grid", w["dir"])
    assert read({"calls": [{"rows": 8}, {"rows": 4}]}) == 6
    # nothing that was there changed
    after = _files(root)
    assert all(after[k] == v for k, v in before.items())


SHUFFLE = """\
import random

from perfbench.reference.generators import finish, tnormal
from perfbench.reference.taskgraph import MiB, TaskGraph


def shuffle(seed):
    rng = random.Random(seed)
    g = TaskGraph("shuffle")
    maps = [g.new_task(tnormal(rng, 20, 4), name="map",
                       outputs=[tnormal(rng, 8, 2) * MiB for _ in range(3)])
            for _ in range(4)]
    for r in range(3):
        g.new_task(tnormal(rng, 10, 2), inputs=[m.outputs[r] for m in maps],
                   cpus=2, name="reduce")
    return finish(g, seed)


GRAPHS = {"shuffle": shuffle}
"""


def test_new_dataset_file_found_by_name(tmp_path):
    """A configuration naming a dataset outside the frozen two brings it
    as one new file of ``reference/datasets/``; its graphs reach the
    program and the reference alike, which agree on every row."""
    from perfbench import check
    root = copy_benchmark(tmp_path)
    before = _files(root)
    (root / "perfbench" / "reference" / "datasets" / "shuffle-ds.py") \
        .write_text(SHUFFLE)
    add_cells(root, dict(name="shuffle-w4", source="test",
                         dataset="shuffle-ds", graphs=["shuffle"],
                         clusters=["4x4"], bandwidths_mib=[32, 1024],
                         imodes=["exact", "user"], msds=[0.0, 0.4],
                         decision_delay=0.05, precision="float32"),
              {"shuffle.blevel-grid": "elementary-w32.blevel-grid"})
    w = bench.cell("shuffle.blevel-grid", root)
    wl = bench.Workload(w, seed=2 ** 31 + 41)
    (g,) = wl.graphs
    assert (g.name, g.task_count) == ("shuffle", 7)
    assert bench.Workload(w, seed=7).graph("shuffle").task_count == 7
    client = bench.Client(wl, torch.device("cpu"))
    client.setup()
    rec = client.call(0)
    assert rec["error"] is None and rec["ok"] == rec["rows"] == 8
    rows = check.unit_rows(wl, 0)
    got = check.program_rows(rec["result"], rows)
    want = check.reference(wl, 0, rows, torch.device("cpu"))
    for key in ("makespan", "transferred", "n_events", "n_steps", "ok"):
        assert np.array_equal(got[key], want[key]), key
    after = _files(root)
    assert all(after[k] == v for k, v in before.items())
    # a dataset with neither a frozen generator nor a file, or a name
    # that is a path, is refused
    for bad, exc in (("no-such-ds", KeyError), ("../configs/x", ValueError)):
        cfg = dict(w["config_data"], dataset=bad)
        with pytest.raises(exc):
            bench.Workload(dict(w, config_data=cfg), seed=1)


def test_cells_of_the_repo_resolve():
    b = bench.benchmark()
    for w in b["workloads"]:
        c = bench.cell(w["name"])
        assert c["end_to_end"] and c["per_layer"]
        assert "setup_s" in [m["name"] for m in c["end_to_end"]]
        for m in c["end_to_end"] + c["per_layer"]:
            assert callable(run.reader(m["name"], c["dir"]))
        wl = bench.Workload(c, seed=3)
        assert len(wl.units) >= 1 and len(wl.points) >= 1


def test_the_seed_draws_sizes_not_shapes():
    c = bench.cell("elementary-w32.blevel-grid")
    a, b = bench.Workload(c, 1), bench.Workload(c, 2 ** 31 + 1)
    assert a.units == b.units
    ga, gb = a.graph("fern"), b.graph("fern")
    assert ga.task_count == gb.task_count
    assert not np.allclose([t.duration for t in ga.tasks],
                           [t.duration for t in gb.tasks])
    again = bench.Workload(c, 2 ** 31 + 1).graph("fern")
    assert [t.duration for t in again.tasks] == \
        [t.duration for t in gb.tasks]


def test_no_jax_loaded():
    code = (
        "import sys\n"
        "sys.path.insert(0, %r)\n"
        "import perfbench.run, perfbench.control, perfbench.trace\n"
        "from perfbench import bench, check\n"
        "from perfbench.reference import sim, encode, generators\n"
        "for w in bench.benchmark()['workloads']:\n"
        "    c = bench.cell(w['name'])\n"
        "    for m in c['end_to_end'] + c['per_layer']:\n"
        "        perfbench.run.reader(m['name'], c['dir'])\n"
        "bench.program()\n"
        "print(perfbench.run.forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compared_whole():
    assert run.forbidden_modules(["repro_torch", "repro_torch.core",
                                  "jaxtyping", "numpy"]) == []
    assert run.forbidden_modules(["repro.core.sim", "jaxlib.xla_client",
                                  "flax", "jax.numpy"]) == \
        ["flax", "jax", "jaxlib", "repro"]
