"""Shared fixtures of the benchmark's own tests (run on the CPU:
``python -m pytest -q perfbench/tests``; ``-m cuda`` on a card).

``tiny_root`` is a copy of the benchmark (``BENCHMARK.json`` and this
folder) with one more configuration, ``tiny-pegasus`` (two pegasus
graphs on two 4-worker clusters, 8 points), and a cell of it for each
traffic mix, held to the limits of the real cell of that mix; only new
files and new entries are added."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_CONFIG = {
    "name": "tiny-pegasus", "source": "test", "dataset": "pegasus",
    "graphs": ["montage", "sipht"], "clusters": ["4x4", "4x8"],
    "bandwidths_mib": [32, 1024], "imodes": ["exact", "user"],
    "msds": [0.0, 1.6], "decision_delay": 0.05, "precision": "float32",
}
# the real cell whose traffic and limits each tiny cell borrows
TINY_CELLS = {"tiny.blevel-grid": "elementary-w32.blevel-grid",
              "tiny.greedy-grid": "pegasus-w16.greedy-grid",
              "tiny.single-sim": "pegasus-w16.single-sim"}


def copy_benchmark(dst: Path) -> Path:
    """``BENCHMARK.json`` and the benchmark's folder copied under
    ``dst``."""
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dst


def add_cells(root: Path, config: dict, cells: dict):
    """Add ``config`` and ``cells`` (``{name: real cell}``) to the copy
    at ``root``: a new configuration file, a limits file a cell, and
    entries in ``BENCHMARK.json``."""
    (root / "perfbench" / "configs" / f"{config['name']}.json").write_text(
        json.dumps(config))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    real = {w["name"]: w for w in bench["workloads"]}
    bench["configs"].append({
        "name": config["name"], "source": "test",
        "file": f"perfbench/configs/{config['name']}.json", "reduced": [],
        "why": "test"})
    for name, like in cells.items():
        bench["workloads"].append(dict(real[like], name=name,
                                       config=config["name"]))
        shutil.copy(root / "perfbench" / "limits" / f"{like}.json",
                    root / "perfbench" / "limits" / f"{name}.json")
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    root = copy_benchmark(tmp_path_factory.mktemp("bench"))
    add_cells(root, TINY_CONFIG, TINY_CELLS)
    return root
