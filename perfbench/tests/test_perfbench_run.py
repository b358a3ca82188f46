"""A run of a cell end to end on the CPU at a tiny size (the look for a
card skipped, the program's plain path): the last line's keys, and
``correct`` coming out false when the timed path is broken underneath —
an answer altered where it is produced, half of a call's rows left
out."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from perfbench import bench, check, run, trace

CPU = torch.device("cpu")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(root, cell, traced=False, seed=2 ** 31 + 17):
    return run.run_cell(bench.cell(cell, root), seed, 0.05, traced, CPU)


@pytest.mark.parametrize("cell", ["tiny.blevel-grid", "tiny.greedy-grid",
                                  "tiny.single-sim"])
def test_sound_run_is_correct(tiny_root, cell):
    line = _run(tiny_root, cell)
    assert list(line) == KEYS + ["checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    names = {m["name"] for m in bench.cell(cell, tiny_root)["end_to_end"]}
    assert set(line["metrics"]) == names
    assert list(line["checks"]) == list(check.NAMES)
    json.dumps(line)


def test_traced_line_has_breakdown(tiny_root, monkeypatch):
    def fake_profile(fn, host=False):
        fn()
        out = dict(wall_s=2.0, busy_s=0.5, k1_device_s=0.01,
                   device_events=10, read_s=0.0,
                   device_ops=[["waterfill_warp_kernel", 0.01]])
        if host:
            out["idle_gaps"] = [["cudaGraphLaunch", 1.0]]
        return out
    monkeypatch.setattr(trace, "profile", fake_profile)
    line = _run(tiny_root, "tiny.blevel-grid", traced=True)
    assert list(line) == KEYS + ["breakdown", "checks"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["device"]["busy_s"] == 0.5
    assert line["device"]["window_s"] == 2.0
    per_layer = {m["name"] for m in
                 bench.cell("tiny.blevel-grid", tiny_root)["per_layer"]}
    assert set(line["metrics"]) <= per_layer
    assert line["metrics"]["device_idle.grid"]["value"] == 0.75
    assert line["metrics"]["k1_device_share.grid"]["value"] == 0.02


def _vec():
    return bench.program()[1]


def test_altered_answer_is_caught(tiny_root, monkeypatch):
    sim = __import__("repro_torch.core.vectorized.sim", fromlist=["_"])
    real = sim._result

    def altered(st, *a, **k):
        res = real(st, *a, **k)
        return res._replace(makespan=res.makespan * (1 + 1e-3))
    monkeypatch.setattr(sim, "_result", altered)
    for cell in ("tiny.blevel-grid", "tiny.single-sim"):
        line = _run(tiny_root, cell)
        assert line["correct"] is False
        assert line["checks"]["makespan_rel"]["value"] > 1e-4


def test_half_the_rows_left_out_is_caught(tiny_root, monkeypatch):
    vec = _vec()
    real = vec.BucketedGridRunner._execute

    def half(self, points):
        res = real(self, points)
        n = res.makespan.shape[0] // 2
        # the second half of the rows is not simulated: the first half's
        # answers are handed back in its place
        return type(res)(*(torch.cat([x[:n], x[:res.makespan.shape[0] - n]])
                           for x in res))
    monkeypatch.setattr(vec.BucketedGridRunner, "_execute", half)
    line = _run(tiny_root, "tiny.greedy-grid")
    assert line["correct"] is False


def test_failed_call_is_counted(tiny_root, monkeypatch):
    vec = _vec()

    def boom(self, points):
        raise RuntimeError("1/32 simulation(s) exhausted their max_steps")
    monkeypatch.setattr(vec.BucketedGridRunner, "__call__", boom)
    line = _run(tiny_root, "tiny.blevel-grid")
    assert line["correct"] is False
    assert line["failed"] == line["attempted"] > 0
    assert line["checks"]["not_ok"]["value"] == line["attempted"]


@pytest.mark.cuda
def test_proto_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    line = run.run_cell(bench.cell("pegasus-w16.single-sim"), 11, 2.0,
                        False, torch.device("cuda", 0))
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert np.isfinite(line["metrics"]["request_ms_p90"]["value"])
