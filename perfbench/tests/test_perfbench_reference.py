"""The plain reference against the program's plain path on the CPU at a
small size (every row, every output, bitwise), and the control: the
reference in bfloat16 in the program's place is refused by every
cell's limits.  The reference imports nothing of the program; these
tests hold the two side by side."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import bench, check, control

CPU = torch.device("cpu")


def _program_rows(wl, i):
    graphs_mod, vec, _ = bench.program()
    names, ks = wl.units[i]
    encoded, groups = graphs_mod.encode_graph_batch(
        [(n, wl.graph(n)) for n in names], bucket=True)
    (grp,) = groups
    T, _O, E = grp.shape
    runner = vec.make_grid_runner(
        [encoded[n] for n in grp.names], wl.scheduler, wl.W,
        wl.cores[list(ks)], netmodel=wl.netmodel, shape=grp.shape,
        batch=grp.batch, device="cpu", frontier_caps=(E, T))
    return runner(wl.points)


@pytest.mark.parametrize("cell", ["tiny.blevel-grid", "tiny.greedy-grid",
                                  "tiny.single-sim"])
@pytest.mark.parametrize("netmodel", ["maxmin", "simple"])
def test_reference_equals_program(tiny_root, cell, netmodel):
    w = bench.cell(cell, tiny_root)
    w["traffic_data"] = dict(w["traffic_data"], netmodel=netmodel)
    wl = bench.Workload(w, seed=2 ** 31 + 23)
    for i in range(len(wl.units)):
        rows = check.unit_rows(wl, i)
        res = _program_rows(wl, i)
        got = check.program_rows(res, rows)
        want = check.reference(wl, i, rows, CPU)
        for key in ("makespan", "transferred", "n_events", "n_steps", "ok"):
            assert np.array_equal(got[key], want[key]), key
        if wl.kind == "proto":
            break                      # one request shows it


@pytest.mark.parametrize("cell", ["tiny.blevel-grid", "tiny.greedy-grid",
                                  "tiny.single-sim"])
def test_control_fails_the_limits(tiny_root, cell):
    w = bench.cell(cell, tiny_root)
    lim = check.limits(w)
    for seed in (2 ** 31 + 29, 31):
        numbers = control.control(w, seed, CPU)
        assert not all(numbers[k] <= lim[k] for k in check.NAMES), numbers
