"""The engine options a traffic file may name, the launcher that runs a
cell over several ranks (on the CPU: gloo ranks on the program's plain
path), and the readers that count a rank's share of a call."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import ROOT, TINY_CONFIG, add_cells, copy_benchmark

from perfbench import bench, check, readers
from perfbench.roofline import DOWNLOAD_SLOTS, HBM_BYTES_S, k1_bytes

CPU = torch.device("cpu")
FOUR = "elementary-w32.blevel-grid-4card"


def _results(w, seed):
    wl = bench.Workload(w, seed)
    client = bench.Client(wl, CPU)
    client.setup()
    return wl, [client.call(i) for i in range(len(wl.units))]


def test_engine_options_reach_the_runner(tiny_root):
    """The sharded engine streaming 5 rows a chunk gives the default
    runner's answers, bit for bit; a traffic file without the keys
    builds the runner exactly as before."""
    w = bench.cell("tiny.blevel-grid", tiny_root)
    assert bench.Workload(w, 1).engine_opts == {}
    streamed = dict(w, traffic_data=dict(w["traffic_data"], engine="sharded",
                                         stream_rows=5))
    wl, plain = _results(w, 2 ** 31 + 3)
    wl_s, chunked = _results(streamed, 2 ** 31 + 3)
    assert wl_s.engine_opts == {"engine": "sharded", "stream_rows": 5}
    assert (wl_s.ranks, wl_s.stream_rows) == (1, 5)
    for a, b in zip(plain, chunked):
        assert a["error"] is None and b["error"] is None
        for x, y in zip(a["result"], b["result"]):
            assert np.array_equal(x, y)
        # one simulator call a chunk of 5 rows
        assert b["sim_calls"] == -(-a["rows"] // 5)
    for bad in (dict(engine="pmap"), dict(ranks=2), dict(ranks=0,
                                                         engine="sharded")):
        with pytest.raises(ValueError):
            bench.engine_opts(dict(w["traffic_data"], **bad))


@pytest.mark.parametrize("rows", [1, 30, 120, 449, 1800])
@pytest.mark.parametrize("ranks", [1, 2, 4])
@pytest.mark.parametrize("stream_rows", [None, 1, 7, 256])
def test_launch_rows_cut_as_the_engine(rows, ranks, stream_rows):
    vec = bench.program()[1]
    me = SimpleNamespace(n_devices=ranks, stream_rows=stream_rows)
    chunk, _ = vec.ShardedGridRunner._row_chunks(me, rows)
    assert readers.launch_rows(rows, ranks, stream_rows) == chunk // ranks


def _recorded(ranks, stream_rows=None):
    """A traced blevel run as the harness records it (launches and
    device time of one profiled cycle, as a card reads them)."""
    calls = [dict(rows=120, k1_launches=240, gp_launches=0, place_iters=0,
                  T=160),
             dict(rows=1800, k1_launches=640, gp_launches=0, place_iters=0,
                  T=512)]
    return dict(kind="grid", W=32, ranks=ranks, stream_rows=stream_rows,
                trace=dict(calls=calls, k1_device_s=0.0032, busy_s=5.4,
                           gp_device_s=0.0, wall_s=6.5))


def test_k1_roofline_counts_a_launchs_own_rows():
    run = _recorded(1)
    before = 100.0 * sum(c["k1_launches"] * k1_bytes(c["rows"],
                                                     DOWNLOAD_SLOTS * 32, 32)
                         for c in run["trace"]["calls"]) \
        / HBM_BYTES_S / 0.0032
    assert readers.k1_roofline(run) == before
    # four ranks: each launch holds a quarter of the rows
    assert readers.k1_roofline(_recorded(4)) == pytest.approx(before / 4)
    assert readers.place_roofline(run) is None


def test_place_roofline_and_share():
    run = _recorded(1)
    run["trace"]["calls"] = [dict(rows=360, k1_launches=432, gp_launches=432,
                                  place_iters=2500, T=160)]
    run["trace"].update(gp_device_s=432 * 20e-6, busy_s=1.7)
    share = readers.place_roofline(run)
    assert 0 < share < 100
    assert readers.device_share(run, "gp_device_s") == 432 * 20e-6 / 1.7


def test_rank_imbalance():
    assert readers.rank_imbalance(dict(rank_drive_s=[[1.0, 2.0]])) is None
    assert readers.rank_imbalance(
        dict(rank_drive_s=[[1.0, 2.0], [3.0, 2.0]])) == 5.0 / 4.0
    assert readers.rank_imbalance(
        dict(rank_drive_s=[[1.0, 2.0], None])) is None


BOOM = """\
import os

from perfbench.reference.generators import PEGASUS


def _on_rank_0_only(fn):
    def make(seed):
        if os.environ.get("RANK") == "1":
            raise RuntimeError("rank 1 fails its set-up")
        return fn(seed=seed)
    return make


GRAPHS = {name: _on_rank_0_only(fn) for name, fn in PEGASUS.items()}
"""


@pytest.fixture(scope="module")
def two_rank_root(tmp_path_factory):
    """A copy with two two-rank cells of the four-card cell's traffic
    (``ranks`` 2, one card): one sound, one whose rank 1 raises in
    set-up (its dataset file)."""
    root = copy_benchmark(tmp_path_factory.mktemp("ranks"))
    pb = root / "perfbench"
    traffic = json.loads((pb / "traffic" / "blevel-grid-4card.json")
                         .read_text())
    (pb / "traffic" / "tiny-2rank.json").write_text(
        json.dumps(dict(traffic, ranks=2)))
    (pb / "reference" / "datasets" / "boom.py").write_text(BOOM)
    add_cells(root, TINY_CONFIG, {"tiny.2rank": FOUR})
    add_cells(root, dict(TINY_CONFIG, name="tiny-boom", dataset="boom"),
              {"boom.2rank": FOUR})
    b = json.loads((root / "BENCHMARK.json").read_text())
    for w in b["workloads"]:
        if w["name"] in ("tiny.2rank", "boom.2rank"):
            w.update(traffic="tiny-2rank", chips=1)
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return root


def _launch(root, cell, seed, path=()):
    """``run.launch`` of ``cell`` from ``root`` on the CPU, in a process
    of its own (``path`` put first on its ``PYTHONPATH``): ``(exit code,
    standard output, standard error)``."""
    code = ("import argparse, sys\n"
            "from perfbench import bench, run\n"
            "args = argparse.Namespace(seed=%d, seconds=0.05, trace=0)\n"
            "sys.exit(run.launch(bench.cell(%r), args, device='cpu'))\n"
            % (seed, cell))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([*map(str, path),
                                           str(ROOT / "src")]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=root, env=env)
    return out.returncode, out.stdout, out.stderr


def test_launcher_two_ranks_print_one_line(two_rank_root):
    rc, out, err = _launch(two_rank_root, "tiny.2rank", 2 ** 31 + 71)
    assert rc == 0, err[-3000:]
    lines = out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["correct"] is True and line["failed"] == 0, err[-3000:]
    assert line["attempted"] > 0
    assert list(line["checks"]) == list(check.NAMES)
    assert set(line["metrics"]) == {"sims_per_s.4card", "setup_s"}
    assert line["device"]["platform"] == "cpu"
    # the compared numbers are the last lines of standard error
    tail = err.splitlines()[-len(check.NAMES):]
    assert [t.split()[:2] for t in tail] == [["check", k]
                                             for k in check.NAMES]


def test_launcher_rank_that_fails_prints_nothing(two_rank_root):
    rc, out, err = _launch(two_rank_root, "boom.2rank", 5)
    assert rc == 1
    assert out == ""
    assert "rank 1 fails its set-up" in err


# planted in every rank as it starts (``sitecustomize``), under the
# launcher: the timed path broken underneath the harness
FAULTS = {
    "no_exchange": """\
    def gather(self, local, blocks):
        # each rank's own block stands in every rank's place
        return sim.SimResult(*(torch.stack(
            [x.cpu().reshape(blocks, -1)] * self.n_devices, 1).reshape(-1)
            for x in local))
    engine.ShardedGridRunner._gather = gather
""",
    "altered": """\
    real = sim._result

    def altered(st, *a, **k):
        res = real(st, *a, **k)
        return res._replace(makespan=res.makespan * (1 + 1e-3))
    sim._result = altered
""",
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_launcher_catches_a_broken_timed_path(two_rank_root, tmp_path,
                                              fault):
    (tmp_path / "sitecustomize.py").write_text(
        "import os\n"
        "if 'LOCAL_RANK' in os.environ:\n"
        "    import torch\n"
        "    from repro_torch.core.vectorized import engine, sim\n"
        + FAULTS[fault])
    rc, out, err = _launch(two_rank_root, "tiny.2rank", 2 ** 31 + 73,
                           path=[tmp_path])
    assert rc == 0, err[-3000:]
    line = json.loads(out)
    assert line["correct"] is False
    assert line["checks"]["makespan_rel"]["value"] > 1e-4
