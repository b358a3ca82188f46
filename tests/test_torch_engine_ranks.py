"""The port's grid engine split over several ranks
(``ShardedGridRunner(devices=n | mesh=)``) on the CPU, each rank a
process of a gloo group (``torch.multiprocessing.spawn``), started from a
subprocess so that no process group outlives a test.

* Four ranks run the grid of the reference's 8-device test
  (``tests/test_engine.py``): ``fork1`` and ``merge_neighbours``, its
  three points, blevel and etf on maxmin and simple; R = 6 rows on 4
  ranks, an uneven remainder (chunk 8, the last rank runs padding
  alone).  Then ``stream_rows=2`` (the chunk rounds up to 4: two chunks
  of one row a rank) and a one-row grid through ``mesh=`` (three idle
  ranks).  Every rank's ``SimResult`` equals the port's one-rank runner
  bit for bit on every field, and the JAX package's
  ``BucketedGridRunner`` on the same inputs: bit for bit on every field
  but ``transferred``, which is held at the port's f32 bar against JAX,
  rtol 1e-5 (a float sum in another order; the one-rank port already
  differs there by a few ulp on ``merge_neighbours`` under simple).
* Under the group, a mesh without a ``"grid"`` dim raises
  ``ValueError`` and more ranks than the group ``RuntimeError``.
* ``survey()`` over a small grid (the mini grid's T160 bucket on 8x4,
  blevel and greedy on maxmin, two points) under two ranks writes the
  one-rank CSV, and the agreement CSV but for its wall-time columns.
"""
import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402,F401

from repro.core.graphs import make_graph as jmake_graph  # noqa: E402
from repro.core.vectorized import BucketedGridRunner as JBucketedGridRunner  # noqa: E402
from repro_torch.core import MiB  # noqa: E402
from repro_torch.core.graphs import make_graph  # noqa: E402
from repro_torch.core.vectorized import BucketedGridRunner  # noqa: E402

from test_torch_engine import jax_full_result  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one thread a rank: the ranks' tensors are small, and four processes
# of one thread per core each spin-wait one another out of the CPU
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
           JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")

NAMES = ("fork1", "merge_neighbours")
POINTS = [dict(imode="exact", bandwidth=100 * MiB, msd=0.0,
               decision_delay=0.0, seed=3),
          dict(imode="user", bandwidth=32 * MiB, msd=0.1,
               decision_delay=0.05, seed=3),
          dict(imode="exact", bandwidth=32 * MiB, msd=0.0,
               decision_delay=0.0, seed=7)]
GRID_CASES = ("blevel-maxmin", "blevel-simple", "etf-maxmin", "etf-simple")
# case -> (rows, (chunk, padded rows), simulator calls per rank)
CHUNKS = {**{c: (6, (8, 8), 1) for c in GRID_CASES},
          "streamed": (6, (4, 8), 2), "one_row": (1, (4, 4), 1)}

SURVEY_GRID = dict(dataset="default", graphs_per_family=1,
                   clusters=("8x4",), bandwidths_mib=(32,),
                   netmodels=("maxmin",), schedulers=("blevel", "greedy"),
                   imodes=("exact",), msds=(0.0, 0.1))
# the agreement CSV's columns read off the host's clock
WALL_COLUMNS = ("vec_us_per_sim", "ref_us_per_sim", "speedup",
                "bucket_cold_s", "pergraph_cold_s")

RANKS = f"""
import json, os, socket, sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

NAMES = {NAMES!r}
POINTS = {POINTS!r}
SURVEY_GRID = {SURVEY_GRID!r}


def engine(rank, out):
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.core.graphs import make_graph
    from repro_torch.core.vectorized import (ShardedGridRunner,
                                             capture_counter,
                                             make_grid_runner)
    from repro_torch.launch.mesh import make_grid_mesh
    entries = [(make_graph(n, seed=0), None) for n in NAMES]
    save, meta = {{}}, {{}}

    def run(case, runner, points):
        with capture_counter() as cc:
            res = runner(points)
        for f, x in zip(res._fields, res):
            save[case + "|" + f] = x
        meta[case] = dict(n_devices=runner.n_devices, rank=runner.rank,
                          chunks=runner._row_chunks(int(res.ok.size)),
                          calls=cc.calls)

    for sched in ("blevel", "etf"):
        for netmodel in ("maxmin", "simple"):
            run(sched + "-" + netmodel,
                ShardedGridRunner(entries, sched, 4, 2, netmodel=netmodel,
                                  device="cpu"), POINTS)
    run("streamed", make_grid_runner(
        entries, "blevel", 4, 2, netmodel="simple", engine="sharded",
        devices=4, stream_rows=2, device="cpu"), POINTS)
    run("one_row", ShardedGridRunner(
        entries[:1], "blevel", 4, 2, netmodel="simple",
        mesh=make_grid_mesh(4, device_type="cpu"), device="cpu"),
        POINTS[:1])
    errors = {{}}
    try:
        ShardedGridRunner(entries, "blevel", 4, 2, devices=8, device="cpu")
    except RuntimeError as e:
        errors["more_ranks_than_group"] = str(e)
    try:
        ShardedGridRunner(entries, "blevel", 4, 2, device="cpu",
                          mesh=DeviceMesh("cpu", torch.arange(4),
                                          mesh_dim_names=("data",)))
    except ValueError as e:
        errors["gridless_mesh"] = str(e)
    meta["errors"] = errors
    np.savez(os.path.join(out, f"rank{{rank}}.npz"), **save)
    return meta


def survey(rank, out):
    from repro_torch.survey import survey
    rows, agree, stats = survey(SURVEY_GRID, out_dir=out, device="cpu",
                                engine="sharded", devices=2)
    return dict(rank=stats["rank"], ranks=stats["ranks"],
                rows=len(rows), agree_rows=len(agree),
                sim_calls=stats["sim_calls"], groups=stats["groups"])


def worker(rank, world, port, out, mode):
    os.environ["MASTER_ADDR"] = "localhost"
    os.environ["MASTER_PORT"] = str(port)
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            timeout=timedelta(seconds=240))
    try:
        meta = (engine if mode == "engine" else survey)(rank, out)
        with open(os.path.join(out, f"rank{{rank}}.json"), "w") as f:
            json.dump(meta, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    world, out, mode = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    mp.spawn(worker, args=(world, port, out, mode), nprocs=world)
    print("RANKS-OK")
"""


def _start(tmp, world, mode):
    """The ranks' subprocess (``mp.spawn`` ends every rank when one
    fails); its outputs land in ``tmp``."""
    script = tmp / "ranks.py"
    script.write_text(RANKS)
    return subprocess.Popen(
        [sys.executable, str(script), str(world), str(tmp), mode], env=ENV,
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _finish(proc, timeout=240):
    try:
        log, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0 and "RANKS-OK" in log, log[-5000:]


def _references():
    """(the port's one-rank ``BucketedGridRunner``, JAX's
    ``BucketedGridRunner``) ``SimResult[K, B, N]`` by case."""
    entries = [(make_graph(n, seed=0), None) for n in NAMES]
    jentries = [(jmake_graph(n, seed=0), None) for n in NAMES]
    refs = {}
    for case in GRID_CASES:
        sched, netmodel = case.split("-")
        port = BucketedGridRunner(entries, sched, 4, 2, netmodel=netmodel,
                                  device="cpu")(POINTS)
        ref = jax_full_result(JBucketedGridRunner(
            jentries, sched, 4, 2, netmodel=netmodel), POINTS)
        refs[case] = (port, ref)
    # the streamed grid is blevel-simple's; the one-row grid its first row
    refs["streamed"] = refs["blevel-simple"]
    refs["one_row"] = tuple(type(r)(*(np.asarray(x)[:, :1, :1] for x in r))
                            for r in refs["blevel-simple"])
    return refs


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The four ranks' results and records, with the references computed
    here while the ranks run."""
    tmp = tmp_path_factory.mktemp("ranks4")
    proc = _start(tmp, 4, "engine")
    try:
        refs = _references()
    finally:
        _finish(proc)
    ranks = []
    for r in range(4):
        with open(tmp / f"rank{r}.json") as f:
            meta = json.load(f)
        ranks.append((dict(np.load(tmp / f"rank{r}.npz")), meta))
    return refs, ranks


@pytest.mark.parametrize("case", list(CHUNKS))
def test_ranks_equal_one_rank_and_jax(four_ranks, case):
    refs, ranks = four_ranks
    port, ref = refs[case]
    for r, (res, _) in enumerate(ranks):
        for f in port._fields:
            got = res[f"{case}|{f}"]
            np.testing.assert_array_equal(
                got, getattr(port, f), err_msg=f"rank {r} {case} {f} vs "
                                               f"the one-rank port")
            want = np.asarray(getattr(ref, f))
            if f == "transferred":
                np.testing.assert_allclose(got, want, rtol=1e-5,
                                           err_msg=f"rank {r} {case}")
            else:
                np.testing.assert_array_equal(
                    got, want, err_msg=f"rank {r} {case} {f} vs JAX")
        assert res[f"{case}|ok"].all(), (r, case)


@pytest.mark.parametrize("case", list(CHUNKS))
def test_each_rank_runs_its_block_of_every_chunk(four_ranks, case):
    """Every rank takes one block of each chunk, padding alone included:
    one simulator call per chunk on each rank."""
    _, ranks = four_ranks
    rows, chunks, calls = CHUNKS[case]
    for r, (res, meta) in enumerate(ranks):
        m = meta[case]
        assert (m["n_devices"], m["rank"]) == (4, r)
        assert tuple(m["chunks"]) == chunks and m["calls"] == calls, (r, m)
        assert res[f"{case}|ok"].size == rows


@pytest.mark.parametrize("case", ["gridless_mesh", "more_ranks_than_group"])
def test_bad_meshes_raise_under_a_group(four_ranks, case):
    _, ranks = four_ranks
    want = {"gridless_mesh": "lack the 'grid' dim",
            "more_ranks_than_group": "need 8 ranks"}[case]
    for _, meta in ranks:
        assert want in meta["errors"].get(case, ""), meta["errors"]


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_survey_under_two_ranks_writes_the_one_rank_csv(tmp_path):
    from repro_torch.survey import survey
    ranks_dir, one_dir = tmp_path / "ranks", tmp_path / "one"
    ranks_dir.mkdir()
    proc = _start(ranks_dir, 2, "survey")
    try:
        rows, agree, stats = survey(SURVEY_GRID, out_dir=str(one_dir),
                                    device="cpu", engine="sharded",
                                    devices=1)
    finally:
        _finish(proc)
    assert stats["ranks"] == 1 and len(rows) == 16 and len(agree) == 9
    for r in range(2):
        with open(ranks_dir / f"rank{r}.json") as f:
            meta = json.load(f)
        assert meta == dict(rank=r, ranks=2, rows=len(rows),
                            agree_rows=len(agree) if r == 0 else 0,
                            sim_calls=stats["sim_calls"],
                            groups=stats["groups"]), meta
    assert (_read_csv(ranks_dir / "survey_torch.csv")
            == _read_csv(one_dir / "survey_torch.csv"))
    got = _read_csv(ranks_dir / "survey_agreement_torch.csv")
    want = _read_csv(one_dir / "survey_agreement_torch.csv")
    assert len(got) == len(want) == len(agree)
    for g, w in zip(got, want):
        for col in WALL_COLUMNS:
            g.pop(col), w.pop(col)
        assert g == w
