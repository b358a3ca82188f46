"""The port survey's agreement pass against the reference package on the
CPU: the T160 bucket of the mini survey's graphs at 8x4 on maxmin, with
blevel and greedy at the grid's first point (32 MiB/s, exact imode,
msd 0).

Each ``makespan_ratio`` row of ``repro_torch.survey.survey`` equals the
reference's own quotient — the JAX ``BucketedGridRunner`` makespan over
the reference event loop's deterministic twin — within rtol 1e-5, and
the port's twin equals the reference twin exactly (both are the same
host Python).  ``fastcrossv`` under blevel keeps the reference's known
0.9 % gap (equal-priority downloads admitted in another order).  Also
the agreement CSV's columns and the ``__pergraph_path__`` row, and the
port's ``DynamicGridRunner`` against the reference's on two graphs."""
import csv
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks import survey as jsurvey  # noqa: E402
from benchmarks.common import time_reference_twin as j_twin  # noqa: E402
from repro.core import parse_cluster as j_parse_cluster  # noqa: E402
from repro.core.graphs import encode_graph_batch as j_encode_batch  # noqa: E402
from repro.core.graphs import make_graph as j_make_graph  # noqa: E402
from repro.core.graphs import survey_names as j_survey_names  # noqa: E402
from repro.core.vectorized import (BucketedGridRunner as JRunner,  # noqa: E402
                                   DynamicGridRunner as JDynamic)
from repro_torch import survey  # noqa: E402
from repro_torch.core.graphs import make_graph  # noqa: E402
from repro_torch.core.vectorized import DynamicGridRunner  # noqa: E402
from repro_torch.core.vectorized.sim import _points_arrays  # noqa: E402

RTOL = 1e-5
SCHEDULERS = ("blevel", "greedy")
GRID = dict(survey.MINI_GRID, clusters=("8x4",), bandwidths_mib=(32,),
            netmodels=("maxmin",), schedulers=SCHEDULERS,
            imodes=("exact",), msds=(0.0,))
GRAPHS = tuple(j_survey_names(1))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    out = tmp_path_factory.mktemp("agreement")
    rows, agree, stats = survey.survey(GRID, out_dir=str(out), device="cpu")
    return dict(rows=rows, agree=agree, stats=stats, out=str(out))


@pytest.fixture(scope="module")
def reference():
    """JAX bucket makespans at the first point, and the reference twins."""
    points = survey.grid_points(GRID)
    encoded, groups = j_encode_batch(list(GRAPHS), seed=0, bucket=True)
    (grp,) = groups
    assert grp.shape[0] == 160
    (wb, cnames, cores2d), = jsurvey.cluster_groups(GRID["clusters"])
    cores = j_parse_cluster(cnames[0])
    out = {}
    for sched in SCHEDULERS:
        ms, _ = JRunner([encoded[n] for n in grp.names], sched, wb, cores2d,
                        netmodel="maxmin", shape=grp.shape,
                        batch=grp.batch)(points)
        for b, gname in enumerate(grp.names):
            reps, _ = j_twin(gname, sched, len(cores), cores, points[:1])
            out[(gname, sched)] = (float(ms[0, b, 0]), reps[0].makespan)
    return out


def _row(port, gname, sched):
    (row,) = [a for a in port["agree"]
              if a["graph_name"] == gname and a["scheduler_name"] == sched]
    return row


@pytest.mark.parametrize("gname", GRAPHS)
@pytest.mark.parametrize("sched", SCHEDULERS)
def test_makespan_ratio_equals_reference(port, reference, gname, sched):
    vec, twin = reference[(gname, sched)]
    row = _row(port, gname, sched)
    np.testing.assert_allclose(row["makespan_ratio"], vec / twin, rtol=RTOL,
                               atol=0)
    # the port's twin is the reference's own event loop, copied
    reps, _ = survey.time_reference_twin(
        gname, sched, 8, survey.parse_cluster("8x4"),
        survey.grid_points(GRID)[:1])
    assert reps[0].makespan == twin
    assert row["bucket"] == "T160xO160xE416" and row["group_size"] == 4


def test_fastcrossv_blevel_keeps_the_known_gap(port):
    ratio = _row(port, "fastcrossv", "blevel")["makespan_ratio"]
    np.testing.assert_allclose(ratio, 1.0089501486911263, rtol=RTOL)


def test_agreement_schema_and_pergraph_row(port):
    assert survey.AGREE_SCHEMA == jsurvey.AGREE_SCHEMA
    assert survey.SCHEMA == jsurvey.SCHEMA
    agree, stats = port["agree"], port["stats"]
    assert len(agree) == len(GRAPHS) * len(SCHEDULERS) + 1
    per = agree[-1]
    assert per["graph_name"] == "__pergraph_path__"
    assert per["scheduler_name"] == "blevel" and per["cluster_name"] == "8x4"
    assert per["compile_count"] == per["group_size"] == len(GRAPHS)
    assert per["total_compiles"] == per["bucket_groups"] == stats["groups"]
    assert per["bucket_cold_s"] > 0 and per["pergraph_cold_s"] > 0
    assert per["speedup"] == per["pergraph_cold_s"] / per["bucket_cold_s"]
    assert all(a["dataset"] == "default" for a in agree)
    assert stats["agreement_s"] > 0 and stats["all_ok"]
    with open(os.path.join(port["out"],
                           "survey_agreement_torch.csv")) as f:
        reader = csv.DictReader(f)
        assert tuple(reader.fieldnames) == jsurvey.AGREE_SCHEMA
        assert len(list(reader)) == len(agree)
    with open(os.path.join(port["out"], "survey_torch.csv")) as f:
        assert len(list(csv.DictReader(f))) == len(port["rows"])


def test_no_agreement_writes_no_agreement_rows(tmp_path):
    grid = dict(GRID, schedulers=("random",), graphs_per_family=1)
    rows, agree, stats = survey.survey(grid, out_dir=str(tmp_path),
                                       device="cpu", agreement=False)
    assert agree == [] and stats["agreement_s"] == 0.0
    assert len(rows) == len(GRAPHS)
    assert not os.path.exists(tmp_path / "survey_agreement_torch.csv")


POINTS = [dict(bandwidth=32 * 1024 * 1024, imode="exact", msd=0.0),
          dict(bandwidth=256 * 1024 * 1024, imode="user", msd=0.1,
               decision_delay=0.05, seed=3)]


@pytest.mark.parametrize("gname,sched", [("sipht", "blevel"),
                                         ("fastcrossv", "greedy")])
def test_dynamic_grid_runner_equals_reference(gname, sched):
    cores = [4] * 8
    want = JDynamic(j_make_graph(gname, seed=0), sched, 8, cores)
    got = DynamicGridRunner(make_graph(gname, seed=0), sched, 8, cores,
                            device="cpu")
    ms, xfer = got(POINTS)
    wms, wxfer = want(POINTS)
    assert ms.dtype == np.float32 and ms.shape == (len(POINTS),)
    np.testing.assert_allclose(ms, wms, rtol=RTOL, atol=0)
    np.testing.assert_allclose(xfer, wxfer, rtol=RTOL, atol=0)
    # the counts behind them, row by row
    _, M, DD, BW, SD = _points_arrays(POINTS)
    D = np.stack([got._estimates(p["imode"])[0] for p in POINTS])
    S = np.stack([got._estimates(p["imode"])[1] for p in POINTS])
    p_res = got.run(D, S, M, DD, BW, SD.astype(np.int64))
    j_res = want._fn(D, S, M, DD, BW, SD)
    for f in ("ok", "overflow", "n_events", "n_steps"):
        assert np.array_equal(getattr(p_res, f).numpy(),
                              np.asarray(getattr(j_res, f))), f

