"""The port's dynamic simulator and grid runner against the reference
package on the CPU: the T160 survey bucket x clusters {8x4, 1x8+4x2} x
the mini survey's schedulers x both netmodels, at grid points that
include msd 0.1 / decision_delay 0.05 / imode user.

Contract (the reference's frontier+slots agreement): ``ok``,
``overflow``, ``n_events`` and ``n_steps`` exact; ``makespan`` and
``transferred`` within rtol 1e-5 (``transferred`` is a float sum whose
order may differ).  Both sides run the identical row inputs: the port
runner's flattened rows, handed to the reference's simulator under
``jax.vmap``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.vectorized import api as japi  # noqa: E402
from repro.core.vectorized.specs import BucketedGraphSpec as JSpec  # noqa: E402
from repro_torch.core import MiB  # noqa: E402
from repro_torch.core.graphs import (encode_graph_batch, make_graph,  # noqa: E402
                                     survey_names)
from repro_torch.core.imodes import encode_imode  # noqa: E402
from repro_torch.core.vectorized import (build, make_grid_runner,  # noqa: E402
                                         make_bucket_dynamic_simulator)
from repro_torch.core.vectorized.specs import encode_graph  # noqa: E402
from repro_torch.survey import cluster_groups  # noqa: E402

RTOL = 1e-5
SCHEDULERS = ("blevel", "random", "etf", "greedy")
NETMODELS = ("maxmin", "simple")
POINTS = [dict(bandwidth=32 * MiB, imode="exact", msd=0.0),
          dict(bandwidth=256 * MiB, imode="user", msd=0.1,
               decision_delay=0.05, seed=3)]


@pytest.fixture(scope="module")
def bucket():
    encoded, groups = encode_graph_batch(survey_names(1), bucket=True)
    grp = groups[0]
    assert grp.shape[0] == 160
    (wb, cnames, cores2d), = cluster_groups(("8x4", "1x8+4x2"))
    return dict(encoded=encoded, grp=grp, W=wb, cores2d=cores2d,
                est_cache={})


def port_runner(bucket, sched, netmodel, **kw):
    grp = bucket["grp"]
    return make_grid_runner([bucket["encoded"][n] for n in grp.names], sched,
                            bucket["W"], bucket["cores2d"], netmodel=netmodel,
                            shape=grp.shape, batch=grp.batch,
                            est_cache=bucket["est_cache"], device="cpu", **kw)


def reference_rows(rows, sched, netmodel, W, max_cores):
    """The reference simulator over the same flattened rows."""
    spec, D, S, M, DD, BW, SD, C = rows
    jspec = JSpec(**spec.numpy())
    brun = japi.build(None, n_workers=W, cores=None, scheduler=sched,
                      netmodel=netmodel, dynamic=True, max_cores=max_cores)
    res = jax.jit(jax.vmap(brun))(
        jspec, D.numpy(), S.numpy(), M.numpy(), DD.numpy(), BW.numpy(),
        SD.numpy().astype(np.int32), C.numpy().astype(np.int32))
    return {f: np.asarray(getattr(res, f)) for f in res._fields}


def assert_agree(got, want, ctx):
    for f in ("ok", "overflow", "n_events", "n_steps"):
        assert np.array_equal(got[f], want[f]), (ctx, f)
    assert got["ok"].all(), ctx
    for f in ("makespan", "transferred"):
        np.testing.assert_allclose(got[f], want[f], rtol=RTOL, atol=0,
                                   err_msg=f"{ctx} {f}")


@pytest.mark.parametrize("netmodel", NETMODELS)
@pytest.mark.parametrize("sched", SCHEDULERS)
def test_grid_runner_matches_reference(bucket, sched, netmodel):
    runner = port_runner(bucket, sched, netmodel)
    res = runner(POINTS)
    K, B, N = runner.K, runner.B, len(POINTS)
    assert res.makespan.shape == (K, B, N)
    rows = runner.row_inputs(POINTS)
    want = reference_rows(rows, sched, netmodel, bucket["W"],
                          int(bucket["cores2d"].max()))
    # rows are flattened graph-major, then point, then cluster
    want = {f: v.reshape(B, N, K).transpose(2, 0, 1)
            for f, v in want.items()}
    assert_agree(res._asdict(), want, (sched, netmodel))


def test_bench_pr7_merge_triplets_row_is_reproduced():
    """``BENCH_PR7.json`` dynamic T160 row (blevel, maxmin, frontier on,
    100 MiB/s, exact imode, msd 0) through ``build(..., dynamic=True)``."""
    g = make_graph("merge_triplets", seed=0)
    spec = encode_graph(g)
    d, s = encode_imode(g, "exact")
    run = build(spec, n_workers=8, cores=4, scheduler="blevel",
                dynamic=True, device="cpu")
    res = run(d, s, bandwidth=np.float32(100 * MiB))
    assert bool(res.ok) and not bool(res.overflow)
    assert int(res.n_events) == 232 and int(res.n_steps) == 232
    assert float(res.makespan) == 249.30433654785156
    np.testing.assert_allclose(float(res.transferred), 8741974016.0,
                               rtol=RTOL)


def test_frozen_rows_stay_frozen(bucket):
    """Rows that finish at different steps: each row's result in the
    batch equals that row run alone (and the live check's cadence does
    not matter)."""
    runner = port_runner(bucket, "greedy", "maxmin", check_every=3)
    rows = runner.row_inputs(POINTS)
    batch = runner.run(*rows)
    steps = batch.n_steps.numpy()
    assert len(set(steps.tolist())) > 1
    for r in (int(steps.argmin()), int(steps.argmax())):
        one = runner.run(rows[0].map(lambda x: x[r:r + 1]),
                         *(x[r:r + 1] for x in rows[1:]))
        for f in batch._fields:
            a, b = getattr(one, f)[0], getattr(batch, f)[r]
            assert torch.equal(a, b) or (f == "makespan" and
                                         bool(a.isnan() & b.isnan())), f


def test_unbatched_call_equals_its_row(bucket):
    """A bound spec called without a row axis gives the grid row's
    result for that graph and point."""
    runner = port_runner(bucket, "blevel", "maxmin")
    row = runner(POINTS[:1])                 # row (k, b, n) = (0, 0, 0)
    d, s = runner._estimates("exact")
    run = make_bucket_dynamic_simulator(8, bucket["cores2d"][0], "blevel",
                                        "maxmin", device="cpu")
    one = run(runner.bspec.map(lambda v: np.asarray(v)[0]), d[0], s[0],
              0.0, 0.0, np.float32(32 * MiB), 0)
    assert one.makespan.dim() == 0
    assert float(one.makespan) == float(row.makespan[0, 0, 0])
    assert int(one.n_steps) == int(row.n_steps[0, 0, 0])
