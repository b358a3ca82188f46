"""The port's reference event loop (``repro_torch.core.simulator`` with
its workers, network models and schedulers) against the reference
package's, on the CPU: ``fastcrossv`` and ``montage-77-s0`` at 8x4,
every scheduler name but ``genetic-vec`` (its own file,
``test_torch_genetic.py``: it scores on the static simulator), both
netmodels, imodes ``exact`` and ``user``, msd 0 and 0.1 (decision delay
0.05).

Both sides run the same Python, so every reported field is equal, not
close: makespan, bytes and count of transfers, scheduler invocations and
each task's worker, start and finish.  Also: the one ``parse_cluster``
of the port equals the reference's on every grid cluster name, and the
``random-det`` counter hash equals the port's in-loop ``random``
scheduler's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402
from repro.core.graphs import make_graph as j_make_graph  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.core.graphs import make_graph as p_make_graph  # noqa: E402

GRAPHS = ("fastcrossv", "montage-77-s0")
SCHEDULERS = sorted(n for n in J.SCHEDULERS if n != "genetic-vec")
CLUSTER = "8x4"


def _graph(pkg_make, name, _cache={}):
    key = (pkg_make, name)
    if key not in _cache:
        _cache[key] = pkg_make(name, seed=0)
    return _cache[key]


def _run(pkg, make_graph, gname, sched, netmodel, imode, msd):
    g = _graph(make_graph, gname)
    rep = pkg.Simulator(
        g, pkg.resolve_workers(pkg.parse_cluster(CLUSTER)),
        pkg.make_scheduler(sched, seed=0), netmodel=netmodel,
        bandwidth=64 * pkg.MiB, imode=imode, msd=msd,
        decision_delay=0.05 if msd > 0 else 0.0).run()
    records = {t.id: (r.worker, r.start, r.finish)
               for t, r in rep.task_records.items()}
    return dict(makespan=rep.makespan,
                transferred_bytes=rep.transferred_bytes,
                n_transfers=rep.n_transfers,
                scheduler_invocations=rep.scheduler_invocations,
                records=records, scheduler_name=rep.scheduler_name)


def test_scheduler_registry_names():
    assert sorted(P.SCHEDULERS) == sorted(J.SCHEDULERS)
    assert len(P.SCHEDULERS) == 19


@pytest.mark.parametrize("msd", [0.0, 0.1])
@pytest.mark.parametrize("imode", ["exact", "user"])
@pytest.mark.parametrize("netmodel", ["maxmin", "simple"])
@pytest.mark.parametrize("sched", SCHEDULERS)
@pytest.mark.parametrize("gname", GRAPHS)
def test_simulator_equals_reference(gname, sched, netmodel, imode, msd):
    want = _run(J, j_make_graph, gname, sched, netmodel, imode, msd)
    got = _run(P, p_make_graph, gname, sched, netmodel, imode, msd)
    assert got == want
    assert len(got["records"]) == _graph(p_make_graph, gname).task_count


def test_parse_cluster_is_one_function_and_equals_reference():
    from repro_torch.core import cluster, simulator
    assert simulator.parse_cluster is cluster.parse_cluster
    assert P.parse_cluster is cluster.parse_cluster
    from repro_torch.survey import FULL_GRID, MINI_GRID
    names = set(MINI_GRID["clusters"]) | set(FULL_GRID["clusters"])
    for name in sorted(names) + ["3x2", "2x1+1x16+3x3"]:
        assert P.parse_cluster(name) == J.parse_cluster(name), name
    for bad in ("", "8"):
        with pytest.raises(ValueError):
            J.parse_cluster(bad)
        with pytest.raises(ValueError):
            P.parse_cluster(bad)


def test_counter_hash_matches_in_loop_random():
    """``random-det``'s pure-Python counter hash and the port's in-loop
    ``random`` scheduler's tensor hash are bit-identical."""
    from repro_torch.core.schedulers.det import counter_choice
    from repro_torch.core.vectorized.scheduling import M32, _mix32, _mul32
    ctrs = torch.arange(50, dtype=torch.int64)
    for s in (0, 1, 7, 12345, 0xFFFFFFFF):
        h = _mix32(_mul32(torch.tensor(s, dtype=torch.int64) & M32,
                          0x9E3779B9) + ctrs + 1)
        for c, hv in zip(ctrs.tolist(), h.tolist()):
            for n in (1, 2, 3, 8):
                assert counter_choice(s, c, n) == hv % n


def test_random_det_places_like_in_loop_random():
    """The twin's placement of every task equals the in-loop scheduler's
    assignment on the same graph, cluster and seed."""
    from repro_torch.core.imodes import encode_imode
    from repro_torch.core.vectorized import build
    from repro_torch.core.vectorized.specs import encode_graph
    g = _graph(p_make_graph, "fastcrossv")
    cores = P.parse_cluster("1x8+4x2")
    d, s = encode_imode(g, "exact")
    for seed in (0, 3):
        aw, _ = build(encode_graph(g), n_workers=len(cores), cores=cores,
                      scheduler="random", device="cpu")(
            d, s, np.float32(64 * P.MiB), seed)
        twin = P.make_scheduler("random-det", seed=seed)
        rep = P.Simulator(g, P.resolve_workers(cores), twin,
                          bandwidth=64 * P.MiB).run()
        placed = {t.id: r.worker for t, r in rep.task_records.items()}
        assert [placed[i] for i in range(g.task_count)] == aw.tolist()
