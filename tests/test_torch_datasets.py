"""The port's dataset manifests and adaptive bucket edges
(``repro_torch.workloads.datasets``) and the survey's ``--dataset``
axis, held against the reference package's functions on the same
inputs: the manifest contract, ``get_manifest``, the derived edges
``(128, 288)`` of ``wfcommons-mini``, ``compute_w_buckets`` and
``dataset_axis`` for the default dataset and a manifest."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import repro.workloads as JW  # noqa: E402
from benchmarks import survey as jsurvey  # noqa: E402
import repro_torch.workloads as PW  # noqa: E402
from repro_torch import survey  # noqa: E402
from repro_torch.core.graphs import encode_graph_batch  # noqa: E402
from repro_torch.core.vectorized.specs import T_EDGES  # noqa: E402


def _signature(g):
    return (g.name, g.task_count, g.object_count,
            [(t.duration, t.cpus, t.expected_duration,
              [o.size for o in t.outputs], [o.id for o in t.inputs])
             for t in g.tasks])


def _fields(manifest):
    return dataclasses.astuple(manifest)


def test_wfcommons_mini_manifest_contract():
    """At least 3 recipe families x 2 scales each; the manifest and its
    built graphs equal the reference's."""
    assert _fields(PW.WFCOMMONS_MINI) == _fields(JW.WFCOMMONS_MINI)
    fams = {}
    for name in PW.WFCOMMONS_MINI.instances:
        rec = PW.parse_instance(name)
        assert rec is not None, name
        fams.setdefault(rec.name, set()).add(rec.n_tasks)
    assert len(fams) >= 3
    assert all(len(scales) >= 2 for scales in fams.values())
    graphs = PW.build_dataset(PW.WFCOMMONS_MINI)
    want = JW.build_dataset(JW.WFCOMMONS_MINI)
    assert list(graphs) == list(want) == list(PW.WFCOMMONS_MINI.instances)
    for name, g in graphs.items():
        g.validate()
        assert _signature(g) == _signature(want[name]), name


def test_get_manifest():
    assert PW.get_manifest("wfcommons-mini") is PW.WFCOMMONS_MINI
    assert PW.get_manifest(PW.WFCOMMONS_MINI) is PW.WFCOMMONS_MINI
    for per_family in (1, 3):
        d = PW.get_manifest("default", per_family=per_family)
        assert _fields(d) == _fields(
            JW.get_manifest("default", per_family=per_family))
        assert d.instances == PW.default_manifest(per_family).instances
    assert "montage-77-s0" in PW.get_manifest("default").instances
    with pytest.raises(KeyError, match="unknown dataset"):
        PW.get_manifest("nope")
    assert set(PW.MANIFESTS) == set(JW.MANIFESTS)
    with pytest.raises(ValueError, match="no instances"):
        PW.Manifest("empty", ())
    with pytest.raises(ValueError, match="duplicate"):
        PW.Manifest("dup", ("a", "a"))


@pytest.mark.parametrize("counts,k,want", [
    ([10, 20, 100, 300], 2, (32, 320)),
    ([10, 20, 100, 300], 1, (320,)),
    ([50, 50, 50], 3, (64,)),
    ([7, 33, 64, 65, 200, 511, 513], 3, (64, 224, 544)),
])
def test_compute_bucket_edges_quantiles(counts, k, want):
    assert PW.compute_bucket_edges(counts, k=k) == want
    assert JW.compute_bucket_edges(counts, k=k) == want


def test_compute_bucket_edges_rejects_k0():
    with pytest.raises(ValueError, match="k >= 1"):
        PW.compute_bucket_edges([10], k=0)


def test_compute_bucket_edges_cover_dataset():
    edges = PW.compute_bucket_edges(PW.WFCOMMONS_MINI)
    assert edges == JW.compute_bucket_edges(JW.WFCOMMONS_MINI) == (128, 288)
    counts = [g.task_count
              for g in PW.build_dataset(PW.WFCOMMONS_MINI).values()]
    assert max(counts) <= edges[-1]
    assert all(e % 32 == 0 for e in edges)
    # derived edges drive the bucketing layer without overflow
    _, groups = encode_graph_batch(PW.WFCOMMONS_MINI.instances, bucket=True,
                                   t_edges=edges, overflow="error")
    assert [grp.shape[0] for grp in groups] == list(edges)
    assert [grp.label for grp in groups] == ["T128xO160xE224",
                                             "T288xO448xE544"]
    assert sum(len(grp.names) for grp in groups) == 6


@pytest.mark.parametrize("clusters", [["8x4", "1x8+4x2"],
                                      ["8x4", "16x4", "3x2"],
                                      ["32x4", "1x8+4x2", "16x4", "8x4"]])
def test_compute_w_buckets(clusters):
    assert PW.compute_w_buckets(clusters) == JW.compute_w_buckets(clusters)
    for n in (1, 3, 5, 8, 9, 32, 33):
        assert PW.w_bucket(n) == JW.w_bucket(n)


def test_w_bucket_is_the_cluster_module_one():
    from repro_torch.core import cluster
    from repro_torch.workloads import datasets
    assert datasets.w_bucket is cluster.w_bucket is PW.w_bucket


def test_dataset_axis_default_vs_manifest():
    """The default dataset keeps the tuned T_EDGES; a manifest comes
    back prebuilt with edges derived from its graphs — as in the
    reference's ``dataset_axis``."""
    ds, names, t_edges = survey.dataset_axis(survey.MINI_GRID)
    assert (ds, t_edges) == ("default", None)
    assert names == jsurvey.dataset_axis(jsurvey.MINI_GRID)[1]

    grid = dict(survey.MINI_GRID, dataset="wfcommons-mini")
    ds, items, t_edges = survey.dataset_axis(grid)
    jds, jitems, jt_edges = jsurvey.dataset_axis(grid)
    assert ds == jds == "wfcommons-mini"
    assert tuple(n for n, _ in items) == PW.WFCOMMONS_MINI.instances
    assert [n for n, _ in items] == [n for n, _ in jitems]
    for (_, g), (_, jg) in zip(items, jitems):
        assert _signature(g) == _signature(jg)
    assert t_edges == jt_edges == (128, 288)
    assert t_edges != T_EDGES
    # prebuilt pairs flow through encode_graph_batch unchanged
    enc = encode_graph_batch(items[:2], seed=0)
    assert enc[items[0][0]][0] is items[0][1]
    with pytest.raises(KeyError, match="unknown dataset"):
        survey.dataset_axis(dict(survey.MINI_GRID, dataset="nope"))
