"""The port's copied generators and its spec layer against the reference
package, field by field and exactly: every survey graph built by
``repro_torch.core.graphs`` encodes and pads to the same arrays as the
reference's, ``spec_from_numpy`` round-trips the reference's spec, and
the bucketing and cap rules (including ``overflow="error"``) agree."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import parse_cluster as j_parse_cluster  # noqa: E402
from repro.core.graphs import encode_graph_batch as j_encode_batch  # noqa: E402
from repro.core.graphs import make_graph as j_make_graph  # noqa: E402
from repro.core.graphs import survey_names as j_survey_names  # noqa: E402
from repro.core.imodes import encode_imode as j_encode_imode  # noqa: E402
from repro.core.vectorized import specs as J  # noqa: E402
from repro.workloads import w_bucket as j_w_bucket  # noqa: E402
from repro_torch.core import parse_cluster, w_bucket  # noqa: E402
from repro_torch.core.graphs import (encode_graph_batch, make_graph,  # noqa: E402
                                     survey_names)
from repro_torch.core.imodes import encode_imode  # noqa: E402
from repro_torch.core.vectorized import specs as P  # noqa: E402

NAMES = j_survey_names(3)
GRAPH_FIELDS = ("durations", "cpus", "sizes", "producer", "edge_task",
                "edge_obj", "n_inputs")


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_survey_names_match():
    assert survey_names(3) == NAMES
    assert survey_names(1) == j_survey_names(1)


@pytest.mark.parametrize("name", NAMES)
def test_generators_and_encodings_equal_reference(name):
    g, jg = make_graph(name, seed=0), j_make_graph(name, seed=0)
    spec, jspec = P.encode_graph(g), J.encode_graph(jg)
    for f in GRAPH_FIELDS:
        assert same(getattr(spec, f), getattr(jspec, f)), f
    for imode in ("exact", "user", "mean"):
        for a, b in zip(encode_imode(g, imode), j_encode_imode(jg, imode)):
            assert same(a, b), imode
    shape = (P.t_bucket(spec.T), P.round_up(spec.O), P.round_up(spec.E))
    assert shape == (J.t_bucket(jspec.T), J.round_up(jspec.O),
                     J.round_up(jspec.E))
    pad, jpad = P.pad_spec(spec, shape), J.pad_spec(jspec, shape)
    for f, v in pad.numpy().items():
        assert same(v, getattr(jpad, f)), f
    assert P.frontier_caps_for(shape) == J.frontier_caps_for(shape)
    assert P.frontier_caps_for_spec(pad) == J.frontier_caps_for_spec(jpad)


def test_seed_variants_and_recipes_equal_reference():
    for name in ("crossv@s3", "montage-220-s1", "mapreduce-64-s0"):
        a = P.encode_graph(make_graph(name, seed=1))
        b = J.encode_graph(j_make_graph(name, seed=1))
        for f in GRAPH_FIELDS:
            assert same(getattr(a, f), getattr(b, f)), (name, f)


def test_pad_specs_equal_reference():
    enc, groups = encode_graph_batch(NAMES, seed=0, bucket=True)
    jenc, jgroups = j_encode_batch(NAMES, seed=0, bucket=True)
    assert list(enc) == list(jenc)
    assert [g.shape for g in groups] == [g.shape for g in jgroups]
    assert [g.names for g in groups] == [g.names for g in jgroups]
    for grp, jgrp in zip(groups, jgroups):
        assert grp.label == jgrp.label
        for f, v in grp.batch.numpy().items():
            assert same(v, getattr(jgrp.batch, f)), (grp.label, f)


def test_spec_from_numpy_round_trips_the_reference_spec():
    _, jgroups = j_encode_batch(NAMES, seed=0, bucket=True)
    for jgrp in jgroups:
        fields = {f: np.asarray(getattr(jgrp.batch, f))
                  for f in P._BSPEC_FIELDS}
        tspec = P.spec_from_numpy(fields, "cpu")
        assert all(torch.is_tensor(v) for v in tspec.fields().values())
        assert tspec.shape == jgrp.shape and tspec.B == jgrp.batch.B
        for f, v in tspec.numpy().items():
            assert same(v, fields[f]), f
        again = tspec.to("cpu").numpy()
        for f, v in again.items():
            assert same(v, fields[f]), f
    with pytest.raises(KeyError, match="missing"):
        P.spec_from_numpy({"durations": np.zeros(3, np.float32)}, "cpu")


def test_t_bucket_overflow_policy_matches_reference():
    for T in (1, 32, 33, 160, 161, 512, 2048, 2049, 5000):
        assert P.t_bucket(T) == J.t_bucket(T)
        assert P.t_bucket(T, (64, 128)) == J.t_bucket(T, (64, 128))
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        P.t_bucket(3000, overflow="error")
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        J.t_bucket(3000, overflow="error")
    with pytest.raises(ValueError, match="unknown overflow"):
        P.t_bucket(10, overflow="clip")
    for n in (0, 5, 256, 257, 992, 2016, 5000):
        assert P.frontier_cap(n) == J.frontier_cap(n)


def test_cluster_helpers_match_reference():
    for name in ("8x4", "16x4", "32x4", "1x8+4x2", "2x1+3x3"):
        assert parse_cluster(name) == j_parse_cluster(name)
    for n in range(1, 70):
        assert w_bucket(n) == j_w_bucket(n)


def test_wfformat_names_are_not_ported_yet():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_graph("wf:some/file.json")
    with pytest.raises(KeyError, match="unknown graph"):
        make_graph("no-such-graph")
