"""The port's in-loop schedulers (``repro_torch.core.vectorized.scheduling``)
against the reference's, exactly: assignments and priority ranks of
blevel/tlevel/mcp/etf/random (seeds 0 and 3), the greedy placer, the
transfer-cost segment sum and the uint32 counter hash, on the T160
survey bucket at clusters 8x4 and 1x8+4x2.  Both sides get the same
graph (the reference's encoded spec, through ``spec_from_numpy``) and
the same numpy inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import parse_cluster  # noqa: E402
from repro.core.graphs import encode_graph_batch, survey_names  # noqa: E402
from repro.core.imodes import encode_imode  # noqa: E402
from repro.core.vectorized import scheduling as J  # noqa: E402
from repro.core.vectorized.specs import pad_to  # noqa: E402
from repro_torch.core.vectorized import scheduling as P  # noqa: E402
from repro_torch.core.vectorized.specs import spec_from_numpy  # noqa: E402

CLUSTERS = {"8x4": parse_cluster("8x4"),
            "1x8+4x2": parse_cluster("1x8+4x2") + [0, 0, 0]}
W = 8
MAX_CORES = 8
BW = np.float32(64 * 1024 * 1024)
FIELDS = ("durations", "cpus", "sizes", "producer", "edge_task", "edge_obj",
          "n_inputs", "task_valid", "obj_valid", "edge_valid")


@pytest.fixture(scope="module")
def bucket():
    """The T160 group of the survey graphs: numpy spec fields [B, ...]
    and per-imode padded estimates."""
    encoded, groups = encode_graph_batch(survey_names(3), bucket=True)
    grp = next(g for g in groups if g.shape[0] == 160)
    T, O, _ = grp.shape
    fields = {f: np.asarray(getattr(grp.batch, f)) for f in FIELDS}
    est = {}
    for imode in ("exact", "user"):
        ds, ss = [], []
        for name in grp.names:
            d, s = encode_imode(encoded[name][0], imode)
            ds.append(pad_to(d, T))
            ss.append(pad_to(s, O))
        est[imode] = (np.stack(ds), np.stack(ss))
    return dict(grp=grp, fields=fields, est=est,
                tspec=spec_from_numpy(fields, "cpu"))


_JAX_SCHED = {}


def jax_schedule(name):
    if name not in _JAX_SCHED:
        fn = J.make_bucket_scheduler(W, None, name, MAX_CORES)
        _JAX_SCHED[name] = jax.jit(jax.vmap(
            fn, in_axes=(0, 0, 0, None, None, None)))
    return _JAX_SCHED[name]


@pytest.mark.parametrize("cluster", sorted(CLUSTERS))
@pytest.mark.parametrize("name", ["blevel", "tlevel", "mcp", "etf",
                                  "random"])
def test_static_schedules_equal_reference(bucket, name, cluster):
    cores = np.asarray(CLUSTERS[cluster], np.int32)
    B = bucket["grp"].batch.B
    port = P.make_bucket_scheduler(W, None, name, MAX_CORES)
    seeds = (0, 3) if name == "random" else (0,)
    for imode, (D, S) in bucket["est"].items():
        for seed in seeds:
            aw_j, pr_j = jax_schedule(name)(bucket["grp"].batch, D, S, BW,
                                            np.int32(seed), cores)
            aw_p, pr_p = port(bucket["tspec"], torch.from_numpy(D),
                              torch.from_numpy(S), torch.full((B,), BW),
                              torch.full((B,), seed, dtype=torch.int64),
                              torch.from_numpy(cores))
            assert np.array_equal(np.asarray(aw_j), aw_p.numpy()), \
                (name, cluster, imode, seed)
            assert np.array_equal(np.asarray(pr_j), pr_p.numpy()), \
                (name, cluster, imode, seed)


def test_levels_and_ranks_equal_reference(bucket):
    D = bucket["est"]["user"][0]
    bl_j = jax.vmap(J.bucket_blevel)(bucket["grp"].batch, D)
    tl_j = jax.vmap(J.bucket_tlevel)(bucket["grp"].batch, D)
    bl_p = P.bucket_blevel(bucket["tspec"], torch.from_numpy(D))
    tl_p = P.bucket_tlevel(bucket["tspec"], torch.from_numpy(D))
    assert np.array_equal(np.asarray(bl_j), bl_p.numpy())
    assert np.array_equal(np.asarray(tl_j), tl_p.numpy())
    rk_j = jax.vmap(J.rank_priorities)(bl_j)
    assert np.array_equal(np.asarray(rk_j),
                          P.rank_priorities(bl_p).numpy())


def test_transfer_costs_equal_reference(bucket):
    """Random sizes and missing masks: the port's ordered segment sum is
    bitwise the reference's scatter-add."""
    B = bucket["grp"].batch.B
    T, O, _ = bucket["grp"].shape
    rng = np.random.default_rng(11)
    size_now = (rng.uniform(0.1, 900, (B, O)) * 1024 * 1024).astype(
        np.float32)
    missing = rng.random((B, O, W)) < 0.7
    want = jax.vmap(J.bucket_transfer_costs)(bucket["grp"].batch, size_now,
                                             missing)
    got = P.bucket_transfer_costs(bucket["tspec"],
                                  torch.from_numpy(size_now),
                                  torch.from_numpy(missing))
    assert got.shape == (B, T, W)
    assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("cluster", sorted(CLUSTERS))
def test_greedy_placer_equals_reference(bucket, cluster):
    """Integer-valued costs force cost ties, so the queued-load and
    worker-id tie-breaks decide too."""
    cores = np.asarray(CLUSTERS[cluster], np.int32)
    B = bucket["grp"].batch.B
    T = bucket["grp"].shape[0]
    rng = np.random.default_rng(3)
    fields = bucket["fields"]
    ready = (rng.random((B, T)) < 0.4) & fields["task_valid"]
    cost = rng.integers(0, 3, (B, T, W)).astype(np.float32) * 1e6
    load0 = rng.integers(0, 3, (B, W)).astype(np.int32)
    place_j = J.make_bucket_greedy_placer(W, None)
    want = jax.jit(jax.vmap(place_j, in_axes=(0, 0, 0, 0, None)))(
        bucket["grp"].batch, ready, cost, load0, cores)
    place_p = P.make_bucket_greedy_placer(W, None)
    got = place_p(bucket["tspec"], torch.from_numpy(ready),
                  torch.from_numpy(cost), torch.from_numpy(load0),
                  torch.from_numpy(cores))
    assert np.array_equal(np.asarray(want), got.numpy())
    assert (got.numpy() >= 0).sum() == ready.sum()


def test_mix32_equals_uint32_reference():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2 ** 32, 10_000, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 1, 2 ** 31, 2 ** 32 - 1]
    want = np.asarray(J._mix32(jnp.asarray(x)))
    got = P._mix32(torch.from_numpy(x.astype(np.int64))).numpy()
    assert np.array_equal(want.astype(np.int64), got)
    seeds = np.array([0, 3, 2 ** 31 - 1, -5], np.int32)
    want = np.asarray(jnp.asarray(seeds).astype(jnp.uint32)
                      * jnp.uint32(0x9E3779B9))
    got = P._mul32(torch.from_numpy(seeds.astype(np.int64)) & P.M32,
                   0x9E3779B9).numpy()
    assert np.array_equal(want.astype(np.int64), got)


def test_ready_tasks_and_frontier_mask_equal_reference(bucket):
    B = bucket["grp"].batch.B
    T = bucket["grp"].shape[0]
    rng = np.random.default_rng(4)
    t_done = rng.random((B, T)) < 0.5
    t_started = t_done | (rng.random((B, T)) < 0.2)
    want = jax.vmap(J.bucket_ready_tasks)(bucket["grp"].batch, t_done,
                                          t_started)
    got = P.bucket_ready_tasks(bucket["tspec"], torch.from_numpy(t_done),
                               torch.from_numpy(t_started))
    assert np.array_equal(np.asarray(want), got.numpy())
    fr = rng.integers(-1, T, (B, 40)).astype(np.int32)
    want = jax.vmap(lambda f: J.frontier_mask(f, T))(fr)
    got = P.frontier_mask(torch.from_numpy(fr), T)
    assert np.array_equal(np.asarray(want), got.numpy())


def test_dynamic_scheduler_has_no_static_schedule():
    with pytest.raises(KeyError, match="greedy"):
        P.make_bucket_scheduler(W, 4, "greedy")
    assert P.VEC_SCHEDULERS == J.VEC_SCHEDULERS
