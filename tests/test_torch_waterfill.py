"""The port's plain max-min solver (``repro_torch.core.vectorized.waterfill``)
against the reference's jnp progressive filling and its Pallas kernel
in interpret mode, on the same numpy inputs; plus the kernel wrapper's
CPU routing and device checks.

Tolerance: rtol 1e-6, atol 0.  Counts are integer-valued, the division
is IEEE and the capacity update is rounded once as the reference's
fused multiply-add, so the rates come out bitwise equal; the tests also
assert that.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.vectorized.waterfill import waterfill as jnp_waterfill  # noqa: E402
from repro.kernels.waterfill import waterfill_batch  # noqa: E402
from repro_torch.core.vectorized.waterfill import waterfill  # noqa: E402
from repro_torch.core.vectorized.waterfill import waterfill_rounds  # noqa: E402
from repro_torch.kernels import waterfill as wk  # noqa: E402
from repro_torch.kernels.waterfill import waterfill as kernel_waterfill  # noqa: E402
from repro_torch.kernels.waterfill import LAUNCHES  # noqa: E402

RTOL = 1e-6


def flow_sets(seed, R, W, F, p_active=0.6):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, W, (R, F)).astype(np.int32)
    dst = rng.integers(0, W, (R, F)).astype(np.int32)
    active = rng.random((R, F)) < p_active
    caps = rng.uniform(50, 150, (R, W)).astype(np.float32)
    return src, dst, active, caps


def port(src, dst, active, caps, max_rounds=None):
    t = [torch.from_numpy(np.ascontiguousarray(x))
         for x in (src, dst, active, caps)]
    return waterfill(t[0], t[1], t[2], t[3], t[3],
                     max_rounds=max_rounds).numpy()


def reference(src, dst, active, caps, max_rounds=None):
    fn = jax.vmap(lambda s, d, a, c: jnp_waterfill(s, d, a, c, c,
                                                   max_rounds=max_rounds))
    return np.asarray(jax.jit(fn)(src, dst, active, caps))


def pallas(src, dst, active, caps, rounds=None):
    return np.asarray(waterfill_batch(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(active),
        jnp.asarray(caps), jnp.asarray(caps), rounds=rounds,
        interpret=True))


def assert_same(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("W", [1, 4, 16, 32])
@pytest.mark.parametrize("F", [1, 8, 64, 128])
def test_random_flow_sets_match_jnp(W, F):
    args = flow_sets(W * 1000 + F, 64, W, F)
    assert_same(port(*args), reference(*args))


@pytest.mark.parametrize("W,F", [(1, 1), (4, 8), (16, 64), (32, 128)])
def test_random_flow_sets_match_pallas_interpret(W, F):
    args = flow_sets(W * 7 + F, 16, W, F)
    assert_same(port(*args), pallas(*args))


@pytest.mark.parametrize("W", [1, 4, 16, 32])
def test_no_active_flows_is_all_zero(W):
    z = np.zeros((3, 6), np.int32)
    args = (z, z, np.zeros((3, 6), bool), np.full((3, W), 100.0, np.float32))
    got = port(*args)
    assert not got.any()
    assert_same(got, reference(*args))


@pytest.mark.parametrize("W,F", [(4, 4), (16, 12), (32, 128)])
def test_single_source_contention_splits_upload(W, F):
    src = np.zeros((2, F), np.int32)
    dst = np.broadcast_to(1 + (np.arange(F) % (W - 1)),
                          (2, F)).astype(np.int32)
    args = (src, dst, np.ones((2, F), bool), np.full((2, W), 90.0,
                                                     np.float32))
    got = port(*args)
    assert_same(got, reference(*args))
    assert_same(got, pallas(*args))
    per_dst = np.bincount(dst[0], minlength=W).max()
    np.testing.assert_allclose(got, min(90.0 / F, 90.0 / per_dst),
                               rtol=1e-5)


@pytest.mark.parametrize("W", [4, 16, 32])
def test_equal_share_tie_rounds(W):
    """A symmetric ring: every resource attains the minimal share at
    once, so one round freezes everything at the capacity."""
    src = np.arange(W, dtype=np.int32)[None]
    dst = ((np.arange(W) + 1) % W).astype(np.int32)[None]
    args = (src, dst, np.ones((1, W), bool), np.full((1, W), 64.0,
                                                     np.float32))
    got = port(*args)
    assert_same(got, reference(*args))
    assert_same(got, pallas(*args))
    np.testing.assert_allclose(got, 64.0, rtol=1e-5)


def test_max_rounds_is_enforced():
    """A cascade of distinct bottlenecks needs several rounds; a bound
    of one round freezes only the first level, as in the reference."""
    W = 4
    src = np.array([[0, 0, 0, 1, 1, 2]], np.int32)
    dst = np.array([[1, 2, 3, 2, 3, 3]], np.int32)
    active = np.ones((1, 6), bool)
    caps = np.array([[30.0, 70.0, 200.0, 400.0]], np.float32)
    full = port(src, dst, active, caps)
    assert len(np.unique(full)) > 1
    for k in (1, 2):
        got = port(src, dst, active, caps, max_rounds=k)
        assert_same(got, reference(src, dst, active, caps, max_rounds=k))
        assert_same(got, pallas(src, dst, active, caps, rounds=k))
        if k == 1:
            assert (got == 0).any()      # later levels not yet frozen
    assert_same(port(src, dst, active, caps, max_rounds=2 * W), full)


def test_rows_are_independent():
    """A batch equals its rows solved one at a time (finished rows are
    frozen, never perturbed by rows still filling)."""
    src, dst, active, caps = flow_sets(5, 12, 8, 32)
    active[3] = False
    batch = port(src, dst, active, caps)
    for r in range(12):
        one = port(src[r:r + 1], dst[r:r + 1], active[r:r + 1],
                   caps[r:r + 1])
        assert np.array_equal(batch[r:r + 1], one)


def test_wrapper_runs_the_plain_version_for_cpu_tensors():
    src, dst, active, caps = (torch.from_numpy(x)
                              for x in flow_sets(9, 10, 8, 32))
    before, routes = LAUNCHES.count, dict(LAUNCHES.routes)
    got = kernel_waterfill(src, dst, active, caps, caps)
    # no kernel launch on the CPU, on any route
    assert LAUNCHES.count == before and LAUNCHES.routes == routes
    assert torch.equal(got, waterfill(src, dst, active, caps, caps))
    one = kernel_waterfill(src[0], dst[0], active[0], caps[0], caps[0])
    assert torch.equal(one, got[0])


@pytest.mark.parametrize("route", wk.ROUTES)
def test_forced_route_runs_the_plain_version_for_cpu_tensors(route):
    src, dst, active, caps = (torch.from_numpy(x)
                              for x in flow_sets(4, 6, 8, 32))
    before, routes = LAUNCHES.count, dict(LAUNCHES.routes)
    got = wk._waterfill(src, dst, active, caps, caps, 3, route=route)
    assert LAUNCHES.count == before and LAUNCHES.routes == routes
    assert torch.equal(got, waterfill(src, dst, active, caps, caps, 3))


@pytest.mark.parametrize("F", [992, 2016])
def test_plain_version_at_the_per_edge_flow_counts(F):
    """F = E flows per row (the per-edge simulator's solve at the T512 and
    T2048 buckets), past one block of the kernel's threads."""
    src, dst, active, caps = flow_sets(F, 4, 32, F)
    want = reference(src, dst, active, caps)
    got = port(src, dst, active, caps)
    assert_same(got, want)
    assert np.array_equal(got, want)
    assert wk.route_for(F, 32) == "block"


@pytest.mark.parametrize("F,W,route", [
    (128, 32, "warp"), (129, 32, "block"), (128, 33, "block"),
    (129, 33, "block"), (4, 1, "warp"), (1, 1, "warp"), (100, 20, "warp"),
    (256, 64, "block"), (1024, 512, "block"), (2016, 32, "block")])
def test_route_is_picked_by_shape(F, W, route):
    assert wk.route_for(F, W) == route


def test_wrapper_checks_dtype_and_shape():
    src, dst, active, caps = (torch.from_numpy(x)
                              for x in flow_sets(2, 4, 4, 8))
    with pytest.raises(TypeError, match="float32"):
        kernel_waterfill(src, dst, active, caps.double(), caps.double())
    with pytest.raises(TypeError, match="caps_down"):
        kernel_waterfill(src, dst, active, caps, caps.half())
    with pytest.raises(ValueError, match="shape"):
        kernel_waterfill(src, dst[:, :4], active, caps, caps)
    with pytest.raises(ValueError, match="shape"):
        kernel_waterfill(src, dst, active[:3], caps, caps)
    with pytest.raises(ValueError, match="caps"):
        kernel_waterfill(src, dst, active, caps[:2], caps[:2])
    with pytest.raises(ValueError, match="caps"):
        kernel_waterfill(src, dst, active, caps, caps[:, :2])
    with pytest.raises(ValueError, match="several devices"):
        kernel_waterfill(src, dst, active, caps, caps.to("meta"))
    with pytest.raises(ValueError, match="route"):
        wk._waterfill(src, dst, active, caps, caps, route="grid")
    s33, d33, a33, c33 = (torch.from_numpy(x) for x in flow_sets(3, 2, 33, 8))
    with pytest.raises(ValueError, match="warp route"):
        wk._waterfill(s33, d33, a33, c33, c33, route="warp")


def test_filling_rounds_are_what_a_row_needs():
    """``waterfill_rounds`` gives ``waterfill``'s rates and, per row, the
    rounds it took: a bound of that many rounds changes nothing, one
    round fewer leaves the row's last level unfrozen, and a row with no
    active flow takes none."""
    src, dst, active, caps = (torch.from_numpy(x)
                              for x in flow_sets(11, 24, 8, 32))
    active[5] = False
    rates, rounds = waterfill_rounds(src, dst, active, caps, caps)
    assert torch.equal(rates, waterfill(src, dst, active, caps, caps))
    assert rounds.dtype == torch.int64 and rounds.shape == (24,)
    assert int(rounds[5]) == 0 and bool((rounds[:5] > 0).all())
    assert torch.equal(waterfill(src, dst, active, caps, caps,
                                 max_rounds=int(rounds.max())), rates)
    for r in range(24):
        k = int(rounds[r])
        if k == 0:
            assert not rates[r].any()
            continue
        cut = waterfill(src[r], dst[r], active[r], caps[r], caps[r],
                        max_rounds=k - 1)
        assert not torch.equal(cut, rates[r])
    one_rates, one_rounds = waterfill_rounds(src[0], dst[0], active[0],
                                             caps[0], caps[0])
    assert torch.equal(one_rates, rates[0])
    assert one_rounds.dim() == 0 and int(one_rounds) == int(rounds[0])


def test_cuda_request_raises_without_a_card():
    from repro_torch import resolve_device
    from repro_torch.core.vectorized.sim import make_bucket_dynamic_simulator
    with pytest.raises(ValueError, match="CUDA"):
        make_bucket_dynamic_simulator(4, 2, waterfill_impl="cuda",
                                      device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card error cannot "
                    "be observed")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_bucket_dynamic_simulator(4, 2, waterfill_impl="cuda")
