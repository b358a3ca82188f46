"""The decode (split) route of K2 without a card: its plain versions and
its host-side planner.

* ``ref.attention_partials`` + ``ref.combine_splits`` — the plain
  versions of the route's two kernels — over key ranges equal
  ``ref.attention_ref`` and the reference package's ``attention_ref``.
  Windows 0, 16 and 1024, ``kv_len < Skv``, 1 to 13 splits, splits that
  hold no visible key, float32 and bfloat16 inputs.  Limits: rtol 1e-6
  with atol 1e-6 against the port's ``attention_ref`` (a pure relative
  bound cannot hold where an output element is near zero: its terms
  cancel, and two orders of summation differ there by about one
  float32 unit of the terms, even with one split); 1e-5 against the
  reference package, as the other K2 tests hold it.
* ``split_plan`` (Python ints only) partitions the visible key range
  exactly once with no empty range, and gives Hymba-1.5B's decode at
  least one block per SM of an H100.
* The route rule and the per-route launch counter.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels._counter import LaunchCounter  # noqa: E402

F32 = torch.float32


def _qkv(seed, B, Hq, Hkv, Sq, Skv, D, dtype):
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((B, Hq, Sq, D)),
              rng.standard_normal((B, Hkv, Skv, D)),
              rng.standard_normal((B, Hkv, Skv, D)))
    return [torch.as_tensor(a.astype(np.float32)).to(dtype)
            for a in arrays]


def _even_bounds(Skv, n):
    """``n`` contiguous ranges over all ``Skv`` keys, so some of them lie
    outside the window or past ``kv_len`` and hold no visible key."""
    edges = np.linspace(0, Skv, n + 1).round().astype(int)
    return list(zip(edges[:-1].tolist(), edges[1:].tolist()))


@pytest.mark.parametrize("dtype", [F32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("splits", [1, 2, 5, 13])
@pytest.mark.parametrize("window", [0, 16, 1024])
@pytest.mark.parametrize("Sq", [1, 6])
def test_combined_partials_equal_attention(dtype, splits, window, Sq):
    B, Hq, Hkv, Skv, D, kv_len = 2, 6, 2, 80, 32, 70   # kv_len < Skv
    q, k, v = _qkv(splits * 100 + window + Sq, B, Hq, Hkv, Sq, Skv, D,
                   dtype)
    kw = dict(causal=True, window=window, kv_len=kv_len)
    bounds = _even_bounds(Skv, splits)
    o, m, l = ref.attention_partials(q, k, v, bounds, **kw)
    assert o.shape == (splits, B, Hq, Sq, D) and o.dtype == F32
    assert m.shape == l.shape == (splits, B, Hq, Sq)
    # a (split, query) pair with no visible key adds nothing
    mask = ref.attention_mask(Sq, Skv, causal=True, window=window,
                              kv_len=kv_len)
    for i, (lo, hi) in enumerate(bounds):
        blind = ~mask[:, lo:hi].any(dim=1)               # [Sq]
        assert (m[i][..., blind] == -1e30).all()
        assert (l[i][..., blind] == 0).all()
        assert (o[i][..., blind, :] == 0).all()
        assert (l[i][..., ~blind] > 0).all()
    got = ref.combine_splits(o, m, l, F32)
    qf, kf, vf = (t.to(F32) for t in (q, k, v))
    want = ref.attention_ref(qf, kf, vf, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    jwant = jref.attention_ref(*(jnp.asarray(t.numpy()) for t in
                                 (qf, kf, vf)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=1e-5,
                               atol=1e-5)
    # cast to the input's type: the attention output of that type, to
    # one unit in its last place
    out = ref.combine_splits(o, m, l, dtype)
    assert out.dtype == dtype
    torch.testing.assert_close(
        out.to(F32), ref.attention_ref(q, k, v, **kw).to(F32),
        rtol=2 ** -7 if dtype == torch.bfloat16 else 1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [F32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_splits_with_no_visible_key_add_nothing(dtype):
    """Ranges before the window, past kv_len and empty, beside ranges
    that do see keys: the combine equals attention over the seen ones."""
    B, Hq, Hkv, Sq, Skv, D, window, kv_len = 1, 4, 2, 3, 64, 16, 8, 50
    q, k, v = _qkv(7, B, Hq, Hkv, Sq, Skv, D, dtype)
    kw = dict(causal=True, window=window, kv_len=kv_len)
    bounds = [(0, 20), (50, 64), (30, 30), (20, 45), (45, 50)]
    o, m, l = ref.attention_partials(q, k, v, bounds, **kw)
    for i in (0, 1, 2):                        # nothing visible there
        assert (m[i] == -1e30).all() and (l[i] == 0).all() \
            and (o[i] == 0).all()
    got = ref.combine_splits(o, m, l, F32)
    want = ref.attention_ref(*(t.to(F32) for t in (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("window,kv_len", [(0, 1552), (1024, 1552),
                                           (16, 300), (0, 1), (1024, 40)])
@pytest.mark.parametrize("dtype", [F32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_planned_decode_equals_attention(window, kv_len, dtype):
    """The split route as the card runs it, in plain PyTorch: Hymba's
    decode shape (B 4, 25/5 heads of 64, the cache's Skv 1568)."""
    B, Hq, Hkv, Skv, D = 4, 25, 5, 1568, 64
    q, k, v = _qkv(kv_len + window, B, Hq, Hkv, 1, Skv, D, dtype)
    plan = fa.split_plan(kv_len, window, B, Hkv, Hq)
    bounds = fa.split_bounds(*plan, kv_len)
    kw = dict(causal=True, window=window, kv_len=kv_len)
    o, m, l = ref.attention_partials(q, k, v, bounds, **kw)
    assert (l > 0).all()          # every planned split sees a key
    got = ref.combine_splits(o, m, l, F32)
    want = ref.attention_ref(*(t.to(F32) for t in (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


PLAN_CASES = [  # kv_len, window, B, Hkv, Hq
    (1552, 1024, 4, 5, 25), (1552, 0, 4, 5, 25), (1537, 1024, 4, 5, 25),
    (1568, 0, 4, 5, 25), (1, 0, 4, 5, 25), (2, 1024, 4, 5, 25),
    (33, 16, 2, 2, 6), (200, 0, 4, 5, 25), (250, 0, 1, 1, 12),
    (4096, 0, 1, 1, 8), (4096, 4096, 1, 8, 64), (100, 100, 1, 1, 1),
    (5000, 1, 2, 2, 2), (131, 7, 1, 1, 4),
]


@pytest.mark.parametrize("case", PLAN_CASES)
def test_split_plan_partitions_the_visible_range(case):
    kv_len, window, B, Hkv, Hq = case
    lo, per, splits = fa.split_plan(kv_len, window, B, Hkv, Hq)
    assert all(isinstance(x, int) for x in (lo, per, splits))
    vis_lo, vis_hi = fa.visible_range(kv_len, window)
    want_lo = max(0, kv_len - 1 - window + 1) if window > 0 else 0
    assert (vis_lo, vis_hi) == (want_lo, kv_len - 1)
    bounds = fa.split_bounds(lo, per, splits, kv_len)
    assert len(bounds) == splits >= 1
    keys = [key for a, b in bounds for key in range(a, b)]
    assert keys == list(range(vis_lo, vis_hi + 1))   # each key once
    assert all(b > a for a, b in bounds)             # no empty range
    assert all(b - a <= per for a, b in bounds)
    assert fa.SPLIT_KEYS_MIN <= per <= fa.SPLIT_KEYS
    # the same keys as the mask of the plain version shows the query
    mask = ref.attention_mask(1, kv_len, causal=True, window=window,
                              kv_len=kv_len)[0]
    assert torch.nonzero(mask)[:, 0].tolist() == keys


@pytest.mark.parametrize("window", [1024, 0])
def test_split_plan_fills_the_card_at_hymba_decode(window):
    B, Hkv, Hq = 4, 5, 25                 # hymba-1.5b, batch 4
    for kv_len in range(1537, 1569):      # the 32 decode steps
        _, _, splits = fa.split_plan(kv_len, window, B, Hkv, Hq)
        assert splits * B * Hkv * -(-(Hq // Hkv) // fa.SPLIT_HEADS) \
            >= fa.SMS == 132


def test_routes_are_read_from_dtype_and_shape():
    assert fa.route_for(F32, 1) == fa.route_for(F32, 1536) == "f32"
    assert fa.route_for(torch.bfloat16, 1) == "split"
    assert fa.route_for(torch.bfloat16, 2) == "tc"
    assert fa.route_for(torch.bfloat16, 1536) == "tc"
    assert set(fa.LAUNCHES.routes) == set(fa.ROUTES) == {"tc", "split",
                                                         "f32"}


def test_launch_counter_counts_by_route():
    c = LaunchCounter(("tc", "split"))
    c.add("tc")
    c.add("split")
    c.add("split")
    assert c.count == 3 and c.routes == {"tc": 1, "split": 2}
    c.reset()
    assert c.count == 0 and c.routes == {"tc": 0, "split": 0}
    plain = LaunchCounter()
    plain.add()
    plain.count += 1              # how the single-route wrappers count
    assert plain.count == 2 and plain.routes == {}


def test_cpu_calls_launch_nothing():
    q, k, v = _qkv(0, 1, 4, 2, 1, 20, 16, torch.bfloat16)
    before = (fa.LAUNCHES.count, dict(fa.LAUNCHES.routes))
    out = fa.flash_attention(q, k, v, window=8, kv_len=15)
    assert torch.equal(out, ref.attention_ref(q, k, v, window=8,
                                              kv_len=15))
    assert (fa.LAUNCHES.count, fa.LAUNCHES.routes) == before
