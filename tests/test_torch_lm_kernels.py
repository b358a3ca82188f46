"""The plain versions of the LM kernels K2 (attention) and K3 (SSD scan)
against the reference package on the CPU.

* ``attention_ref`` against the reference's ``attention_ref`` (with
  ``kv_len`` and sliding windows) and against its Pallas flash kernel in
  interpret mode on the shapes Pallas accepts: float32, atol/rtol 1e-5.
* ``ssd_chunked`` against the reference's ``ssd_chunked`` (1e-4) and its
  Pallas ``ssd_scan`` in interpret mode (atol 5e-4, rtol 5e-5, as the
  reference's own kernel tests hold it); the final state against the
  reference's sequential ``_final_state`` (1e-4).
* The wrappers and ``ops`` on CPU tensors run these plain versions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa
from repro.kernels.ssd import ssd_scan as jssd_scan  # noqa: E402
from repro.models.ssm import _final_state as jfinal_state  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa
from repro_torch.kernels.ssd import ssd_scan  # noqa: E402


def _qkv(seed, B, Hq, Hkv, Sq, Skv, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, Sq, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32))


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


ATTN_CASES = [
    # B, Hq, Hkv, Sq, Skv, D, causal, window, kv_len
    (2, 4, 4, 16, 16, 16, True, 0, None),
    (1, 5, 1, 24, 40, 16, True, 8, 24),      # prefill into a longer cache
    (2, 6, 2, 1, 40, 32, True, 0, 33),       # decode, full attention
    (2, 6, 2, 1, 40, 32, True, 16, 33),      # decode, sliding window
    (1, 2, 1, 7, 50, 64, True, 5, 50),       # ragged Sq, window < Sq
    (1, 4, 2, 12, 12, 32, False, 0, None),   # non-causal
    (1, 4, 1, 9, 30, 256, True, 4, 21),      # gemma3's head dim
    # cross-attention: a prompt longer than the encoder's tokens
    (2, 8, 2, 24, 16, 16, False, 0, None),
    (1, 4, 2, 20, 16, 32, False, 0, 12),
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_ref_matches_reference(case):
    B, Hq, Hkv, Sq, Skv, D, causal, window, kv_len = case
    q, k, v = _qkv(sum(case[:6]), B, Hq, Hkv, Sq, Skv, D)
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=causal, window=window,
                              kv_len=kv_len)
    got = ref.attention_ref(*_t(q, k, v), causal=causal, window=window,
                            kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # the wrapper and ops on CPU tensors are the plain version
    for fn in (flash_attention, ops.attention):
        out = fn(*_t(q, k, v), causal=causal, window=window, kv_len=kv_len)
        assert torch.equal(out, got)


@pytest.mark.parametrize("shape,causal,window", [
    ((1, 4, 4, 64, 64, 32), True, 0),
    ((2, 4, 2, 64, 128, 32), True, 32),      # GQA, query suffix
    ((1, 2, 1, 64, 64, 64), False, 0),
])
def test_attention_ref_matches_pallas_interpret(shape, causal, window):
    q, k, v = _qkv(sum(shape), *shape)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, window=window, blk_q=32, blk_k=32,
                  interpret=True)
    got = ref.attention_ref(*_t(q, k, v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_attention_ref_keeps_the_input_dtype():
    q, k, v = _qkv(3, 1, 2, 1, 4, 8, 16)
    tq, tk, tv = (t.to(torch.bfloat16) for t in _t(q, k, v))
    out = ref.attention_ref(tq, tk, tv, kv_len=6, window=3)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 2, 4, 16)


def _ssd_inputs(seed, Bt, L, H, P, N):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((Bt, L, H, P)).astype(np.float32),
            rng.uniform(0.001, 0.1, (Bt, L, H)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (H,)).astype(np.float32),
            rng.standard_normal((Bt, L, N)).astype(np.float32),
            rng.standard_normal((Bt, L, N)).astype(np.float32),
            rng.standard_normal((H,)).astype(np.float32))


SSD_CASES = [(1, 64, 2, 16, 8, 32), (2, 128, 3, 32, 16, 32),
             (1, 48, 4, 16, 32, 64), (2, 128, 2, 64, 16, 64)]


@pytest.mark.parametrize("Bt,L,H,P,N,chunk", SSD_CASES)
def test_ssd_chunked_matches_reference(Bt, L, H, P, N, chunk):
    x, dt, A, B, C, D = _ssd_inputs(L + H, Bt, L, H, P, N)
    want = jref.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C, D)),
                            chunk=chunk)
    got = ref.ssd_chunked(*_t(x, dt, A, B, C, D), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    naive = ref.ssd_ref(*_t(x, dt, A, B, C, D))
    np.testing.assert_allclose(got.numpy(), naive.numpy(), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("Bt,L,H,P,N,chunk", SSD_CASES[:3])
def test_ssd_chunked_matches_pallas_interpret(Bt, L, H, P, N, chunk):
    x, dt, A, B, C, D = _ssd_inputs(L * H, Bt, L, H, P, N)
    want = jssd_scan(*map(jnp.asarray, (x, dt, A, B, C, D)),
                     blk_l=chunk, interpret=True)
    got = ref.ssd_chunked(*_t(x, dt, A, B, C, D), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4,
                               rtol=5e-5)


@pytest.mark.parametrize("Bt,L,H,P,N,chunk", SSD_CASES[:2])
def test_final_state_matches_reference(Bt, L, H, P, N, chunk):
    x, dt, A, B, C, D = _ssd_inputs(7 * L, Bt, L, H, P, N)
    want = jfinal_state(*map(jnp.asarray, (x, dt, A, B)))
    got = ref.ssd_final_state(*_t(x, dt, A, B))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    # the wrapper on CPU tensors: the plain scan and the sequential state
    y, state = ssd_scan(*_t(x, dt, A, B, C, D), chunk=chunk,
                        return_state=True)
    assert torch.equal(state, got)
    assert torch.equal(y, ref.ssd_chunked(*_t(x, dt, A, B, C, D),
                                          chunk=chunk))
    y2, state2 = ops.ssd(*_t(x, dt, A, B, C, D), chunk=chunk,
                         return_state=True, impl="torch")
    assert torch.equal(y2, y) and torch.equal(state2, state)


def test_ssd_chunked_survives_a_decay_that_overflows_above_the_diagonal():
    # exp(cum_i - cum_j) overflows for j > i: Γ is a select, so no NaN
    x, dt, A, B, C, D = _ssd_inputs(5, 1, 32, 2, 8, 4)
    dt = np.full_like(dt, 8.0)
    A = np.full_like(A, -2.0)
    got = ref.ssd_chunked(*_t(x, dt, A, B, C, D), chunk=32)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(),
                               ref.ssd_ref(*_t(x, dt, A, B, C, D)).numpy(),
                               atol=1e-4, rtol=1e-4)


def test_wrappers_check_their_inputs():
    q, k, v = _t(*_qkv(1, 1, 3, 2, 4, 8, 16))
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, k, v)
    q, k, v = _t(*_qkv(1, 1, 4, 2, 4, 8, 16))
    with pytest.raises(ValueError, match="kv_len"):
        flash_attention(q, k, v, kv_len=3)
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    x, dt, A, B, C, D = _t(*_ssd_inputs(2, 1, 48, 2, 8, 4))
    with pytest.raises(ValueError, match="multiple"):
        ssd_scan(x, dt, A, B, C, D, chunk=32)
    with pytest.raises(ValueError, match="shapes"):
        ssd_scan(x, dt[:, :, :1], A, B, C, D)
    with pytest.raises(ValueError, match="impl"):
        ops.attention(q, k, v, impl="pallas")
