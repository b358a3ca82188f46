"""K2 at head dims 128 (chatglm3, qwen3, llama4-scout, mixtral,
llama-3.2-vision) and 160 (stablelm-12b), which the reference's Pallas
kernel takes (its blocks carry the whole head dim) and the port's CUDA
routes take too: the port's ``flash_attention`` on CPU tensors (its
plain version) against the reference's Pallas kernel in interpret mode
and its ``attention_ref`` (decode and ``kv_len`` shapes), float32 at
atol/rtol 1e-5, at a smoke size.  The kernels themselves are held
against the plain version on the card (``test_torch_cuda.py``,
``chip_smoke.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa
from repro_torch.kernels import flash_attention as fa  # noqa: E402


def _qkv(seed, B, Hq, Hkv, Sq, Skv, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, Sq, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32))


def _port(q, k, v, **kw):
    return fa.flash_attention(*(torch.as_tensor(x) for x in (q, k, v)),
                              **kw).numpy()


def test_the_card_routes_take_head_dims_128_and_160():
    assert {128, 160} <= set(fa.HEAD_DIMS)


@pytest.mark.parametrize("shape,causal,window", [
    ((1, 4, 2, 64, 64, 128), True, 0),
    ((1, 4, 1, 32, 64, 128), True, 16),      # GQA, query suffix, window
    ((1, 4, 2, 64, 64, 160), True, 0),
    ((1, 2, 2, 32, 64, 160), True, 24),
    ((1, 2, 1, 32, 32, 160), False, 0),
])
def test_head_dims_match_pallas_interpret(shape, causal, window):
    q, k, v = _qkv(sum(shape), *shape)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, window=window, blk_q=32, blk_k=32,
                  interpret=True)
    got = _port(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", [
    # B, Hq, Hkv, Sq, Skv, D, window, kv_len: decode and a prefill into a
    # longer cache
    (2, 8, 2, 1, 70, 128, 0, 61),
    (1, 4, 1, 1, 90, 160, 32, 77),
    (1, 4, 2, 20, 50, 160, 0, 40),
])
def test_head_dims_match_reference_with_kv_len(case):
    B, Hq, Hkv, Sq, Skv, D, window, kv_len = case
    q, k, v = _qkv(sum(case), B, Hq, Hkv, Sq, Skv, D)
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=True, window=window,
                              kv_len=kv_len)
    got = _port(q, k, v, causal=True, window=window, kv_len=kv_len)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
