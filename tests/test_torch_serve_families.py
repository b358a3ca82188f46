"""The families' own serving paths against the reference package on the
CPU: both MoE dispatches, the int8 and ring KV caches, vision
cross-attention and the audio frontend, plus the port's copies of the
reference's own checks of them (``tests/test_models.py``: gather vs
dense, dropped tokens, int8 and ring decode against the full forward).

The reference's float32 smoke parameters are carried across with
``params_from_jax``; the port must match the reference within 1e-4
(float32 sums taken in another order over a few layers), with equal
greedy tokens.  Both sides run their plain paths.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro import models as jm  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import (decode_step, forward,  # noqa: E402
                                params_from_jax, params_to_jax, prefill)
from repro_torch.models.layers import moe_block  # noqa: E402

TOL = 1e-4


@pytest.fixture(autouse=True)
def _no_grad():
    """Serving takes no gradient: the port's forward runs under
    ``no_grad`` here as prefill and decode do."""
    with torch.no_grad():
        yield


def _cfgs(arch, **kw):
    return (jcfgs.smoke_config(arch, **kw), tcfgs.smoke_config(arch, **kw))


def _pair(arch, seed, edit=None, **kw):
    """The reference's parameters of ``arch``'s smoke config (``kw``
    applied to both sides) and the port's model holding them; ``edit``
    changes the numpy tree first."""
    jcfg, tcfg = _cfgs(arch, **kw)
    tree = jax.tree.map(np.asarray, jm.init_params(jcfg,
                                                   jax.random.key(seed)))
    if edit:
        edit(tree)
    params = jax.tree.map(jnp.asarray, tree)
    return jcfg, params, params_from_jax(tree, tcfg, device="cpu")


def _tokens(cfg, seed, B, S):
    rng = np.random.default_rng(seed)
    audio = (cfg.codebooks,) if cfg.frontend == "audio" else ()
    return rng.integers(0, cfg.vocab_size, (B, S, *audio), dtype=np.int32)


def _t(a):
    return torch.as_tensor(a)


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def _serve_both(jcfg, params, model, tokens, prompt, cache_len,
                vision=None):
    """Prefill ``tokens[:, :prompt]`` and decode the rest teacher-forced
    on both sides; each step's logits compared."""
    batch = {} if vision is None else {"vision": jnp.asarray(vision)}
    pre = jax.jit(lambda p, b: jm.prefill(p, jcfg, b, cache_len=cache_len))
    dec = jax.jit(lambda p, t, c, pos: jm.decode_step(p, jcfg, t, c, pos))
    lg, cache, pos = pre(params, dict(batch, tokens=jnp.asarray(
        tokens[:, :prompt])))
    tl, tc, tpos = prefill(model, _t(tokens[:, :prompt]).long(),
                           cache_len=cache_len,
                           vision=None if vision is None else _t(vision))
    _close(tl, lg)
    for i in range(prompt, tokens.shape[1]):
        lg, cache, pos = dec(params, jnp.asarray(tokens[:, i:i + 1]),
                             cache, pos)
        tl, tc, tpos = decode_step(model, _t(tokens[:, i:i + 1]).long(),
                                   tc, tpos)
        _close(tl, lg)
    return tc


# ------------------------------------------------------------------- MoE
@pytest.mark.parametrize("arch,kw", [
    ("mixtral-8x22b", dict(moe_dispatch="gather")),
    ("mixtral-8x22b", dict(moe_dispatch="gather", moe_capacity=0.01)),
    ("llama4-scout-17b-a16e", dict(moe_dispatch="gather", moe_groups=2)),
    ("mixtral-8x22b", dict(moe_fold_gates=True)),
])
def test_moe_dispatch_matches_reference(arch, kw):
    """The gather dispatch (with drops at capacity 0.01, with two token
    groups) and the folded gates, through the full forward, prefill and
    decode."""
    jcfg, params, model = _pair(arch, 1, **kw)
    tokens = _tokens(jcfg, 1, 2, 40)
    want, _ = jm.forward(params, jcfg, {"tokens": jnp.asarray(tokens)})
    got, _ = forward(model, _t(tokens).long())
    _close(got, want)
    _serve_both(jcfg, params, model, tokens, 32, 40)


def test_moe_block_gather_matches_reference_at_4x256_tokens():
    jcfg, params, model = _pair("mixtral-8x22b", 2, moe_dispatch="gather",
                                moe_capacity=0.01)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 256, jcfg.d_model)).astype(np.float32)
    want = jm.layers.moe_block(jnp.asarray(x),
                               jax.tree.map(lambda a: a[0],
                                            params["blocks"]["moe"]), jcfg)
    got = moe_block(_t(x), model.layers[0].moe, model.cfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def test_moe_gather_matches_dense():
    """The reference's check: gather == dense at ample capacity."""
    cfg = tcfgs.smoke_config("mixtral-8x22b")
    _, _, model = _pair("mixtral-8x22b", 0)
    tokens = _t(_tokens(cfg, 0, 2, 32)).long()
    ld, _ = forward(model, tokens)
    model.cfg = dataclasses.replace(cfg, moe_dispatch="gather",
                                    moe_capacity=4.0)
    lg, _ = forward(model, tokens)
    assert float((ld - lg).abs().max()) < 2e-5


def test_moe_gather_drops_overflow_tokens():
    """The reference's check: at capacity ~0 the buffers (one
    128-aligned block per expert) overflow on 4 x 256 tokens."""
    cfg = tcfgs.smoke_config("mixtral-8x22b")
    _, _, model = _pair("mixtral-8x22b", 0)
    tokens = _t(_tokens(cfg, 0, 4, 256)).long()
    ld, _ = forward(model, tokens)
    model.cfg = dataclasses.replace(cfg, moe_dispatch="gather",
                                    moe_capacity=0.01)
    lg, _ = forward(model, tokens)
    assert bool(((ld - lg).abs() > 1e-4).any())


def test_top_k_takes_the_lowest_index_among_equal_logits():
    from repro_torch.models.layers import top_k
    logits = np.array([[0.5, 2.0, 2.0, 1.0, 2.0, -1.0]], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(logits), 3)
    got_v, got_i = top_k(_t(logits), 3)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_i.tolist() == [[1, 2, 4]]


# ------------------------------------------------------------ KV caches
def test_int8_kv_cache_decode_matches_reference():
    """int8 decode equals the reference's int8 decode, and stays within
    the reference's own bound of the full forward."""
    jcfg, params, model = _pair("qwen3-32b", 0, kv_cache_dtype="int8")
    S = 16
    tokens = _tokens(jcfg, 0, 2, S)
    cache = _serve_both(jcfg, params, model, tokens, S - 2, S)
    kv = cache[0]["kv"]
    assert kv["k"].dtype == torch.int8 and kv["k_scale"].dtype == \
        torch.float32 and kv["k_scale"].shape == (2, S, 2, 1)
    # the reference's check against the full forward
    full, _ = forward(model, _t(tokens).long())
    lg, c, pos = prefill(model, _t(tokens[:, :S - 2]).long(), cache_len=S)
    errs = [float((lg[:, 0] - full[:, S - 3]).abs().max())]
    for i in range(2):
        lg, c, pos = decode_step(model, _t(tokens[:, S - 2 + i:S - 1 + i])
                                 .long(), c, pos)
        errs.append(float((lg[:, 0] - full[:, S - 2 + i]).abs().max()))
    scale = float(full.abs().max())
    assert max(errs) < 0.05 * max(scale, 1.0)


def test_int8_quantize_rounds_half_to_even_as_the_reference():
    from repro_torch.models.layers import quantize
    t = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -126.5],
                  [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]], np.float32)
    want_q, want_s = jm.layers._quantize(jnp.asarray(t))
    got_q, got_s = quantize(_t(t))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_q[0].tolist() == [127, 0, 2, 2, 0, -126]


def test_ring_cache_decode_matches_reference():
    """A window-sized ring: decode wraps it, equals the reference's ring
    decode, and stays within its own bound of the full forward."""
    jcfg, tcfg = _cfgs("mixtral-8x22b")            # window 16
    S, W = 24, jcfg.window
    jring = dataclasses.replace(jcfg, window_ring_cache=True,
                                max_cache_len=W)
    _, params, model = _pair("mixtral-8x22b", 0, window_ring_cache=True,
                             max_cache_len=W)
    tokens = _tokens(jcfg, 0, 2, S)
    _serve_both(jring, params, model, tokens, W, W)
    # the reference's check: the full forward on the same weights
    model.cfg = dataclasses.replace(model.cfg, window_ring_cache=False,
                                    max_cache_len=S)
    full, _ = forward(model, _t(tokens).long())
    model.cfg = dataclasses.replace(tcfg, window_ring_cache=True,
                                    max_cache_len=W)
    lg, cache, pos = prefill(model, _t(tokens[:, :W]).long(), cache_len=W)
    errs = [float((lg[:, 0] - full[:, W - 1]).abs().max())]
    for i in range(S - W):
        lg, cache, pos = decode_step(model, _t(tokens[:, W + i:W + i + 1])
                                     .long(), cache, pos)
        errs.append(float((lg[:, 0] - full[:, W + i]).abs().max()))
    scale = float(full.abs().max())
    assert max(errs) < 5e-4 * max(scale, 1.0)
    assert cache[0]["kv"]["k"].shape[1] == W


# --------------------------------------------------------------- vision
def _gates(value):
    def edit(tree):
        g = tree["cross_blocks"]["attn"]["gate"]
        tree["cross_blocks"]["attn"]["gate"] = np.full_like(g, value)
    return edit


@pytest.mark.parametrize("kw", [{}, dict(qk_norm=True)])
def test_cross_attention_with_a_gate_and_a_long_prompt(kw):
    """Every gate 0.5 (tanh(0) would hide cross-attention), a prompt of
    24 tokens over 16 vision tokens; with qk_norm the reference's decode
    normalises the cached cross keys again, and the port does too."""
    jcfg, params, model = _pair("llama-3.2-vision-11b", 3, _gates(0.5),
                                **kw)
    assert float(model.cross_layers[0].attn["gate"]) == 0.5
    tokens = _tokens(jcfg, 3, 2, 28)
    rng = np.random.default_rng(3)
    vision = (0.1 * rng.standard_normal(
        (2, jcfg.cross_tokens, jcfg.d_model))).astype(np.float32)
    assert 24 > jcfg.cross_tokens
    want, _ = jm.forward(params, jcfg, {"tokens": jnp.asarray(tokens),
                                        "vision": jnp.asarray(vision)})
    got, _ = forward(model, _t(tokens).long(), vision=_t(vision))
    _close(got, want)
    # the gate matters: at 0 the logits move
    model.cross_layers[0].attn["gate"].data.zero_()
    assert float((forward(model, _t(tokens).long(), vision=_t(vision))[0]
                  - got).abs().max()) > 1e-3
    model.cross_layers[0].attn["gate"].data.fill_(0.5)
    cache = _serve_both(jcfg, params, model, tokens, 24, 28, vision)
    assert cache[1]["kv"]["k"].shape == (2, jcfg.cross_tokens, 2, 16)


def test_vision_params_round_trip_to_the_reference_tree(tmp_path):
    jcfg, params, model = _pair("llama-3.2-vision-11b", 4, _gates(0.25))
    names = [n for n, _ in model.named_parameters()]
    assert "cross_layers.1.attn.gate" in names and \
        "layers.1.mlp.w1" in names
    back = params_to_jax(model)
    want = jax.tree.map(np.asarray, params)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    CheckpointManager(str(tmp_path)).save(1, model)
    _, _, other = _pair("llama-3.2-vision-11b", 5)
    CheckpointManager(str(tmp_path)).restore(other)
    for (n, a), (_, b) in zip(model.named_parameters(),
                              other.named_parameters()):
        assert torch.equal(a, b), n


# ---------------------------------------------------------------- audio
@pytest.mark.parametrize("tie", [False, True])
def test_audio_tokens_and_logits(tie):
    """Codebook embeddings summed in order, logits [B, S, K, V] (tied:
    through the embedding table), the greedy step [B, 1, K]."""
    jcfg, params, model = _pair("musicgen-large", 6, tie_embeddings=tie)
    tokens = _tokens(jcfg, 6, 2, 20)
    assert tokens.shape == (2, 20, 4)
    assert (model.lm_head is None) == tie
    want, _ = jm.forward(params, jcfg, {"tokens": jnp.asarray(tokens)})
    got, _ = forward(model, _t(tokens).long())
    assert got.shape == (2, 20, 4, jcfg.vocab_size)
    _close(got, want)
    _serve_both(jcfg, params, model, tokens, 16, 20)
    lg, _, _ = prefill(model, _t(tokens).long())
    assert serve.greedy(lg).shape == (2, 1, 4)


def test_serve_generates_audio_and_vision_on_the_cpu():
    res = serve.serve(tcfgs.smoke_config("musicgen-large"), batch=2,
                      prompt_len=8, gen=3, device="cpu")
    assert res["tokens"].shape == (2, 3, 4) and res["vision"] is None
    res = serve.serve(tcfgs.smoke_config("llama-3.2-vision-11b"), batch=2,
                      prompt_len=20, gen=3, device="cpu")
    assert res["tokens"].shape == (2, 3)
    assert res["vision"].shape == (2, 16, 64)
    again = serve.generate(res["model"], res["prompts"], 3, res["vision"])
    assert torch.equal(again["tokens"], res["tokens"])
