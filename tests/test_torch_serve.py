"""The port's LM serving path against the reference package on the CPU.

The reference's parameters (``repro.models.init_params``) are carried
across with ``params_from_jax``; prefill logits and teacher-forced
decode steps must agree with the reference's ``prefill`` /
``decode_step`` on the smoke configs of all ten families of the
registry (float32: atol/rtol 1e-4, the width of float32 sums taken in
another order over a few layers; bfloat16: 5e-2, a few bfloat16 ulps of
the logits), with equal greedy tokens; the audio family's prompts are
``[B, S, K]`` codebook tokens, the vision family reads the same encoder
states on both sides.  Both sides run their plain paths (the
reference's jnp oracles, the port's plain PyTorch versions).
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro import models as jm  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.models import (forward, make_decode_step,  # noqa: E402
                                make_prefill_step, params_from_jax,
                                softmax_cross_entropy)
from repro_torch.models.convert import to_tensor  # noqa: E402

ARCHS = list(tcfgs.ARCH_NAMES)
PROMPT, STEPS, BATCH = 32, 8, 2


def _tokens(cfg, seed):
    rng = np.random.default_rng(seed)
    audio = (cfg.codebooks,) if cfg.frontend == "audio" else ()
    return rng.integers(0, cfg.vocab_size, (BATCH, PROMPT + STEPS, *audio),
                        dtype=np.int32)


def _vision(cfg, seed):
    """The vision family's encoder states (numpy, float32), else None."""
    if cfg.frontend != "vision":
        return None
    rng = np.random.default_rng(seed + 100)
    return (0.1 * rng.standard_normal(
        (BATCH, cfg.cross_tokens, cfg.d_model))).astype(np.float32)


def _jax_run(cfg, params, tokens, vision=None):
    """Prefill on the prompt, then STEPS teacher-forced decode steps."""
    cache_len = PROMPT + STEPS
    batch = {} if vision is None else {"vision": jnp.asarray(vision)}
    pre = jax.jit(lambda p, t: jm.prefill(p, cfg, dict(batch, tokens=t),
                                          cache_len=cache_len))
    dec = jax.jit(lambda p, t, c, pos: jm.decode_step(p, cfg, t, c, pos))
    lg, cache, pos = pre(params, jnp.asarray(tokens[:, :PROMPT]))
    out = [np.asarray(lg.astype(jnp.float32))]
    for i in range(STEPS):
        tok = jnp.asarray(tokens[:, PROMPT + i:PROMPT + i + 1])
        lg, cache, pos = dec(params, tok, cache, pos)
        out.append(np.asarray(lg.astype(jnp.float32)))
    return out


def _torch_run(cfg, model, tokens, vision=None):
    t = torch.as_tensor(tokens, dtype=torch.long)
    prefill_step = make_prefill_step(cache_len=PROMPT + STEPS)
    decode_step = make_decode_step()
    lg, cache, pos = prefill_step(
        model, t[:, :PROMPT],
        vision=None if vision is None else torch.as_tensor(vision))
    out = [lg.float().numpy()]
    for i in range(STEPS):
        lg, cache, pos = decode_step(model, t[:, PROMPT + i:PROMPT + i + 1],
                                     cache, pos)
        out.append(lg.float().numpy())
    return out


def _params(cfg, seed):
    params = jm.init_params(cfg, jax.random.key(seed))
    return params, jax.tree.map(np.asarray, params)


def _compare(cfg, seed, tol):
    params, tree = _params(cfg, seed)
    tokens, vision = _tokens(cfg, seed), _vision(cfg, seed)
    want = _jax_run(cfg, params, tokens, vision)
    tcfg = dataclasses.replace(tcfgs.smoke_config(_arch_of(cfg)),
                               dtype=cfg.dtype)
    model = params_from_jax(tree, tcfg, device="cpu")
    got = _torch_run(tcfg, model, tokens, vision)
    assert len(got) == len(want) == STEPS + 1
    audio = (cfg.codebooks,) if cfg.frontend == "audio" else ()
    for step, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (BATCH, 1, *audio, cfg.vocab_size)
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol,
                                   err_msg=f"{cfg.name} step {step}")
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1),
                                      err_msg=f"{cfg.name} step {step}")


def _arch_of(cfg):
    return next(a for a in ARCHS if jcfgs.smoke_config(a).name == cfg.name)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference_f32(arch):
    _compare(jcfgs.smoke_config(arch), seed=ARCHS.index(arch), tol=1e-4)


def test_prefill_and_decode_match_reference_bf16_hymba():
    cfg = jcfgs.smoke_config("hymba-1.5b", dtype="bfloat16")
    _compare(cfg, seed=7, tol=5e-2)


def test_full_forward_matches_reference():
    cfg = jcfgs.smoke_config("hymba-1.5b")
    params, tree = _params(cfg, 3)
    tokens = _tokens(cfg, 3)[:, :PROMPT]
    want, _ = jax.jit(lambda p, t: jm.forward(p, cfg, {"tokens": t}))(
        params, jnp.asarray(tokens))
    model = params_from_jax(tree, tcfgs.smoke_config("hymba-1.5b"),
                            device="cpu")
    got, cache = forward(model, torch.as_tensor(tokens, dtype=torch.long))
    assert cache is None
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)


def test_bf16_params_carry_across_bit_for_bit():
    cfg = jcfgs.smoke_config("hymba-1.5b", dtype="bfloat16")
    _, tree = _params(cfg, 1)
    t = to_tensor(tree["embed"])
    assert t.dtype == torch.bfloat16
    back = t.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(
        back, np.asarray(tree["embed"]).view(np.uint16))
    model = params_from_jax(tree, tcfgs.smoke_config("hymba-1.5b",
                                                     dtype="bfloat16"),
                            device="cpu")
    assert torch.equal(model.layers[2].attn["wq"].float(),
                       to_tensor(tree["blocks"]["attn"]["wq"][2]).float())


def test_params_from_jax_rejects_a_mismatched_tree():
    cfg = jcfgs.smoke_config("gemma3-1b")
    _, tree = _params(cfg, 0)
    wrong = tcfgs.smoke_config("gemma3-1b", dtype="bfloat16")
    with pytest.raises(ValueError, match="final_norm|embed|wq"):
        params_from_jax(tree, wrong, device="cpu")
    del tree["final_norm"]
    with pytest.raises(ValueError, match="disagree"):
        params_from_jax(tree, tcfgs.smoke_config("gemma3-1b"), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for which in ("get_config", "smoke_config"):
        j = getattr(jcfgs, which)(arch)
        t = getattr(tcfgs, which)(arch)
        jd = dataclasses.asdict(j)
        td = dataclasses.asdict(t)
        assert jd == td
        assert t.param_count() == j.param_count()
        assert t.window_pattern() == j.window_pattern()
        assert t.d_inner == j.d_inner
        assert t.activation_dtype == getattr(torch, j.dtype)
    assert {k: dataclasses.asdict(v) for k, v in tcfgs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jcfgs.SHAPES.items()}
    for shape in tcfgs.SHAPES.values():
        assert tcfgs.shape_applicable(tcfgs.get_config(arch), shape) == \
            jcfgs.shape_applicable(jcfgs.get_config(arch),
                                   jcfgs.SHAPES[shape.name])


def test_softmax_cross_entropy_matches_reference():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 5, 33)).astype(np.float32) * 3
    labels = rng.integers(0, 33, (2, 5)).astype(np.int32)
    want = jm.softmax_cross_entropy(jnp.asarray(logits),
                                    jnp.asarray(labels))
    got = softmax_cross_entropy(torch.as_tensor(logits),
                                torch.as_tensor(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_smoke_model_holds_as_many_params_as_the_reference():
    from repro_torch.models import Transformer
    for arch in ARCHS:
        model = Transformer(tcfgs.smoke_config(arch), device="cpu")
        n = sum(p.numel() for p in model.parameters())
        want = jax.eval_shape(lambda k, a=arch: jm.init_params(
            jcfgs.smoke_config(a), k), jax.random.key(0))
        assert n == sum(x.size for x in jax.tree.leaves(want)), arch


def test_serve_cli_runs_on_the_cpu():
    from repro_torch.launch import serve
    res = serve.main(["--arch", "hymba-1.5b", "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "16", "--gen", "3"])
    toks = res["tokens"]
    assert toks.shape == (2, 3)
    assert int(toks.min()) >= 0 and int(toks.max()) < res["cfg"].vocab_size
    # the same seed serves the same tokens
    again = serve.serve(tcfgs.smoke_config("hymba-1.5b"), batch=2,
                        prompt_len=16, gen=3, device="cpu", seed=0)
    assert torch.equal(again["tokens"], toks)


def test_serve_cli_runs_through_a_fresh_interpreter():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--arch", "mamba2-130m", "--smoke", "--device",
                          "cpu", "--gen", "2"], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "prefill:" in out.stdout and "tok/s" in out.stdout
