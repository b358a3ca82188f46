"""Training the audio, vision and MoE families in the port against the
reference package on the CPU.

As ``tests/test_torch_train.py`` does for the text families: the
reference's parameters (``repro.models.init_params``) are carried across
with ``params_from_jax``, and the port's ``make_train_step`` with its
``AdamW`` (``clip_norm`` 1) must give the reference's
``jax.jit(make_train_step(...))`` loss and gradient norm at each of 2
steps, and its parameters and AdamW moments after them, within atol
1e-5 / rtol 1e-4.  The cases: musicgen's smoke config (tokens ``[B, S,
K]``, logits ``[B, S, K, V]``), llama-3.2-vision's (the vision stub's
``[B, T, d]`` input, every cross-attention gate set to 0.5 in the numpy
tree both packages start from: at the reference's initial gate of 0,
``tanh(0)`` gives the cross-attention weights a zero gradient), each at
accum 1 and 2 (the microbatch split of ``[B, S, K]`` tokens and of
``vision``), and mixtral's with the dense dispatch, the dense dispatch
with ``moe_fold_gates`` and the gather dispatch.  The gradient itself
equals ``jax.grad`` of the reference's loss, also for the gather
dispatch with dropped tokens and two token groups.  The trainer
(``launch/train.py --smoke --device cpu``) runs each family for 3 steps
and, restarted from its checkpoint at step 2, gives the uninterrupted
run's third loss.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro import models as jm  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.models import (make_loss_fn, make_train_step,  # noqa: E402
                                opt_state_to_jax, params_from_jax,
                                params_to_jax)
from repro_torch.optim import AdamW  # noqa: E402

BATCH, SEQ, STEPS = 4, 24, 2
OPT = dict(lr=1e-3, warmup_steps=1, weight_decay=0.01)
TOL = dict(atol=1e-5, rtol=1e-4)
GATE = 0.5

# name: (arch, config overrides, accum)
CASES = {
    "musicgen": ("musicgen-large", {}, 1),
    "musicgen-accum2": ("musicgen-large", {}, 2),
    "vision": ("llama-3.2-vision-11b", {}, 1),
    "vision-accum2": ("llama-3.2-vision-11b", {}, 2),
    "mixtral-dense": ("mixtral-8x22b", {}, 1),
    "mixtral-fold": ("mixtral-8x22b", dict(moe_fold_gates=True), 1),
    "mixtral-gather": ("mixtral-8x22b", dict(moe_dispatch="gather"), 1),
}

_JAX_RUNS = {}


def _tree0(arch, seed):
    """The reference's initial parameters as a numpy tree, every cross
    gate ``GATE``."""
    tree = jax.tree.map(np.array, jm.init_params(
        jcfgs.smoke_config(arch), jax.random.key(seed)))
    if "cross_blocks" in tree:
        tree["cross_blocks"]["attn"]["gate"][:] = GATE
    return tree


def _batches(cfg, seed, n, batch=BATCH, seq=SEQ):
    """``n`` numpy batches: tokens (``[B, S, K]`` for audio) and, for the
    vision family, the stub's float32 input."""
    rng = np.random.default_rng(seed)
    shape = (batch, seq) + ((cfg.codebooks,) if cfg.frontend == "audio"
                            else ())
    out = []
    for _ in range(n):
        b = {"tokens": rng.integers(0, cfg.vocab_size, shape,
                                    dtype=np.int32)}
        if cfg.frontend == "vision":
            b["vision"] = (rng.standard_normal(
                (batch, cfg.cross_tokens, cfg.d_model)) * 0.02).astype(
                np.float32)
        out.append(b)
    return out


def _to_torch(b):
    return {k: torch.as_tensor(v, dtype=torch.long if k == "tokens"
                               else None) for k, v in b.items()}


def _jax_run(case):
    """The reference's run of ``STEPS`` steps (cached per module): the
    initial tree, the batches, and per step the metrics, parameters and
    AdamW state after it."""
    if case not in _JAX_RUNS:
        arch, kw, accum = CASES[case]
        seed = list(CASES).index(case)
        cfg = jcfgs.smoke_config(arch, **kw)
        tree0 = _tree0(arch, seed)
        params = jax.tree.map(jnp.asarray, tree0)
        opt = joptim.AdamW(**OPT)
        state = opt.init(params)
        step = jax.jit(jm.make_train_step(cfg, opt, accum=accum,
                                          clip_norm=1.0))
        batches = _batches(cfg, seed, STEPS)
        after = []
        for b in batches:
            params, state, m = step(params, state,
                                    jax.tree.map(jnp.asarray, b))
            after.append(({k: float(v) for k, v in m.items()},
                          jax.tree.map(np.asarray, params),
                          jax.tree.map(np.asarray, state)))
        _JAX_RUNS[case] = (tree0, batches, after)
    return _JAX_RUNS[case]


def _assert_trees_close(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_close(got[k], want[k], f"{what}/{k}")
        else:
            np.testing.assert_allclose(got[k], want[k], **TOL,
                                       err_msg=f"{what}/{k}")


@pytest.mark.parametrize("case", list(CASES))
def test_train_steps_match_reference(case):
    arch, kw, accum = CASES[case]
    tree0, batches, after = _jax_run(case)
    cfg = tcfgs.smoke_config(arch, **kw)
    model = params_from_jax(tree0, cfg, device="cpu")
    opt = AdamW(**OPT)
    state = opt.init(model)
    step = make_train_step(cfg, opt, accum=accum, clip_norm=1.0)
    for i, b in enumerate(batches):
        m = step(model, state, _to_torch(b))
        want = after[i][0]
        assert float(m["loss"]) == pytest.approx(want["loss"], rel=1e-4,
                                                 abs=1e-5)
        assert float(m["grad_norm"]) == pytest.approx(
            want["grad_norm"], rel=1e-4, abs=1e-5)
        assert want["grad_norm"] > 0
    _, params, jstate = after[-1]
    _assert_trees_close(params_to_jax(model), params, case)
    back = opt_state_to_jax(state)
    np.testing.assert_array_equal(back["step"], jstate.step)
    _assert_trees_close(back["m"], jstate.m, f"{case} m")
    _assert_trees_close(back["v"], jstate.v, f"{case} v")


# name: (arch, config overrides, batch, seq)
GRAD_CASES = {
    "musicgen": ("musicgen-large", {}, BATCH, SEQ),
    "vision": ("llama-3.2-vision-11b", {}, BATCH, SEQ),
    "mixtral-dense": ("mixtral-8x22b", {}, BATCH, SEQ),
    "mixtral-fold": ("mixtral-8x22b", dict(moe_fold_gates=True), BATCH,
                     SEQ),
    "mixtral-gather": ("mixtral-8x22b", dict(moe_dispatch="gather"), BATCH,
                       SEQ),
    # two groups of Tg = 256 tokens: 512 (token, expert) pairs on 4
    # experts a group, each buffer 128 (64 rounded up to 128): tokens drop
    "mixtral-gather-drops-2groups": (
        "mixtral-8x22b", dict(moe_dispatch="gather", moe_capacity=0.5,
                              moe_groups=2), BATCH, 128),
}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_gradients_match_jax_grad(case):
    """Loss and every parameter's gradient against ``jax.grad`` of the
    reference's loss, from the same parameters and batch."""
    arch, kw, batch, seq = GRAD_CASES[case]
    jc = jcfgs.smoke_config(arch, **kw)
    seed = 10 + list(GRAD_CASES).index(case)
    tree = _tree0(arch, seed)
    b = _batches(jc, seed, 1, batch, seq)[0]
    loss, grads = jax.jit(jax.value_and_grad(jm.make_loss_fn(jc)))(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, b))
    cfg = tcfgs.smoke_config(arch, **kw)
    model = params_from_jax(tree, cfg, device="cpu")
    got_loss = make_loss_fn(cfg)(model, _to_torch(b))
    names, params = zip(*model.named_parameters())
    got = torch.autograd.grad(got_loss, params)
    assert float(got_loss.detach()) == pytest.approx(float(loss),
                                                     rel=1e-5)
    if case.startswith("mixtral-gather-drops"):
        with torch.no_grad():
            model.cfg = tcfgs.smoke_config(arch)
            dense = make_loss_fn(model.cfg)(model, _to_torch(b))
            model.cfg = cfg
        assert abs(float(dense) - float(got_loss.detach())) > 1e-6
    with torch.no_grad():
        for p, g in zip(params, got):
            p.copy_(g)
    want = jax.tree.map(np.asarray, grads)
    _assert_trees_close(params_to_jax(model), want, f"{case} grad")
    # every parameter takes part: the cross layers' too (gate 0.5)
    for n, g in zip(names, got):
        assert float(g.abs().max()) > 0, n


TRAIN_ARGS = ["--smoke", "--batch", "2", "--seq", "16", "--device", "cpu",
              "--log-every", "1"]


@pytest.mark.parametrize("arch", ["musicgen-large", "llama-3.2-vision-11b",
                                  "mixtral-8x22b"])
def test_trainer_restart_resumes_each_family(arch, tmp_path):
    """``launch/train.py`` for 3 steps, and a run checkpointed at step 2
    and restarted: it resumes at step 2 and its third loss is the
    uninterrupted run's, bit for bit (step-keyed data, the vision input
    keyed by the step too)."""
    from repro_torch.launch.train import run
    args = TRAIN_ARGS + ["--arch", arch]
    whole = run(args + ["--steps", "3"])
    ckpt = str(tmp_path / "ck")
    first = run(args + ["--steps", "2", "--ckpt-dir", ckpt,
                        "--ckpt-every", "100"])
    again = run(args + ["--steps", "3", "--ckpt-dir", ckpt])
    assert first["losses"] == whole["losses"][:2]
    assert again["start_step"] == 2 and len(again["losses"]) == 1
    assert again["losses"][0] == whole["losses"][2]
    assert np.isfinite(whole["losses"]).all()
    batch = whole["make_batch"](0)
    cfg = whole["cfg"]
    if cfg.frontend == "audio":
        assert batch["tokens"].shape == (2, 16, cfg.codebooks)
    if cfg.frontend == "vision":
        want = np.random.default_rng(0).standard_normal(
            (2, cfg.cross_tokens, cfg.d_model)).astype(np.float32) * 0.02
        assert batch["vision"].dtype == cfg.activation_dtype
        np.testing.assert_array_equal(batch["vision"].numpy(), want)


@pytest.mark.parametrize("arch,kw", [
    ("musicgen-large", {}),
    ("llama-3.2-vision-11b", {}),
    ("mixtral-8x22b", dict(moe_dispatch="gather")),
])
def test_remat_modes_give_one_loss_and_one_gradient(arch, kw):
    """remat ``full`` and ``dots`` recompute each layer (the cross layers
    with their ``tanh(gate)`` branch, the gather dispatch's index
    products) to the loss and gradient of remat ``none``."""
    jc = jcfgs.smoke_config(arch, **kw)
    tree = _tree0(arch, 3)
    b = _to_torch(_batches(jc, 3, 1)[0])
    runs = {}
    for remat in ("none", "full", "dots"):
        cfg = tcfgs.smoke_config(arch, remat=remat, **kw)
        model = params_from_jax(tree, cfg, device="cpu")
        loss = make_loss_fn(cfg)(model, b)
        names, params = zip(*model.named_parameters())
        runs[remat] = (float(loss.detach()), dict(zip(
            names, torch.autograd.grad(loss, params))))
    loss, grads = runs["none"]
    for r in ("full", "dots"):
        assert runs[r][0] == pytest.approx(loss, rel=1e-6)
        for n, g in grads.items():
            torch.testing.assert_close(runs[r][1][n], g, rtol=1e-6,
                                       atol=1e-9, msg=f"{r}: {n}")


def test_trainer_layers_cuts_the_depth():
    """``--layers`` cuts the config's depth; a vision model keeps whole
    groups of ``cross_attn_every`` layers."""
    from repro_torch.launch.train import run
    args = TRAIN_ARGS + ["--steps", "1"]
    res = run(args + ["--arch", "llama-3.2-vision-11b", "--layers", "2"])
    assert res["cfg"].n_layers == 2
    assert len(res["model"].layers) == len(res["model"].cross_layers) == 1
    res = run(args + ["--arch", "mixtral-8x22b", "--layers", "1"])
    assert len(res["model"].layers) == 1 and np.isfinite(res["losses"][0])
    with pytest.raises(ValueError, match="groups"):
        run(args + ["--arch", "llama-3.2-vision-11b", "--layers", "3"])
