"""The port's LM training path against the reference package on the CPU.

The reference's parameters (``repro.models.init_params``) are carried
across with ``params_from_jax``; the port's ``make_train_step`` with its
``AdamW`` must give the reference's ``jax.jit(make_train_step(...))``
loss, gradient norm and parameters after each step (float32 smoke
configs of hymba-1.5b, mamba2-130m and gemma3-1b; atol 1e-5 / rtol 1e-4,
the width of float32 sums taken in another order through two optimizer
steps), for accum 1 and 2 and with bf16 gradient compression; the
AdamW state carried across gives the reference's third step.  Both
sides run their plain paths (the reference's ``use_pallas=False``).
The port's remat modes give one loss and one gradient, and the
``torch.autograd.Function``s of K2 and K3, their forward handed the
plain version, give autograd's gradients through the plain version.
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
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import _FlashAttentionFn  # noqa: E402
from repro_torch.kernels.ssd import _SSDScanFn  # noqa: E402
from repro_torch.models import (make_loss_fn, make_train_step,  # noqa: E402
                                opt_state_from_jax, opt_state_to_jax,
                                params_from_jax, params_to_jax)
from repro_torch.optim import AdamW, clip_by_global_norm, \
    global_norm  # noqa: E402

ARCHS = ["hymba-1.5b", "mamba2-130m", "gemma3-1b"]
BATCH, SEQ, STEPS = 4, 24, 2
OPT = dict(lr=1e-3, warmup_steps=1, weight_decay=0.01)
TOL = dict(atol=1e-5, rtol=1e-4)

_JAX_RUNS = {}


def _batches(cfg, seed, n):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (BATCH, SEQ), dtype=np.int32)
            for _ in range(n)]


def _jax_run(arch, accum, compress):
    """The reference's run of STEPS + 1 steps (cached per module): the
    initial parameters, the batches, and per step the metrics, the
    parameters and the AdamW state after it."""
    key = (arch, accum, compress)
    if key not in _JAX_RUNS:
        cfg = jcfgs.smoke_config(arch)
        seed = ARCHS.index(arch)
        params = jm.init_params(cfg, jax.random.key(seed))
        tree0 = jax.tree.map(np.asarray, params)
        opt = joptim.AdamW(**OPT)
        state = opt.init(params)
        step = jax.jit(jm.make_train_step(cfg, opt, accum=accum,
                                          clip_norm=1.0,
                                          grad_compress=compress))
        batches = _batches(cfg, seed, STEPS + 1)
        after = []
        for b in batches:
            params, state, m = step(params, state,
                                    {"tokens": jnp.asarray(b)})
            after.append(({k: float(v) for k, v in m.items()},
                          jax.tree.map(np.asarray, params),
                          jax.tree.map(np.asarray, state)))
        _JAX_RUNS[key] = (tree0, batches, after)
    return _JAX_RUNS[key]


def _torch_steps(arch, tree, batches, accum, compress, state=None):
    cfg = tcfgs.smoke_config(arch)
    model = params_from_jax(tree, cfg, device="cpu")
    opt = AdamW(**OPT)
    if state is None:
        state = opt.init(model)
    step = make_train_step(cfg, opt, accum=accum, clip_norm=1.0,
                           grad_compress=compress)
    metrics = []
    for b in batches:
        m = step(model, state, {"tokens": torch.as_tensor(b,
                                                          dtype=torch.long)})
        metrics.append({k: float(v) for k, v in m.items()})
    return model, state, metrics


def _assert_trees_close(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_close(got[k], want[k], f"{what}/{k}")
        else:
            np.testing.assert_allclose(got[k], want[k], **TOL,
                                       err_msg=f"{what}/{k}")


def _check_steps(arch, accum, compress):
    """Loss and grad norm of each step and the parameters after STEPS
    steps within TOL; returns the port's and the reference's parameters
    after STEPS steps."""
    tree0, batches, after = _jax_run(arch, accum, compress)
    model, _, metrics = _torch_steps(arch, tree0, batches[:STEPS], accum,
                                     compress)
    for i, m in enumerate(metrics):
        want = after[i][0]
        assert m["loss"] == pytest.approx(want["loss"], rel=1e-4, abs=1e-5)
        assert m["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-4,
                                               abs=1e-5)
    return params_to_jax(model), after[STEPS - 1][1]


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch, accum):
    got, want = _check_steps(arch, accum, compress=False)
    _assert_trees_close(got, want, f"{arch} accum {accum}")


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_with_grad_compression_match_reference(accum):
    """bf16 gradient compression.  Loss and grad norm as above, and the
    parameters within TOL after each step, with one exception at accum
    2.  There, microbatch gradients that cancel in the sum turn a
    bfloat16 rounding that went the other way (float32 sums taken in
    another order land on the other side of a rounding boundary) into a
    visible change of a small accumulated gradient, which AdamW's second
    step divides by its small ``sqrt(v)`` (the first step only takes its
    sign).  Two of the 208,376 elements lie beyond TOL after step 2
    (mlp w1 by 3.9e-05, ssm in_proj by 1.2e-05): at most 8 may, and no
    element may be further than 1e-4 from the reference's."""
    arch = "hymba-1.5b"
    tree0, batches, after = _jax_run(arch, accum, True)
    model, _, _ = _torch_steps(arch, tree0, batches[:1], accum, True)
    _assert_trees_close(params_to_jax(model), after[0][1],
                        f"{arch} accum {accum} step 1")
    got, want = _check_steps(arch, accum, compress=True)
    if accum == 1:
        _assert_trees_close(got, want, f"{arch} accum 1")
        return
    beyond = 0
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        err = np.abs(g - w)
        assert err.max() <= 1e-4
        beyond += int((err > TOL["atol"] + TOL["rtol"] * np.abs(w)).sum())
    assert beyond <= 8


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_state_carried_across_gives_the_reference_step(arch):
    """The reference's parameters and AdamW state after step 2 carried
    into the port give the reference's step-3 parameters; the port's
    state carried back equals the reference's."""
    tree0, batches, after = _jax_run(arch, 1, False)
    _, params2, state2 = after[STEPS - 1]
    cfg = tcfgs.smoke_config(arch)
    state = opt_state_from_jax(state2, cfg, device="cpu")
    assert int(state.step) == STEPS
    back = opt_state_to_jax(state)
    np.testing.assert_array_equal(back["step"], state2.step)
    _assert_trees_close(back["m"], state2.m, "m")
    _assert_trees_close(back["v"], state2.v, "v")
    model, state, metrics = _torch_steps(arch, params2, batches[STEPS:], 1,
                                         False, state=state)
    assert metrics[0]["loss"] == pytest.approx(after[STEPS][0]["loss"],
                                               rel=1e-4, abs=1e-5)
    assert int(state.step) == STEPS + 1
    _assert_trees_close(params_to_jax(model), after[STEPS][1],
                        f"{arch} step 3")


def test_params_to_jax_inverts_params_from_jax():
    for arch, dtype in (("hymba-1.5b", "bfloat16"), ("gemma3-1b",
                                                     "float32")):
        cfg = jcfgs.smoke_config(arch, dtype=dtype)
        tree = jax.tree.map(np.asarray, jm.init_params(cfg,
                                                       jax.random.key(5)))
        model = params_from_jax(tree, tcfgs.smoke_config(arch, dtype=dtype),
                                device="cpu")
        back = params_to_jax(model)

        def bits(a):
            a = np.asarray(a)
            return a.view(np.uint16) if a.dtype.name == "bfloat16" else a
        got = jax.tree.map(bits, back)
        want = jax.tree.map(bits, tree)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        again = params_from_jax(back, model.cfg, device="cpu")
        for (n, p), (_, q) in zip(model.named_parameters(),
                                  again.named_parameters()):
            assert torch.equal(p, q), n


def _loss_and_grads(cfg, tree, tokens):
    model = params_from_jax(tree, cfg, device="cpu")
    loss = make_loss_fn(cfg)(model, {"tokens": tokens})
    names, params = zip(*model.named_parameters())
    return float(loss.detach()), dict(zip(names,
                                        torch.autograd.grad(loss, params)))


@pytest.mark.parametrize("arch", ["hymba-1.5b", "gemma3-1b"])
def test_remat_modes_give_one_loss_and_one_gradient(arch):
    jc = jcfgs.smoke_config(arch)
    tree = jax.tree.map(np.asarray, jm.init_params(jc, jax.random.key(2)))
    tokens = torch.as_tensor(_batches(jc, 2, 1)[0], dtype=torch.long)
    runs = {r: _loss_and_grads(tcfgs.smoke_config(arch, remat=r), tree,
                               tokens) for r in ("none", "full", "dots")}
    loss, grads = runs["none"]
    for r in ("full", "dots"):
        assert runs[r][0] == pytest.approx(loss, rel=1e-6)
        for n, g in grads.items():
            torch.testing.assert_close(runs[r][1][n], g, rtol=1e-6,
                                       atol=1e-9, msg=f"{r}: {n}")
    with pytest.raises(ValueError, match="remat"):
        _loss_and_grads(tcfgs.smoke_config(arch, remat="some"), tree,
                        tokens)


def test_loss_and_gradients_match_reference():
    """The gradient itself (not only the step it makes) equals
    ``jax.grad`` of the reference's loss, hymba smoke."""
    jc = jcfgs.smoke_config("hymba-1.5b")
    params = jm.init_params(jc, jax.random.key(9))
    tree = jax.tree.map(np.asarray, params)
    tokens = _batches(jc, 9, 1)[0]
    loss, grads = jax.jit(jax.value_and_grad(jm.make_loss_fn(jc)))(
        params, {"tokens": jnp.asarray(tokens)})
    cfg = tcfgs.smoke_config("hymba-1.5b")
    got_loss, got = _loss_and_grads(cfg, tree,
                                    torch.as_tensor(tokens,
                                                    dtype=torch.long))
    assert got_loss == pytest.approx(float(loss), rel=1e-5)
    model = params_from_jax(tree, cfg, device="cpu")
    for (n, p), g in zip(model.named_parameters(), got.values()):
        p.data.copy_(g)
    _assert_trees_close(params_to_jax(model),
                        jax.tree.map(np.asarray, grads), "grad")


def test_adamw_and_clipping_match_reference():
    """One AdamW update of a toy tree, with warmup, cosine decay and
    weight decay, and the global-norm clip, equal the reference's."""
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((5, 3)).astype(np.float32),
            "b": rng.standard_normal(7).astype(np.float32)}
    g = {k: rng.standard_normal(v.shape).astype(np.float32) * 3
         for k, v in tree.items()}
    kw = dict(lr=1e-2, warmup_steps=3, decay_steps=10, weight_decay=0.1)
    jopt = joptim.AdamW(**kw)
    jp = {k: jnp.asarray(v) for k, v in tree.items()}
    js = jopt.init(jp)

    class Toy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for k, v in tree.items():
                setattr(self, k, torch.nn.Parameter(torch.as_tensor(v)))
    model = Toy()
    opt = AdamW(**kw)
    state = opt.init(model)
    for step in range(12):
        jg = {k: jnp.asarray(v * (step + 1)) for k, v in g.items()}
        jg, jn = joptim.clip_by_global_norm(jg, 1.0)
        jp, js = jopt.update(jg, js, jp)
        tg = {k: torch.as_tensor(v * (step + 1)) for k, v in g.items()}
        tg, tn = clip_by_global_norm(tg, 1.0)
        assert float(tn) == pytest.approx(float(jn), rel=1e-6)
        opt.update(tg, state, model)
        assert float(opt.schedule(step)) == pytest.approx(
            float(jopt.schedule(jnp.int32(step))), rel=1e-6)
        for k in tree:
            np.testing.assert_allclose(getattr(model, k).detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7)
    assert float(global_norm(tg)) == pytest.approx(
        float(joptim.global_norm(jg)), rel=1e-6)


# --------------------------------------------- K2 / K3 autograd wiring
ATTN_CASES = [  # B, Hq, Hkv, Sq, Skv, D, causal, window, kv_len, dtype
    (2, 4, 2, 24, 24, 16, True, 8, None, "float32"),
    (1, 6, 1, 16, 20, 32, True, 0, 18, "float32"),
    (2, 4, 4, 12, 12, 16, False, 0, None, "float32"),
    (2, 4, 2, 24, 24, 16, True, 8, None, "bfloat16"),
    # cross-attention: non-causal, no kv_len, Sq > Skv and Sq < Skv
    (2, 4, 2, 24, 16, 16, False, 0, None, "float32"),
    (2, 4, 2, 12, 20, 16, False, 0, None, "float32"),
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_function_gives_the_plain_gradients(case):
    B, Hq, Hkv, Sq, Skv, D, causal, window, kv_len, dtype = case
    g = torch.Generator().manual_seed(Sq + Hq)
    dt = getattr(torch, dtype)
    q = torch.randn(B, Hq, Sq, D, generator=g).to(dt)
    k, v = (torch.randn(B, Hkv, Skv, D, generator=g).to(dt)
            for _ in range(2))
    gout = torch.randn(B, Hq, Sq, D, generator=g).to(dt)
    kw = dict(causal=causal, window=window, kv_len=kv_len)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = _FlashAttentionFn.apply(*leaves, causal, window, None, kv_len,
                                  ref.attention_ref)
    got = torch.autograd.grad(out, leaves, gout)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want_out = ref.attention_ref(*plain, **kw)
    want = torch.autograd.grad(want_out, plain, gout)
    assert torch.equal(out, want_out)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == dt, name
        assert torch.equal(a, b), name
    # only the inputs that ask for a gradient get one
    qa = q.clone().requires_grad_()
    out = _FlashAttentionFn.apply(qa, k, v, causal, window, None, kv_len,
                                  ref.attention_ref)
    (gq,) = torch.autograd.grad(out, [qa], gout)
    assert torch.equal(gq, want[0])


@pytest.mark.parametrize("with_D", [True, False])
def test_ssd_function_gives_the_plain_gradients(with_D):
    g = torch.Generator().manual_seed(3)
    Bt, L, H, P, N, chunk = 2, 32, 3, 8, 4, 8
    x = torch.randn(Bt, L, H, P, generator=g)
    dt = 0.01 + 0.1 * torch.rand(Bt, L, H, generator=g)
    A = -(0.5 + torch.rand(H, generator=g))
    B, C = (torch.randn(Bt, L, N, generator=g) for _ in range(2))
    D = torch.randn(H, generator=g) if with_D else None
    gy = torch.randn(Bt, L, H, P, generator=g)
    inputs = [x, dt, A, B, C, D]

    def leaves():
        return [None if t is None else t.clone().requires_grad_()
                for t in inputs]
    mine = leaves()
    y = _SSDScanFn.apply(*mine, chunk, ref.ssd_chunked)
    got = torch.autograd.grad(y, [t for t in mine if t is not None], gy)
    plain = leaves()
    want_y = ref.ssd_chunked(*plain, chunk=chunk)
    want = torch.autograd.grad(want_y, [t for t in plain if t is not None],
                               gy)
    assert torch.equal(y, want_y)
    assert len(got) == (6 if with_D else 5)
    for name, a, b in zip("x dt A B C D".split(), got, want):
        assert a.dtype == torch.float32, name
        assert torch.equal(a, b), name


def test_ops_keep_the_plain_path_on_the_cpu_and_refuse_a_prefill_gradient():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 16, 2, 4, generator=g, requires_grad=True)
    dt = 0.05 * torch.rand(1, 16, 2, generator=g)
    A = -torch.ones(2)
    B, C = (torch.randn(1, 16, 3, generator=g) for _ in range(2))
    y = ops.ssd(x, dt, A, B, C, None, chunk=8)
    assert y.grad_fn is not None and "SSDScanFn" not in type(
        y.grad_fn).__name__
    with pytest.raises(RuntimeError, match="no gradient"):
        ops.ssd(x, dt, A, B, C, None, chunk=8, return_state=True)
    with torch.no_grad():
        y2, state = ops.ssd(x, dt, A, B, C, None, chunk=8,
                            return_state=True)
    assert torch.equal(y2, y.detach()) and state.shape == (1, 2, 3, 4)


def test_serving_takes_no_gradient():
    from repro_torch.models import decode_step, init_params, prefill
    cfg = tcfgs.smoke_config("hymba-1.5b")
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(p.requires_grad for p in model.parameters())
    toks = torch.randint(0, cfg.vocab_size, (2, 9),
                         generator=torch.Generator().manual_seed(1))
    lg, cache, pos = prefill(model, toks[:, :8], cache_len=9)
    assert not lg.requires_grad
    lg, cache, pos = decode_step(model, toks[:, 8:], cache, pos)
    assert not lg.requires_grad and pos == 9
