"""The plain versions of K3's three phases against the reference package
on the CPU.

``ssd_chunk_states`` -> ``ssd_pass_states`` -> ``ssd_chunk_scan`` (the
pieces the three CUDA kernels of ``csrc/ssd.cu`` are held against on the
card) composed give ``ssd_chunked``'s ``y`` and the sequential final
state:

* against the port's ``ssd_chunked`` and the reference's
  ``ssd_chunked`` at atol/rtol 1e-4 (float32 sums in another order);
* against the reference's Pallas ``ssd_scan`` in interpret mode at atol
  5e-4, rtol 5e-5, as ``tests/test_torch_lm_kernels.py`` and the
  reference's own kernel tests hold it;
* the final state against ``ref.ssd_final_state`` and the reference's
  sequential ``_final_state`` at 1e-4.

The per-phase wrappers of ``kernels/ssd.py`` on CPU tensors are these
pieces.  Inputs are made with numpy from a seed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd import ssd_scan as jssd_scan  # noqa: E402
from repro.models.ssm import _final_state as jfinal_state  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ssd as sk  # noqa: E402

# Bt, L, H, P, N, chunk
CASES = {
    "single_chunk": (2, 64, 3, 16, 8, 64),       # L == Q
    "several_chunks": (2, 256, 4, 32, 16, 64),
    "n128": (1, 128, 2, 16, 128, 64),
    "p16_chunk32": (2, 96, 5, 16, 16, 32),
    "odd_q9_p10_n6": (1, 36, 3, 10, 6, 9),       # Q, P, N off the tiles
}
PALLAS = ("single_chunk", "several_chunks", "p16_chunk32")


def _inputs(seed, Bt, L, H, P, N):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((Bt, L, H, P)).astype(np.float32),
            rng.uniform(0.001, 0.1, (Bt, L, H)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (H,)).astype(np.float32),
            rng.standard_normal((Bt, L, N)).astype(np.float32),
            rng.standard_normal((Bt, L, N)).astype(np.float32),
            rng.standard_normal((H,)).astype(np.float32))


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _phases(x, dt, A, B, C, D, chunk):
    """(y, final state) by the three plain pieces."""
    S, total = ref.ssd_chunk_states(x, dt, A, B, chunk=chunk)
    h_in, final = ref.ssd_pass_states(S, total)
    return ref.ssd_chunk_scan(x, dt, A, B, C, D, h_in, chunk=chunk), final


@pytest.mark.parametrize("name", list(CASES))
def test_phases_compose_to_ssd_chunked(name):
    Bt, L, H, P, N, chunk = CASES[name]
    args = _t(*_inputs(L + N, Bt, L, H, P, N))
    y, final = _phases(*args, chunk)
    np.testing.assert_allclose(
        y.numpy(), ref.ssd_chunked(*args, chunk=chunk).numpy(), atol=1e-4,
        rtol=1e-4)
    np.testing.assert_allclose(
        final.numpy(), ref.ssd_final_state(*args[:4]).numpy(), atol=1e-4,
        rtol=1e-4)


@pytest.mark.parametrize("name", list(CASES))
def test_phases_match_the_reference(name):
    Bt, L, H, P, N, chunk = CASES[name]
    arrays = _inputs(3 * L + H, Bt, L, H, P, N)
    y, final = _phases(*_t(*arrays), chunk)
    want = jref.ssd_chunked(*map(jnp.asarray, arrays), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    want_state = jfinal_state(*map(jnp.asarray, arrays[:4]))
    np.testing.assert_allclose(final.numpy(), np.asarray(want_state),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", PALLAS)
def test_phases_match_pallas_interpret(name):
    Bt, L, H, P, N, chunk = CASES[name]
    arrays = _inputs(L * H, Bt, L, H, P, N)
    want = jssd_scan(*map(jnp.asarray, arrays), blk_l=chunk, interpret=True)
    y, _ = _phases(*_t(*arrays), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=5e-4,
                               rtol=5e-5)


def test_phases_survive_a_decay_that_overflows_above_the_diagonal():
    # exp(cum_i - cum_j) overflows for j > i; exp(cum) underflows to 0
    x, dt, A, B, C, D = _inputs(5, 1, 32, 2, 8, 4)
    dt = np.full_like(dt, 8.0)
    A = np.full_like(A, -2.0)
    args = _t(x, dt, A, B, C, D)
    y, final = _phases(*args, 32)
    assert torch.isfinite(y).all() and torch.isfinite(final).all()
    np.testing.assert_allclose(y.numpy(), ref.ssd_ref(*args).numpy(),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(
        final.numpy(), ref.ssd_final_state(*args[:4]).numpy(), atol=1e-4,
        rtol=1e-4)


def test_phase_outputs_have_the_kernels_shapes():
    Bt, L, H, P, N, chunk = CASES["p16_chunk32"]
    x, dt, A, B, C, D = _t(*_inputs(1, Bt, L, H, P, N))
    S, total = ref.ssd_chunk_states(x, dt, A, B, chunk=chunk)
    nc = L // chunk
    assert S.shape == (Bt, nc, H, N, P) and total.shape == (Bt, nc, H)
    h_in, final = ref.ssd_pass_states(S, total)
    assert h_in.shape == S.shape and final.shape == (Bt, H, N, P)
    # nothing enters the first chunk; the second receives the first's S
    assert torch.equal(h_in[:, 0], torch.zeros_like(h_in[:, 0]))
    torch.testing.assert_close(h_in[:, 1], S[:, 0])
    assert S.dtype == total.dtype == h_in.dtype == torch.float32


def test_phase_wrappers_on_cpu_tensors_are_the_plain_pieces():
    Bt, L, H, P, N, chunk = CASES["several_chunks"]
    x, dt, A, B, C, D = _t(*_inputs(2, Bt, L, H, P, N))
    S, total = sk.chunk_states(x, dt, A, B, chunk=chunk)
    S0, total0 = ref.ssd_chunk_states(x, dt, A, B, chunk=chunk)
    assert torch.equal(S, S0) and torch.equal(total, total0)
    h_in, final = sk.pass_states(S, total)
    h0, f0 = ref.ssd_pass_states(S0, total0)
    assert torch.equal(h_in, h0) and torch.equal(final, f0)
    y = sk.chunk_scan(x, dt, A, B, C, D, h_in, chunk=chunk)
    assert torch.equal(y, ref.ssd_chunk_scan(x, dt, A, B, C, D, h0,
                                             chunk=chunk))


def test_phase_wrappers_check_their_inputs():
    Bt, L, H, P, N, chunk = CASES["several_chunks"]
    x, dt, A, B, C, D = _t(*_inputs(3, Bt, L, H, P, N))
    S, total = sk.chunk_states(x, dt, A, B, chunk=chunk)
    with pytest.raises(ValueError, match="disagree"):
        sk.pass_states(S, total[:, :1])
    with pytest.raises(ValueError, match="does not fit"):
        sk.chunk_scan(x, dt, A, B, C, D, S[:, :1], chunk=chunk)
    with pytest.raises(ValueError, match="multiple"):
        sk.chunk_states(x[:, :100], dt[:, :100], A, B[:, :100], chunk=64)
    with pytest.raises(ValueError, match="no kernel"):
        sk.chunk_states(*(t.to("meta") for t in (x, dt, A, B)),
                        chunk=chunk)


def test_tune_variants_apply_to_the_kernel_source():
    # every variant of tune_ssd is text substitutions on csrc/ssd.cu;
    # each must still find its text in the committed source
    from repro_torch.kernels import _build, tune_ssd
    src = (_build.CSRC / "ssd.cu").read_text()
    for name, (_, subs) in tune_ssd.VARIANTS.items():
        for old, _ in subs:
            assert old in src, (name, old)
