"""Tests of the port that need an NVIDIA card: the CUDA waterfill kernel
against its plain PyTorch version, its launch counter and its checks,
and the simulator through the kernel against the plain version.  They
are marked ``cuda`` and skip when no card is present; on a card run
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    return torch.device("cuda")


def flow_sets(seed, R, W, F, device):
    rng = np.random.default_rng(seed)
    out = (rng.integers(0, W, (R, F)).astype(np.int32),
           rng.integers(0, W, (R, F)).astype(np.int32),
           rng.random((R, F)) < 0.6,
           rng.uniform(50, 150, (R, W)).astype(np.float32))
    return [torch.as_tensor(x, device=device) for x in out]


@pytest.mark.parametrize("W", [1, 8, 32, 256])
def test_kernel_equals_plain_version_bitwise(dev, W):
    from repro_torch.core.vectorized.waterfill import waterfill as plain
    from repro_torch.kernels.waterfill import waterfill
    src, dst, active, caps = flow_sets(W, 512, W, 4 * W, dev)
    got = waterfill(src, dst, active, caps, caps)
    want = plain(src, dst, active, caps, caps)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_kernel_counts_launches_and_checks_inputs(dev):
    from repro_torch.kernels import WATERFILL_LAUNCHES
    from repro_torch.kernels.waterfill import waterfill
    src, dst, active, caps = flow_sets(1, 8, 4, 16, dev)
    before = WATERFILL_LAUNCHES.count
    waterfill(src, dst, active, caps, caps)
    assert WATERFILL_LAUNCHES.count == before + 1
    with pytest.raises(TypeError, match="int32"):
        waterfill(src.long(), dst, active, caps, caps)
    with pytest.raises(ValueError, match="exceeds"):
        big = flow_sets(2, 2, 4, 2048, dev)
        waterfill(big[0], big[1], big[2], big[3], big[3])


def test_simulator_through_the_kernel_equals_the_plain_version(dev):
    from repro_torch.core import MiB
    from repro_torch.core.graphs import encode_graph_batch, survey_names
    from repro_torch.core.vectorized import make_grid_runner
    encoded, groups = encode_graph_batch(survey_names(1), bucket=True)
    grp = groups[0]
    points = [dict(bandwidth=32 * MiB, imode="user", msd=0.1,
                   decision_delay=0.05)]
    out = {}
    for impl in ("auto", "torch"):
        runner = make_grid_runner([encoded[n] for n in grp.names],
                                  "greedy", 8, [4] * 8, shape=grp.shape,
                                  batch=grp.batch, device=dev,
                                  waterfill_impl=impl)
        out[impl] = runner(points)
    for f in out["auto"]._fields:
        assert np.array_equal(getattr(out["auto"], f),
                              getattr(out["torch"], f)), f
