"""Greedy's placement wrapper (``repro_torch.kernels.greedy_place``) on
the CPU: its plain route equals today's composition of
``bucket_transfer_costs`` and ``make_bucket_greedy_placer`` bit for bit,
adds the placer's loop length to its tally as the placer counts it, and
checks its inputs.  The kernel itself is held against
the plain route in ``tests/test_torch_cuda.py`` on inputs made by
``place_inputs`` below."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.graphs import make_graph  # noqa: E402
from repro_torch.core.vectorized import _spans  # noqa: E402
from repro_torch.core.vectorized.scheduling import (  # noqa: E402
    bucket_transfer_costs, edge_table, graph_view, make_bucket_greedy_placer)
from repro_torch.core.vectorized.specs import (  # noqa: E402
    encode_graph, pad_spec, stack_specs)
from repro_torch.kernels.greedy_place import greedy_place  # noqa: E402

# the benchmark's pegasus buckets: (graphs, bucket shape)
T160 = (("montage", "cybershake", "sipht"), (160, 160, 224))
T512 = (("epigenomics", "ligo"), (512, 320, 320))


def place_inputs(graphs, shape, R, W, seed, device="cpu", p_place=0.3,
                 ties=False, fit_none=False):
    """Seeded inputs of one placement, row r on graph ``r % len(graphs)``
    padded to ``shape``: ``(g, args)`` with ``args`` the wrapper's
    positional arguments (``tally`` at 0).  Every 7th row places
    nothing; the task with the most inputs places in every other row
    (unless ``p_place`` is 0).  ``ties``: sizes whole MiB of 0-3 and
    loads 0-2 (equal costs and loads); else sizes of any float.
    ``fit_none``: no worker has the cores of any task."""
    rng = np.random.default_rng(seed)
    specs = [pad_spec(encode_graph(make_graph(n, seed=0)), shape)
             for n in graphs]
    g = graph_view(stack_specs([specs[r % len(specs)] for r in range(R)])
                   .to(torch.device(device)))
    T, O = g.T, g.O
    table = edge_table(g).contiguous()
    placing = rng.random((R, T)) < p_place
    deg = (table >= 0).sum(dim=2).cpu().numpy()
    widest = deg.argmax(axis=1)
    if p_place > 0:
        placing[np.arange(0, R, 2), widest[::2]] = True
    placing[::7] = False
    placing = torch.as_tensor(placing, device=device) & g.task_valid
    if ties:
        sizes = rng.integers(0, 4, (R, O)).astype(np.float32) * 2 ** 20
        load0 = rng.integers(0, 3, (R, W))
    else:
        sizes = rng.lognormal(17, 2, (R, O)).astype(np.float32)
        load0 = rng.integers(0, 6, (R, W))
    size_now = torch.where(g.obj_valid,
                           torch.as_tensor(sizes, device=device), 0.0)
    missing = torch.as_tensor(rng.random((R, O, W)) < 0.6, device=device)
    cores = rng.integers(1, 5, (R, W))
    cores[1::3, -1] = 0                     # a padded worker in some rows
    if fit_none:
        cores[:] = 0
    args = (placing, table, g.e_obj.contiguous(), size_now, missing,
            g.cpus.contiguous(), torch.as_tensor(cores, device=device),
            torch.as_tensor(load0, device=device),
            torch.zeros(3, dtype=torch.int64, device=device))
    return g, args


def composed(g, args):
    """Today's composition: the whole ``[R, T, W]`` cost table, then the
    placer over the placing tasks."""
    placing, table, _, size_now, missing, _, cores, load0, _ = args
    before = _spans.GRAPH_EVENTS["place_iters"]
    cost = bucket_transfer_costs(g, size_now, missing, table)
    pw = make_bucket_greedy_placer(cores.shape[1], None)(
        g, placing, cost, load0, cores)
    return pw, _spans.GRAPH_EVENTS["place_iters"] - before


CASES = {
    "t160_w16": (T160, 36, 16, {}),
    "t512_w16": (T512, 24, 16, {}),
    "t160_w16_ties": (T160, 36, 16, dict(ties=True)),
    "t512_w40_stride": (T512, 12, 40, dict(ties=True)),
    "fit_none": (T160, 12, 8, dict(fit_none=True)),
    "nothing_placing": (T160, 12, 8, dict(p_place=0.0)),
}


@pytest.mark.parametrize("fresh", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_route_equals_costs_then_placer(case, fresh):
    """``fresh``: the tally starts at 0, else it holds an earlier step's
    count, which the call adds to."""
    (graphs, shape), R, W, kw = CASES[case]
    g, args = place_inputs(graphs, shape, R, W, seed=len(case), **kw)
    want, n = composed(g, args)
    tally = args[-1]
    before = 0 if fresh else 17
    tally[0] = before
    got = greedy_place(*args)
    assert torch.equal(got, want), case
    assert int(tally[0]) - before == n == int(args[0].sum(dim=1).amax())
    assert tally[1:].tolist() == [0, 0]
    assert ((got >= 0) == args[0]).all()
    if kw.get("p_place") == 0.0:
        assert n == 0 and (got == -1).all()


def test_plain_route_without_input_edges():
    """D 0: every cost is 0, so the placement is by load, then id."""
    (graphs, shape), R, W = T160, 8, 8
    g, args = place_inputs(graphs, shape, R, W, seed=5, ties=True)
    args = list(args)
    args[1] = args[1][:, :, :0].contiguous()
    got = greedy_place(*args)
    zero = torch.zeros_like(args[3])
    want, _ = composed(g, tuple(args[:3]) + (zero,) + tuple(args[4:]))
    assert torch.equal(got, want)


def test_wrapper_checks_its_inputs():
    (graphs, shape), R, W = T160, 4, 8
    _, args = place_inputs(graphs, shape, R, W, seed=1)
    bad = list(args)
    bad[7] = args[7][:, :-1]
    with pytest.raises(ValueError, match="load0"):
        greedy_place(*bad)
    bad = list(args)
    bad[8] = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="tally"):
        greedy_place(*bad)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no kernel"):
        greedy_place(*meta)
