"""The port's ``genetic-vec`` against the reference package's on the
CPU: ``fastcrossv`` on 4x4.  The genetic algorithm is the reference's
own code, so the two pick the same schedule exactly when every fitness
(a makespan of the static simulator) is bitwise equal: the fitness of
one population (bitwise), the chosen assignment and the report's
makespan (equal), and the reference's own check that the algorithm
beats the mean random schedule."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
from repro.core.graphs import make_graph as j_make_graph  # noqa: E402
from repro.core.vectorized import build as j_build  # noqa: E402
from repro.core.vectorized import encode_graph as j_encode  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.core.graphs import make_graph  # noqa: E402
from repro_torch.core.vectorized import build, encode_graph  # noqa: E402

BW = 100 * 1024 * 1024


@pytest.mark.parametrize("netmodel", ["maxmin", "simple"])
def test_population_fitness_is_bitwise_the_reference(netmodel):
    """One population of 8 chromosomes in one batched call: the same
    makespans as the reference's ``jax.vmap`` over the population."""
    g = make_graph("fastcrossv", seed=0)
    spec = encode_graph(g)
    rng = np.random.default_rng(0)
    pop = rng.integers(0, 4, (8, spec.T)).astype(np.int32)
    prio = rng.uniform(1, 100, spec.T).astype(np.float32)
    cores = np.full(4, 4, np.int32)
    got = build(spec, n_workers=4, cores=cores, netmodel=netmodel,
                device="cpu")(pop, prio, bandwidth=np.float32(BW))
    run = j_build(j_encode(j_make_graph("fastcrossv", seed=0)),
                  n_workers=4, cores=cores, netmodel=netmodel)
    want = jax.jit(jax.vmap(lambda a: run(a, jnp.asarray(prio),
                                          bandwidth=jnp.float32(BW))[0]))(
        jnp.asarray(pop))
    assert got.makespan.shape == (8,)
    assert np.array_equal(got.makespan.numpy(), np.asarray(want))


def _run(pkg, graph, **kw):
    sched = pkg.make_scheduler("genetic-vec", seed=0, population=8,
                               generations=2, **kw)
    rep = pkg.run_single_simulation(graph, 4, 4, sched)
    return rep.makespan, [rep.task_records[t].worker for t in graph.tasks]


@pytest.mark.parametrize("netmodel", ["maxmin", "simple"])
def test_genetic_vec_picks_the_reference_schedule(netmodel):
    want = _run(J, j_make_graph("fastcrossv", seed=0), netmodel=netmodel)
    got = _run(P, make_graph("fastcrossv", seed=0), netmodel=netmodel,
               device="cpu")
    assert got == want


def test_genetic_vec_defaults_to_cuda():
    sched = P.make_scheduler("genetic-vec")
    assert sched.device == "cuda" and sched.waterfill_impl == "auto"
    if not torch.cuda.is_available():
        g = make_graph("fastcrossv", seed=0)
        with pytest.raises(RuntimeError, match="no CUDA card"):
            P.run_single_simulation(g, 4, 4, sched)


def test_genetic_vectorized_improves_on_random():
    """The reference's ``test_genetic_vectorized_improves_on_random``:
    exact batched max-min fitness beats the mean random schedule on a
    transfer-heavy graph."""
    g = make_graph("fastcrossv", seed=0)
    sched = P.make_scheduler("genetic-vec", seed=0, population=12,
                             generations=4, device="cpu")
    rep = P.run_single_simulation(g, 4, 4, sched)
    rand = [P.run_single_simulation(
        g, 4, 4, P.make_scheduler("random", seed=s)).makespan
        for s in range(3)]
    assert rep.makespan <= sum(rand) / len(rand) * 1.05
