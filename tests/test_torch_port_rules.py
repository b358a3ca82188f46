"""Rules of the PyTorch port: ``repro_torch`` imports neither JAX nor
anything of the reference package (checked in a fresh interpreter that
imports every module, runs a small CPU grid and serves a smoke model),
and its entry points default to CUDA — without a card they raise
instead of running on the CPU."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

CHILD = r"""
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
from repro_torch.core.graphs import random_graph
from repro_torch.core.vectorized import make_grid_runner
from repro_torch.core.vectorized.specs import encode_graph
g = random_graph(0, n_tasks=12, max_cpus=2)
runner = make_grid_runner([(g, encode_graph(g))], "greedy", 4, [2, 2, 2, 2],
                          device="cpu")
res = runner([dict(bandwidth=64 * 1024 * 1024, msd=0.1,
                   decision_delay=0.05, imode="user")])
assert res.ok.all() and res.makespan.shape == (1, 1, 1)
from repro_torch.configs import smoke_config
from repro_torch.launch.serve import serve
out = serve(smoke_config("hymba-1.5b"), batch=1, prompt_len=8, gen=2,
            device="cpu")
assert out["tokens"].shape == (1, 2)
from repro_torch.core import Simulator, make_scheduler, resolve_workers
from repro_torch.survey import MINI_GRID, dataset_axis, time_reference_twin
rep = Simulator(g, resolve_workers([2, 2]), make_scheduler("ws")).run()
assert rep.makespan > 0
reps, _ = time_reference_twin("sipht", "greedy", 2, [4, 4], [{}])
assert reps[0].makespan > 0
ds, items, edges = dataset_axis(dict(MINI_GRID, dataset="wfcommons-mini"))
assert edges == (128, 288) and len(items) == 6
from repro_torch.core.graphs import make_graph
assert make_graph("wf:tests/data/wfformat_golden.json").task_count == 7
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro.")
             or m == "benchmarks" or m.startswith("benchmarks."))
print("FORBIDDEN", bad)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_port_imports_no_jax_and_nothing_of_repro():
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=str(ROOT),
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "FORBIDDEN []" in out.stdout, out.stdout


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*PORT.rglob("*.py"),
                                       ROOT / "chip_smoke.py"]))
def test_sources_import_no_jax_and_nothing_of_repro(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "benchmarks"), \
                f"{path} imports {n}"


def _needs_no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card default cannot "
                    "be observed")


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    _needs_no_card()
    from repro_torch.core.graphs import random_graph
    from repro_torch.core.vectorized import (build, make_grid_runner,
                                             make_bucket_dynamic_simulator)
    from repro_torch.core.vectorized.specs import encode_graph
    g = random_graph(1, n_tasks=8)
    spec = encode_graph(g)
    with pytest.raises(RuntimeError, match="CUDA"):
        build(spec, n_workers=2, cores=4, scheduler="blevel", dynamic=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_grid_runner([(g, spec)], "blevel", 2, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_bucket_dynamic_simulator(2, 4)


def test_survey_cli_raises_without_a_card():
    _needs_no_card()
    out = subprocess.run([sys.executable, "-m", "repro_torch.survey",
                          "--mini"], cwd=str(ROOT), env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "CUDA" in out.stderr and "survey_torch[" not in out.stdout


def test_survey_dataset_cli_raises_without_a_card():
    _needs_no_card()
    out = subprocess.run([sys.executable, "-m", "repro_torch.survey",
                          "--mini", "--dataset", "wfcommons-mini"],
                         cwd=str(ROOT), env=_env(), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert "CUDA" in out.stderr and "survey_torch[" not in out.stdout


def test_lm_entry_points_default_to_cuda_and_raise_without_a_card():
    _needs_no_card()
    from repro_torch.configs import smoke_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import Transformer, init_params, params_from_jax
    cfg = smoke_config("mamba2-130m")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Transformer(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({}, cfg)


def test_serve_cli_raises_without_a_card():
    _needs_no_card()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--arch", "hymba-1.5b", "--smoke"], cwd=str(ROOT),
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "CUDA" in out.stderr and "prefill:" not in out.stdout


def test_lm_options_not_ported_raise():
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import Transformer
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config("mixtral-8x22b")
    with pytest.raises(KeyError, match="unknown arch"):
        smoke_config("no-such-arch")
    for kw in (dict(kv_cache_dtype="int8"), dict(window_ring_cache=True),
               dict(moe_experts=4), dict(cross_attn_every=2),
               dict(frontend="audio")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Transformer(smoke_config("hymba-1.5b", **kw), device="cpu")
    with pytest.raises(NotImplementedError, match="int8"):
        serve.main(["--arch", "gemma3-1b", "--smoke", "--device", "cpu",
                    "--kv-dtype", "int8"])


def test_chip_smoke_fails_without_a_card():
    _needs_no_card()
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=str(ROOT),
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_options_not_ported_raise():
    from repro_torch.core.graphs import random_graph
    from repro_torch.core.vectorized import build, make_grid_runner
    from repro_torch.core.vectorized.specs import encode_graph
    g = random_graph(2, n_tasks=8)
    spec = encode_graph(g)
    kw = dict(n_workers=2, cores=4, device="cpu")
    with pytest.raises(NotImplementedError, match="static simulator"):
        build(spec, **kw)
    with pytest.raises(NotImplementedError, match="engine"):
        build(spec, scheduler="blevel", dynamic=True, engine="sharded", **kw)
    with pytest.raises(NotImplementedError, match="engine"):
        make_grid_runner([(g, spec)], "blevel", 2, 4, device="cpu",
                         engine="sharded")
    with pytest.raises(TypeError, match="unknown option"):
        make_grid_runner([(g, spec)], "blevel", 2, 4, device="cpu",
                         stream_rows=8)
    with pytest.raises(NotImplementedError, match="escape hatch"):
        build(spec, scheduler="blevel", dynamic=True, frontier=False, **kw)
    with pytest.raises(TypeError, match="unknown option"):
        build(spec, scheduler="blevel", dynamic=True, no_such_option=1,
              **kw)
    with pytest.raises(ValueError, match="a task needs"):
        build(spec, n_workers=2, cores=0, scheduler="blevel", dynamic=True,
              device="cpu")


def test_static_schedule_front_door_runs_on_the_cpu():
    from repro_torch.core.graphs import random_graph
    from repro_torch.core.imodes import encode_imode
    from repro_torch.core.vectorized import build
    from repro_torch.core.vectorized.specs import encode_graph
    g = random_graph(3, n_tasks=10)
    d, s = encode_imode(g, "exact")
    sched = build(encode_graph(g), n_workers=3, cores=4, scheduler="etf",
                  device="cpu")
    aw, prio = sched(d, s, np.float32(1e8))
    assert aw.shape == (10,) and int(aw.min()) >= 0 and int(aw.max()) < 3
    assert sorted(prio.tolist()) == list(range(1, 11))
