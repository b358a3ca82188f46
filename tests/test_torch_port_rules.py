"""Rules of the PyTorch port: ``repro_torch`` imports neither JAX nor
anything of the reference package (checked in a fresh interpreter that
imports every module, runs a small CPU grid, serves a smoke model and
trains one),
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
from repro_torch.core.vectorized import build
import numpy as np
spec = encode_graph(g)
static = build(spec, n_workers=4, cores=[2, 2, 2, 2], device="cpu")(
    np.zeros((2, spec.T), np.int32), np.ones(spec.T, np.float32))
assert static.ok.all() and static.makespan.shape == (2,)
from repro_torch.configs import smoke_config
from repro_torch.launch.serve import serve
out = serve(smoke_config("hymba-1.5b"), batch=1, prompt_len=8, gen=2,
            device="cpu")
assert out["tokens"].shape == (1, 2)
import torch
from repro_torch.models import init_params, make_train_step
from repro_torch.optim import AdamW
cfg = smoke_config("hymba-1.5b")
model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
opt = AdamW(lr=1e-3)
metrics = make_train_step(cfg, opt, accum=2, clip_norm=1.0)(
    model, opt.init(model), {"tokens": torch.randint(0, 128, (2, 8))})
assert torch.isfinite(metrics["loss"]) and metrics["grad_norm"] > 0
import tempfile
from repro_torch.launch.train import main as train_main
with tempfile.TemporaryDirectory() as d:
    losses = train_main(["--arch", "gemma3-1b", "--smoke", "--steps", "2",
                         "--batch", "2", "--seq", "8", "--ckpt-dir", d,
                         "--device", "cpu"])
assert len(losses) == 2
from repro_torch.configs import SHAPES, get_config
from repro_torch.planner import PipelinePlan, simulate_plan
rep = simulate_plan(get_config("qwen3-32b"), SHAPES["train_4k"],
                    PipelinePlan(n_stages=2, n_micro=4))
assert rep.makespan > 0
from repro_torch.core import Simulator, make_scheduler, resolve_workers
from repro_torch.survey import MINI_GRID, dataset_axis, time_reference_twin
rep = Simulator(g, resolve_workers([2, 2]), make_scheduler("ws")).run()
assert rep.makespan > 0
rep = Simulator(g, resolve_workers([2, 2]), make_scheduler(
    "genetic-vec", population=4, generations=1, device="cpu")).run()
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
                                             make_bucket_dynamic_simulator,
                                             make_bucket_simulator)
    from repro_torch.core.vectorized.specs import encode_graph
    g = random_graph(1, n_tasks=8)
    spec = encode_graph(g)
    with pytest.raises(RuntimeError, match="CUDA"):
        build(spec, n_workers=2, cores=4, scheduler="blevel", dynamic=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        build(spec, n_workers=2, cores=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_bucket_simulator(2, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_grid_runner([(g, spec)], "blevel", 2, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_bucket_dynamic_simulator(2, 4)
    # simlint: the step checks default to the card; the source rules
    # alone need none
    from repro_torch.analysis import check_all
    from repro_torch.analysis.__main__ import main as simlint
    with pytest.raises(RuntimeError, match="CUDA"):
        check_all()
    with pytest.raises(RuntimeError, match="CUDA"):
        simlint(["--no-ast"])
    assert simlint(["--no-jaxpr"]) == 0


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


def test_train_cli_raises_without_a_card():
    _needs_no_card()
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "hymba-1.5b", "--smoke", "--steps", "1"])
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--arch", "mamba2-130m", "--smoke", "--steps",
                          "1"], cwd=str(ROOT), env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "CUDA" in out.stderr and "final loss" not in out.stdout


def test_serve_cli_raises_without_a_card():
    _needs_no_card()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--arch", "hymba-1.5b", "--smoke"], cwd=str(ROOT),
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "CUDA" in out.stderr and "prefill:" not in out.stdout


def test_lm_options_not_ported_raise():
    """Every family of the registry and the int8 and ring caches
    construct and serve on the CPU, and every family's training loss
    builds (the audio and vision losses included)."""
    import torch

    from repro_torch.configs import (ARCH_NAMES, NOT_PORTED, get_config,
                                     smoke_config)
    from repro_torch.launch import serve
    from repro_torch.models import (decode_step, init_params, make_loss_fn,
                                    prefill)
    assert NOT_PORTED == () and len(ARCH_NAMES) == 10
    assert get_config("mixtral-8x22b").moe_experts == 8
    with pytest.raises(KeyError, match="unknown arch"):
        smoke_config("no-such-arch")
    runs = [(arch, {}) for arch in ARCH_NAMES]
    runs += [("gemma3-1b", dict(kv_cache_dtype="int8")),
             ("mixtral-8x22b", dict(moe_dispatch="gather"))]
    for arch, kw in runs:
        res = serve.serve(smoke_config(arch, **kw), batch=2, prompt_len=8,
                          gen=2, device="cpu")
        assert res["tokens"].shape[:2] == (2, 2), (arch, kw)
    # the ring: a window-sized cache that decode wraps
    res["model"].cfg = smoke_config("mixtral-8x22b", window_ring_cache=True)
    W = res["model"].cfg.window
    tokens = torch.zeros(2, W, dtype=torch.long)
    logits, cache, pos = prefill(res["model"], tokens, cache_len=W)
    for _ in range(3):
        logits, cache, pos = decode_step(res["model"], tokens[:, :1], cache,
                                         pos)
    assert pos == W + 3 and cache[0]["kv"]["k"].shape[1] == W
    assert torch.isfinite(logits).all()
    res = serve.main(["--arch", "gemma3-1b", "--smoke", "--device", "cpu",
                      "--kv-dtype", "int8", "--gen", "2"])
    assert res["cfg"].kv_cache_dtype == "int8"
    # every family's loss is ported: a finite loss on its smoke batch
    g = torch.Generator().manual_seed(0)
    for arch in ARCH_NAMES:
        cfg = smoke_config(arch)
        tokens, vision = serve.make_inputs(cfg, 2, 8, g, "cpu")
        batch = {"tokens": tokens}
        if vision is not None:
            batch["vision"] = vision
        model = init_params(cfg, g, device="cpu")
        loss = make_loss_fn(cfg)(model, batch)
        assert loss.shape == () and torch.isfinite(loss), arch


def test_chip_smoke_fails_without_a_card():
    _needs_no_card()
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=str(ROOT),
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_options_not_ported_raise():
    """The per-edge escape hatches are ported: ``build`` and
    ``make_grid_runner`` take ``flow_slots=False`` and ``frontier=False``
    and give the reference's results; the reference's own error (frontier
    on without slots on the dynamic max-min path) and the option checks
    still raise."""
    import jax
    from repro.core.vectorized import api as japi
    from repro.core.vectorized.specs import BucketedGraphSpec as JSpec
    from repro_torch.core.graphs import random_graph
    from repro_torch.core.imodes import encode_imode
    from repro_torch.core.vectorized import build, make_grid_runner
    from repro_torch.core.vectorized.specs import as_bucketed, encode_graph
    g = random_graph(2, n_tasks=8)
    spec = encode_graph(g)
    d, s = encode_imode(g, "exact")
    kw = dict(n_workers=2, cores=4, device="cpu")
    jspec = JSpec(**as_bucketed(spec).numpy())
    for opt in (dict(flow_slots=False), dict(frontier=False)):
        got = build(spec, scheduler="blevel", dynamic=True, **opt, **kw)(
            d, s, bandwidth=np.float32(64 * 1024 * 1024))
        want = jax.jit(japi.build(jspec, n_workers=2, cores=4,
                                  scheduler="blevel", dynamic=True, **opt))(
            d, s, bandwidth=np.float32(64 * 1024 * 1024))
        for f in ("ok", "overflow", "n_events", "n_steps"):
            assert np.array_equal(getattr(got, f).numpy(),
                                  np.asarray(getattr(want, f))), (opt, f)
        for f in ("makespan", "transferred"):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       np.asarray(getattr(want, f)),
                                       rtol=1e-5, err_msg=str(opt))
        res = make_grid_runner([(g, spec)], "blevel", 2, 4, device="cpu",
                               **opt)([dict(bandwidth=64 * 1024 * 1024)])
        assert res.makespan[0, 0, 0] == got.makespan.item(), opt
    with pytest.raises(ValueError, match="frontier=True requires"):
        build(spec, scheduler="blevel", dynamic=True, flow_slots=False,
              frontier=True, **kw)
    # the engine block is ported: it resolves, and the sharded runner
    # streams rows on one card
    from repro_torch.core.vectorized import (BucketedGridRunner,
                                             ShardedGridRunner)
    assert callable(build(spec, scheduler="blevel", dynamic=True,
                          engine="sharded", **kw))
    assert isinstance(make_grid_runner([(g, spec)], "blevel", 2, 4,
                                       device="cpu", engine="sharded"),
                      ShardedGridRunner)
    assert type(make_grid_runner([(g, spec)], "blevel", 2, 4, device="cpu",
                                 stream_rows=8)) is BucketedGridRunner
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
