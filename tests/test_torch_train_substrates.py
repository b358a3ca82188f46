"""The port's training substrates against the reference package on the
CPU: the step-keyed token pipeline (bitwise, also host-sharded, with
codebooks and from a token file), checkpoints (round trip, keep-N, no
``tmp.*`` left, files written by either package restored by the other,
bit for bit), and the trainer's restart and SIGTERM checkpoint."""
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro import configs as jcfgs  # noqa: E402
from repro import data as jdata  # noqa: E402
from repro import models as jm  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.data import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.models import (init_params, opt_state_to_jax,  # noqa: E402
                                params_to_jax)
from repro_torch.optim import AdamW  # noqa: E402


@pytest.mark.parametrize("kw", [
    dict(vocab_size=100, seq_len=16, global_batch=8, seed=3),
    dict(vocab_size=32001, seq_len=64, global_batch=4, seed=0),
    dict(vocab_size=64, seq_len=8, global_batch=2, codebooks=4),
])
def test_pipeline_batches_equal_the_reference_bitwise(kw):
    mine = TokenPipeline(DataConfig(**kw))
    ref = jdata.TokenPipeline(jdata.DataConfig(**kw))
    for step in (0, 1, 7, 1000):
        a, b = mine.batch(step)["tokens"], ref.batch(step)["tokens"]
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    it, rit = iter(mine), iter(ref)
    for _ in range(3):
        np.testing.assert_array_equal(next(it)["tokens"],
                                      next(rit)["tokens"])


def test_pipeline_host_shards_equal_the_reference_bitwise():
    kw = dict(vocab_size=100, seq_len=8, global_batch=8, seed=0)
    for h in range(4):
        mine = TokenPipeline(DataConfig(**kw), host_id=h, num_hosts=4)
        ref = jdata.TokenPipeline(jdata.DataConfig(**kw), host_id=h,
                                  num_hosts=4)
        assert mine.local_batch == 2
        np.testing.assert_array_equal(mine.batch(5)["tokens"],
                                      ref.batch(5)["tokens"])
    with pytest.raises(ValueError, match="hosts"):
        TokenPipeline(DataConfig(**kw), num_hosts=3)


def test_pipeline_token_file_equals_the_reference(tmp_path):
    path = str(tmp_path / "tokens.bin")
    np.arange(5000, dtype=np.int32).tofile(path)
    kw = dict(vocab_size=5000, seq_len=32, global_batch=3, token_file=path)
    a = TokenPipeline(DataConfig(**kw)).batch(4)["tokens"]
    b = jdata.TokenPipeline(jdata.DataConfig(**kw)).batch(4)["tokens"]
    np.testing.assert_array_equal(a, b)
    assert (np.diff(a, axis=1) == 1).all()


def _state(cfg, seed):
    """A smoke model and an AdamW state after one step of random
    gradients, so no moment is zero."""
    model = init_params(cfg, torch.Generator().manual_seed(seed),
                        device="cpu")
    opt = AdamW(lr=1e-2)
    state = opt.init(model)
    g = torch.Generator().manual_seed(seed + 1)
    opt.update({n: torch.randn(p.shape, generator=g).to(p.dtype)
                for n, p in model.named_parameters()}, state, model)
    return model, state


def _assert_equal_trees(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        if y.dtype.name == "bfloat16":
            y = y.view(np.uint16)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_round_trip(tmp_path, dtype):
    cfg = tcfgs.smoke_config("hymba-1.5b", dtype=dtype)
    model, state = _state(cfg, 0)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    path = mgr.save(10, model, state, extra={"loss": 1.5})
    assert os.path.basename(path) == "step_10"
    assert sorted(os.listdir(path)) == ["meta.json", "opt_state.npz",
                                        "params.npz"]
    other, other_state = _state(cfg, 5)
    restored = mgr.restore(other, other_state)
    assert restored == {"step": 10, "extra": {"loss": 1.5}}
    _assert_equal_trees(params_to_jax(other), params_to_jax(model))
    _assert_equal_trees(opt_state_to_jax(other_state),
                        opt_state_to_jax(state))
    assert other.embed.dtype == getattr(torch, dtype)
    assert CheckpointManager(str(tmp_path / "empty")).restore(other) is None


def test_checkpoint_keep_n_and_no_tmp_left(tmp_path):
    model, state = _state(tcfgs.smoke_config("mamba2-130m"), 1)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, model, state if s % 2 else None)
    names = os.listdir(tmp_path)
    assert sorted(names) == ["step_3", "step_4"]
    assert not any(n.startswith("tmp.") for n in names)
    assert mgr.latest_step == 4
    assert mgr.restore(model, step=3)["step"] == 3


def test_checkpoint_refuses_another_model(tmp_path):
    model, state = _state(tcfgs.smoke_config("hymba-1.5b"), 2)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, model, state)
    other, other_state = _state(tcfgs.smoke_config("gemma3-1b"), 2)
    with pytest.raises(ValueError, match="disagree"):
        mgr.restore(other, other_state)
    bf16, _ = _state(tcfgs.smoke_config("hymba-1.5b", dtype="bfloat16"), 2)
    with pytest.raises(ValueError, match="bfloat16"):
        mgr.restore(bf16)


def _jax_state(arch, dtype, seed):
    cfg = jcfgs.smoke_config(arch, dtype=dtype)
    params = jm.init_params(cfg, jax.random.key(seed))
    opt = joptim.AdamW(lr=1e-2)
    state = opt.init(params)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.5, p.dtype), params)
    params, state = opt.update(grads, state, params)
    return params, state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, dtype):
    params, state = _jax_state("hymba-1.5b", dtype, 3)
    jckpt.CheckpointManager(str(tmp_path)).save(7, params, state,
                                                extra={"loss": 2.0})
    model, my_state = _state(tcfgs.smoke_config("hymba-1.5b", dtype=dtype),
                             9)
    restored = CheckpointManager(str(tmp_path)).restore(model, my_state)
    assert restored == {"step": 7, "extra": {"loss": 2.0}}
    _assert_equal_trees(params_to_jax(model),
                        jax.tree.map(np.asarray, params))
    _assert_equal_trees(opt_state_to_jax(my_state),
                        jax.tree.map(np.asarray, state._asdict()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, dtype):
    model, state = _state(tcfgs.smoke_config("gemma3-1b", dtype=dtype), 4)
    CheckpointManager(str(tmp_path)).save(3, model, state)
    like_p, like_s = _jax_state("gemma3-1b", dtype, 0)
    restored = jckpt.CheckpointManager(str(tmp_path)).restore(like_p,
                                                              like_s)
    assert restored["step"] == 3
    _assert_equal_trees(params_to_jax(model),
                        jax.tree.map(np.asarray, restored["params"]))
    _assert_equal_trees(opt_state_to_jax(state),
                        jax.tree.map(np.asarray,
                                     restored["opt_state"]._asdict()))


ARGS = ["--arch", "mamba2-130m", "--smoke", "--batch", "2", "--seq", "16",
        "--device", "cpu"]


def test_trainer_checkpoint_restart(tmp_path):
    """Kill at step 6, restart, reach the state of an uninterrupted run
    (step-keyed data), as the reference's trainer test."""
    from repro_torch.launch.train import main
    ckpt = str(tmp_path / "ck")
    args = ARGS + ["--ckpt-dir", ckpt, "--ckpt-every", "3"]
    main(args + ["--steps", "6"])           # "preempted" at step 6
    l2 = main(args + ["--steps", "9"])      # restart, runs 6..9
    l3 = main(ARGS + ["--steps", "9", "--ckpt-dir", str(tmp_path / "ck2"),
                      "--ckpt-every", "100"])
    assert len(l2) == 3                     # resumed from step 6
    assert l2[-1] == pytest.approx(l3[-1], rel=1e-4)
    assert sorted(os.listdir(ckpt)) == ["step_3", "step_6", "step_9"]


def test_trainer_checkpoints_and_exits_on_sigterm(tmp_path, monkeypatch):
    from repro_torch.launch import train
    batch = train.TokenPipeline.batch

    def preempt_at_2(self, step):
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return batch(self, step)
    monkeypatch.setattr(train.TokenPipeline, "batch", preempt_at_2)
    before = signal.getsignal(signal.SIGTERM)
    ckpt = str(tmp_path / "ck")
    res = train.run(ARGS + ["--steps", "9", "--ckpt-dir", ckpt,
                            "--ckpt-every", "100", "--log-every", "1"])
    assert len(res["losses"]) == 3 and np.isfinite(res["losses"]).all()
    assert CheckpointManager(ckpt).latest_step == 3
    assert signal.getsignal(signal.SIGTERM) is before
    assert len(res["step_ms"]) == 3 and res["device"] == "cpu"
