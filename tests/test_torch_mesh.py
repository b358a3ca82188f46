"""The port's mesh, placements, sharded step and dry run, each in a
subprocess: anything that starts a process group does, so that no
default group outlives a test file.

* the mesh builders on fake process groups of 8, 256 and 512 ranks,
  and the error (with its hint) when the group is too small;
* a mini dry run, as ``tests/test_dryrun.py``'s: smoke qwen3-32b,
  ``ShapeSpec("mini", 32, 8, "train")`` on a ``(4, 2)`` mesh of a fake
  group, traced under ``roofline.StepCost``: FLOPs > 0, a collective,
  and per-card argument bytes equal to the local shards' bytes; and one
  production cell through ``launch.dryrun``'s CLI;
* ``StepCost``'s per-card FLOPs of a DTensor MLP on ``(2, 2)`` against
  a hand count that includes work every card repeats;
* the sharded f32 train step on four gloo processes on a ``(2, 2)``
  mesh against the reference's train step under its ``ShardingPolicy``
  on 4 forced host devices, on the same weights (``convert.py``):
  smoke qwen3-32b (dense GQA) and mixtral-8x22b (gather dispatch, two
  groups): loss within rtol 1e-5, each gradient within a relative L2
  error of 1e-4 (PERF.md §2's train bounds), the gradient norm, the
  parameters after one clipped AdamW step (atol 1e-5 / rtol 1e-4, as
  ``tests/test_torch_train.py``), and a served smoke prompt's prefill
  and decode logits within 1e-4.  The local kernel calls take their
  plain versions.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
           JAX_PLATFORMS="cpu")


def _run(code, timeout=300, env=None):
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         env=env or ENV, capture_output=True, text=True,
                         timeout=timeout, cwd=ROOT)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-5000:]
    return out.stdout


def test_mesh_builders_on_fake_groups():
    out = _run("""
        import torch.distributed as dist
        from repro_torch.launch import mesh as M
        from repro_torch.launch.dryrun import fake_group
        assert not dist.is_initialized()      # importing starts no group
        try:
            M.make_test_mesh((2, 2), device_type="cpu")
            raise SystemExit("no error without a group")
        except RuntimeError as e:
            assert "need 4 ranks" in str(e), e
        with fake_group(8):
            m = M.make_test_mesh((4, 2), device_type="cpu")
            assert m.mesh_dim_names == ("data", "model")
            assert tuple(m.shape) == (4, 2) and M.dp_axes(m) == ("data",)
            assert tuple(M.make_grid_mesh(device_type="cpu").shape) == (8,)
            try:
                M.make_production_mesh(device_type="cpu")
                raise SystemExit("no error on a group of 8")
            except RuntimeError as e:
                assert "need 256 ranks" in str(e), e
                assert "repro_torch.launch.dryrun" in str(e), e
        with fake_group(256):
            m = M.make_production_mesh(device_type="cpu")
            assert tuple(m.shape) == (16, 16)
            assert m.mesh_dim_names == ("data", "model")
            try:
                M.make_production_mesh(multi_pod=True, device_type="cpu")
                raise SystemExit("no error for 512 on 256")
            except RuntimeError as e:
                assert "need 512 ranks" in str(e), e
        with fake_group(512):
            m = M.make_production_mesh(multi_pod=True, device_type="cpu")
            assert tuple(m.shape) == (2, 16, 16)
            assert M.dp_axes(m) == ("pod", "data")
            assert tuple(M.make_production_mesh(device_type="cpu").shape) \\
                == (16, 16)
        assert not dist.is_initialized()
        print("MESH-OK")
    """)
    assert "MESH-OK" in out


def test_mini_dryrun_and_one_production_cell(tmp_path):
    out = _run(f"""
        import json, os
        from repro_torch.configs import smoke_config, input_specs, ShapeSpec
        from repro_torch.launch import roofline, dryrun
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.models import Transformer, make_train_step
        from repro_torch.models.params import place_batch, place_model
        from repro_torch.models.transformer import ShardingPolicy
        from repro_torch.optim import AdamW

        with dryrun.fake_group(8):
            mesh = make_test_mesh((4, 2), device_type="cpu")
            cfg = smoke_config("qwen3-32b")
            model = Transformer(cfg, device="meta")
            place_model(model, mesh)
            batch = place_batch(input_specs(cfg, ShapeSpec("mini", 32, 8,
                                                           "train")),
                                mesh, ("data",))
            opt = AdamW(lr=1e-3)
            state = opt.init(model)
            sp = ShardingPolicy(mesh=mesh, batch_axes=("data",),
                                seq_axis="model")
            step = make_train_step(cfg, opt, impl="torch", policy=sp)
            with roofline.StepCost() as cost:
                step(model, state, batch)
            mem = roofline.memory_stats((model, state, batch), (), ())
        local = lambda t: t.to_local().numel() * t.to_local().element_size()
        want = (sum(local(p) for p in model.parameters())
                + sum(local(t) for t in state.m.values())
                + sum(local(t) for t in state.v.values())
                + state.step.numel() * 4           # the host step, int32
                + sum(local(t) for t in batch.values()))
        assert mem["argument_size_in_bytes"] == want, (mem, want)
        # every parameter is split: the shards are smaller than the whole
        whole = sum(p.numel() * p.element_size() for p in model.parameters())
        assert sum(local(p) for p in model.parameters()) < whole
        assert cost.flops > 0 and cost.bytes > 0
        coll = cost.collectives()
        assert coll["total_count"] > 0 and coll["total_bytes"] > 0, coll
        terms = roofline.roofline_terms(cost, 8)
        assert terms["flops_per_chip"] == cost.flops

        out = {str(tmp_path)!r}
        assert dryrun.main(["--arch", "mamba2-130m", "--shape",
                            "decode_32k", "--mesh", "single", "--out",
                            out]) == 0
        rec = json.load(open(os.path.join(
            out, "mamba2-130m__decode_32k__single.json")))
        assert rec["ok"] and rec["n_chips"] == 256, rec
        for key in ("memory", "params_total", "params_active", "trace_s",
                    "roofline"):
            assert key in rec, key
        assert rec["roofline"]["flops_per_chip"] > 0
        assert rec["roofline"]["collectives"]["total_count"] > 0
        assert rec["memory"]["argument_size_in_bytes"] > 0
        print("MINI-DRYRUN-OK")
    """)
    assert "MINI-DRYRUN-OK" in out


def test_step_cost_counts_local_flops_with_replicated_work():
    out = _run("""
        import torch
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard)
        from repro_torch.launch import roofline
        from repro_torch.launch.dryrun import fake_group
        from repro_torch.launch.mesh import make_test_mesh

        def dt(shape, local, pl):
            return DTensor.from_local(torch.empty(local, device="meta"),
                                      mesh, pl, run_check=False,
                                      shape=torch.Size(shape),
                                      stride=torch.empty(shape,
                                                         device="meta")
                                      .stride())
        with fake_group(4):
            mesh = make_test_mesh((2, 2), device_type="cpu")
            B, D, F = 8, 16, 32
            x = dt((B, D), (B // 2, D), [Shard(0), Replicate()])
            w1 = dt((D, F), (D, F // 2), [Replicate(), Shard(1)])
            w2 = dt((F, D), (F // 2, D), [Replicate(), Shard(0)])
            r = dt((B, D), (B, D), [Replicate(), Replicate()])
            w3 = dt((D, D), (D, D), [Replicate(), Replicate()])
            with roofline.StepCost() as cost:
                y = (x @ w1) @ w2                  # partial over model
                y = y.redistribute(mesh, [Shard(0), Replicate()])
                z = r @ w3                         # every card, whole
        # per card: two products of the local [4, 16] x [16, 16], and the
        # replicated [8, 16] x [16, 16] in full
        want = 2 * (2 * (B // 2) * D * (F // 2)) + 2 * B * D * D
        assert cost.flops == want, (cost.flops, want)
        coll = cost.collectives()
        assert coll["counts_by_op"]["all-reduce"] == 1, coll
        assert coll["bytes_by_op"]["all-reduce"] == (B // 2) * D * 4, coll
        assert y.placements == (Shard(0), Replicate())
        print("COST-OK", cost.flops)
    """)
    assert "COST-OK" in out


REFERENCE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import smoke_config
from repro.models import (init_params, make_loss_fn, make_train_step,
                          ShardingPolicy, param_pspecs, batch_pspecs,
                          cache_pspecs, to_shardings, make_cache, prefill,
                          decode_step)
from repro.optim import AdamW
import repro.optim.adam as A

out_path = sys.argv[1]
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
sp = ShardingPolicy(mesh=mesh, batch_axes=("data",), seq_axis="model")
save = {}

def flat(tree, prefix):
    for k, v in tree.items():
        if isinstance(v, dict):
            flat(v, f"{prefix}{k}/")
        else:
            save[prefix + k] = np.asarray(v)

for arch, over in ARCHS:
    cfg = smoke_config(arch, **over)
    params = init_params(cfg, jax.random.key(7))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    p_spec = to_shardings(mesh, param_pspecs(cfg, mesh, params))
    batch = {"tokens": jnp.asarray(tokens)}
    b_spec = to_shardings(mesh, batch_pspecs(mesh, batch, ("data",)))
    vg = jax.jit(jax.value_and_grad(make_loss_fn(cfg, sp)),
                 in_shardings=(p_spec, b_spec))
    with mesh:
        loss, grads = vg(params, batch)
    opt = AdamW(**OPT)
    state = opt.init(params)
    o_spec = A.AdamState(
        step=NamedSharding(mesh, P()),
        m=to_shardings(mesh, param_pspecs(cfg, mesh, state.m)),
        v=to_shardings(mesh, param_pspecs(cfg, mesh, state.v)))
    step = jax.jit(make_train_step(cfg, opt, sp, clip_norm=CLIP),
                   in_shardings=(p_spec, o_spec, b_spec))
    with mesh:
        new_params, _, metrics = step(params, state, batch)
    # serving: prefill the prompt, then teacher-forced decode steps
    c_abs = jax.eval_shape(lambda: make_cache(cfg, B, S))
    c_spec = to_shardings(mesh, cache_pspecs(cfg, mesh, c_abs, ("data",)))
    pre = jax.jit(lambda p, b: prefill(p, cfg, b, sp, cache_len=S),
                  in_shardings=(p_spec, b_spec),
                  out_shardings=(None, c_spec, None))
    dec = jax.jit(lambda p, t, c, pos: decode_step(p, cfg, t, c, pos, sp),
                  in_shardings=(p_spec, None, c_spec, None),
                  out_shardings=(None, c_spec, None))
    with mesh:
        logits, cache, pos = pre(params,
                                 {"tokens": jnp.asarray(tokens[:, :PROMPT])})
        serve = [np.asarray(logits)]
        for i in range(PROMPT, S):
            logits, cache, pos = dec(params, jnp.asarray(tokens[:, i:i + 1]),
                                     cache, pos)
            serve.append(np.asarray(logits))
    tag = arch + "|"
    save[tag + "tokens"] = tokens
    save[tag + "loss"] = np.asarray(loss)
    save[tag + "grad_norm"] = np.asarray(metrics["grad_norm"])
    save[tag + "step_loss"] = np.asarray(metrics["loss"])
    save[tag + "serve"] = np.stack(serve)
    flat(jax.tree.map(np.asarray, params), tag + "params/")
    flat(jax.tree.map(np.asarray, grads), tag + "grads/")
    flat(jax.tree.map(np.asarray, new_params), tag + "new/")
np.savez(out_path, **save)
print("REFERENCE-OK")
"""

PORT = """
import json, os, socket, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def unflat(data, prefix):
    tree = {}
    for key in data.files:
        if not key.startswith(prefix):
            continue
        node = tree
        parts = key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = data[key]
    return tree


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def worker(rank, port, ref_path, out_path):
    os.environ["MASTER_ADDR"] = "localhost"
    os.environ["MASTER_PORT"] = str(port)
    dist.init_process_group("gloo", rank=rank, world_size=4)
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import (decode_step, make_loss_fn,
                                    make_train_step, params_from_jax,
                                    prefill)
    from repro_torch.models.convert import _unflatten, param_tree
    from repro_torch.models.params import place_batch, place_model
    from repro_torch.models.transformer import ShardingPolicy
    from repro_torch.optim import AdamW
    full = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
    mesh = make_test_mesh((2, 2), device_type="cpu")
    sp = ShardingPolicy(mesh=mesh, batch_axes=("data",), seq_axis="model")
    data = np.load(ref_path)
    results = {}
    for arch, over in ARCHS:
        tag = arch + "|"
        cfg = smoke_config(arch, **over)
        model = params_from_jax(unflat(data, tag + "params/"), cfg,
                                device="cpu")
        specs = place_model(model, mesh)
        tokens = torch.as_tensor(data[tag + "tokens"], dtype=torch.long)
        batch = place_batch({"tokens": tokens}, mesh, ("data",))
        names, params = zip(*model.named_parameters())
        loss = make_loss_fn(cfg, "torch", sp)(model, batch)
        grads = torch.autograd.grad(loss, params)
        got = flat(_unflatten({n: full(g).detach()
                               for n, g in zip(names, grads)}))
        want = flat(unflat(data, tag + "grads/"))
        assert set(got) == set(want), (set(got) ^ set(want))
        grad_err = {k: rel_l2(got[k].numpy() if hasattr(got[k], "numpy")
                              else got[k], want[k]) for k in want}
        opt = AdamW(**OPT)
        state = opt.init(model)
        metrics = make_train_step(cfg, opt, clip_norm=CLIP, impl="torch",
                                  policy=sp)(model, state, batch)
        # each moment stays in its parameter's placement
        same_pl = all(state.m[n].placements == p.placements
                      and state.v[n].placements == p.placements
                      for n, p in model.named_parameters())
        new = flat(_unflatten({n: full(p.detach())
                               for n, p in model.named_parameters()}))
        want_new = flat(unflat(data, tag + "new/"))
        new_err = max(float(np.max(np.abs(np.asarray(new[k]) - want_new[k])
                                   - 1e-4 * np.abs(want_new[k])))
                      for k in want_new)
        # serving on the reference's initial weights
        model = params_from_jax(unflat(data, tag + "params/"), cfg,
                                device="cpu")
        place_model(model, mesh)
        S = tokens.shape[1]
        prompt = place_batch({"tokens": tokens[:, :PROMPT]}, mesh,
                             ("data",))["tokens"]
        logits, cache, pos = prefill(model, prompt, cache_len=S,
                                     impl="torch", policy=sp)
        serve = [full(logits).numpy()]
        for i in range(PROMPT, S):
            t = place_batch({"tokens": tokens[:, i:i + 1]}, mesh,
                            ("data",))["tokens"]
            logits, cache, pos = decode_step(model, t, cache, pos,
                                             impl="torch", policy=sp)
            serve.append(full(logits).numpy())
        serve_err = float(np.max(np.abs(np.stack(serve)
                                        - data[tag + "serve"])))
        results[arch] = dict(
            loss=float(full(loss.detach())),
            loss_ref=float(data[tag + "loss"]),
            step_loss=float(full(metrics["loss"])),
            grad_norm=float(full(metrics["grad_norm"])),
            grad_norm_ref=float(data[tag + "grad_norm"]),
            grad_err=grad_err, new_err=new_err, serve_err=serve_err,
            same_placements=same_pl,
            split=sorted(n for n, s in specs.items() if any(s)))
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(results, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    mp.spawn(worker, args=(port, sys.argv[1], sys.argv[2]), nprocs=4)
    print("PORT-OK")
"""

SETTINGS = """
ARCHS = [("qwen3-32b", {}),
         ("mixtral-8x22b", {"moe_dispatch": "gather", "moe_groups": 2})]
B, S, PROMPT = 4, 16, 12
OPT = dict(lr=1e-3, warmup_steps=1, weight_decay=0.01)
CLIP = 1.0
"""


def test_sharded_train_step_and_serve_match_reference(tmp_path):
    ref = tmp_path / "ref.npz"
    res = tmp_path / "port.json"
    ref_py, port_py = tmp_path / "ref.py", tmp_path / "port.py"
    ref_py.write_text(SETTINGS + REFERENCE)
    port_py.write_text(SETTINGS + PORT)
    for script, args in ((ref_py, [ref]), (port_py, [ref, res])):
        out = subprocess.run([sys.executable, str(script)]
                             + [str(a) for a in args], env=ENV, cwd=ROOT,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-5000:]
    results = json.loads(res.read_text())
    assert set(results) == {"qwen3-32b", "mixtral-8x22b"}
    for arch, r in results.items():
        assert r["split"], arch                    # a placed model
        np.testing.assert_allclose(r["loss"], r["loss_ref"], rtol=1e-5,
                                   err_msg=arch)
        np.testing.assert_allclose(r["step_loss"], r["loss_ref"],
                                   rtol=1e-5, err_msg=arch)
        worst = max(r["grad_err"], key=r["grad_err"].get)
        assert r["grad_err"][worst] <= 1e-4, (arch, worst,
                                              r["grad_err"][worst])
        np.testing.assert_allclose(r["grad_norm"], r["grad_norm_ref"],
                                   rtol=1e-5, err_msg=arch)
        assert r["new_err"] <= 1e-5, (arch, r["new_err"])
        assert r["same_placements"], arch
        assert r["serve_err"] <= 1e-4, (arch, r["serve_err"])


def test_one_card_mesh_is_the_unmeshed_path_bit_for_bit():
    """A ``(1, 1)`` mesh on a one-rank group issues no collective and runs
    the same local ops: the float32 loss, every gradient and the served
    logits equal the unmeshed path's exactly (chip_smoke's ``mesh``
    phase makes the same check on the card)."""
    out = _run("""
        import copy, os, socket
        import torch
        import torch.distributed as dist
        s = socket.socket()
        s.bind(("localhost", 0))
        os.environ.update(MASTER_ADDR="localhost",
                          MASTER_PORT=str(s.getsockname()[1]))
        s.close()
        dist.init_process_group("gloo", rank=0, world_size=1)
        from repro_torch.configs import smoke_config
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.models import (decode_step, init_params,
                                        make_train_step, prefill)
        from repro_torch.models.params import place_batch, place_model
        from repro_torch.models.transformer import ShardingPolicy
        mesh = make_test_mesh((1, 1), device_type="cpu")
        sp = ShardingPolicy(mesh=mesh, batch_axes=("data",),
                            seq_axis="model")

        class Rec:
            def update(self, grads, state, model):
                self.grads = grads

        for arch, over in (("hymba-1.5b", {}),
                           ("mixtral-8x22b", {"moe_dispatch": "gather"}),
                           ("llama-3.2-vision-11b", {})):
            cfg = smoke_config(arch, **over)
            g = torch.Generator().manual_seed(1)
            plain = init_params(cfg, g, device="cpu")
            placed = copy.deepcopy(plain)
            place_model(placed, mesh)
            tokens = torch.randint(0, cfg.vocab_size, (2, 12), generator=g)
            batch = {"tokens": tokens}
            if cfg.frontend == "vision":
                batch["vision"] = 0.02 * torch.randn(
                    2, cfg.cross_tokens, cfg.d_model, generator=g)
            pb = place_batch(batch, mesh, ("data",))
            r0, r1 = Rec(), Rec()
            l0 = make_train_step(cfg, r0, impl="torch")(plain, None, batch)
            l1 = make_train_step(cfg, r1, impl="torch", policy=sp)(
                placed, None, pb)
            assert torch.equal(l0["loss"], l1["loss"].to_local()), arch
            for n, gr in r0.grads.items():
                assert torch.equal(gr, r1.grads[n].to_local()), (arch, n)
            a, ca, pa = prefill(plain, tokens[:, :8], cache_len=12,
                                impl="torch", vision=batch.get("vision"))
            b, cb, pbos = prefill(placed, pb["tokens"][:, :8], cache_len=12,
                                  impl="torch", vision=pb.get("vision"),
                                  policy=sp)
            assert torch.equal(a, b.to_local()), arch
            for i in range(8, 12):
                t = place_batch({"tokens": tokens[:, i:i + 1]}, mesh,
                                ("data",))["tokens"]
                a, ca, pa = decode_step(plain, tokens[:, i:i + 1], ca, pa,
                                        impl="torch")
                b, cb, pbos = decode_step(placed, t, cb, pbos,
                                          impl="torch", policy=sp)
                assert torch.equal(a, b.to_local()), (arch, i)
        dist.destroy_process_group()
        print("ONE-CARD-OK")
    """)
    assert "ONE-CARD-OK" in out
