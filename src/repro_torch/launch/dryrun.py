"""Multi-pod dry run: trace one step of every (arch x shape x mesh) cell
on rank 0 of a fake process group and record its per-card memory,
FLOPs, bytes and collectives for the roofline report.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch mixtral-8x22b --shape train_4k --mesh both

Records land in ``results/dryrun_torch/<arch>__<shape>__<mesh>
[__<policy>].json``, with the reference's keys (``arch``, ``shape``,
``mesh``, ``policy``, ``n_chips``, ``memory``, ``params_total``,
``params_active``, ``ok``, ``roofline``) and ``trace_s`` in place of
the reference's ``lower_s``/``compile_s``.

The reference lowers and compiles each cell for 512 placeholder host
devices.  Here each cell starts a fake process group of 256 or 512 ranks
(``torch.distributed`` backend ``fake``: collectives return at once and
move nothing) and builds the production ``DeviceMesh`` over it, places a
meta model, its AdamW state, the batch and the cache by the placement
rules (``models/params.py``) as rank 0's local shards, and runs the step
once on them under ``roofline.StepCost``.  The abstract pass runs on the
meta device by design, as the reference's runs on placeholder host
devices: no tensor has memory, every kernel runs its plain version
(``impl="torch"``), as the reference's host compile takes its plain
paths, and the mesh is a CPU mesh (its all-to-all redistributions show
as all-gathers).  The port's layer loop is Python, so the pass counts
every layer and needs no two-point layer extrapolation.  XLA's temp
bytes have no counterpart on the meta device (``memory_stats``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch.distributed as dist

from ..configs import (ARCH_NAMES, SHAPES, get_config, input_specs,
                       shape_applicable)
from ..models.params import place_batch, place_cache, place_model, \
    place_opt_state
from ..models.steps import make_train_step
from ..models.transformer import ShardingPolicy, Transformer, \
    decode_step, make_cache, prefill
from ..optim import AdamW
from . import roofline
from .mesh import PRODUCTION_SHAPES, dp_axes, make_production_mesh


@dataclasses.dataclass
class Policy:
    """A sharding/impl policy variant (hillclimbing knob)."""
    name: str = "baseline"
    zero3: bool = True
    seq_axis: str = "model"       # sequence parallelism for residuals
    remat: str = "full"           # train remat policy
    grad_compress: bool = False   # bf16 grads before cross-replica reduce
    window_ring_cache: bool = False
    moe_dispatch: str = "dense"   # "gather": capacity EP dispatch
    moe_fold_gates: bool = False  # fold gates into the w2 contraction
    kv_cache_dtype: str = "none"  # "int8": quantised decode cache


POLICIES = {
    "baseline": Policy(),
    "nozero3": Policy(name="nozero3", zero3=False),
    "nosp": Policy(name="nosp", seq_axis=None),
    "dots": Policy(name="dots", remat="dots"),
    "gradbf16": Policy(name="gradbf16", grad_compress=True),
    "ring": Policy(name="ring", window_ring_cache=True),
    "moegather": Policy(name="moegather", moe_dispatch="gather"),
    "moefold": Policy(name="moefold", moe_fold_gates=True),
    "moegather_nozero3": Policy(name="moegather_nozero3",
                                moe_dispatch="gather", zero3=False),
    "moefold_gather": Policy(name="moefold_gather", moe_dispatch="gather",
                             moe_fold_gates=True),
    "kvint8": Policy(name="kvint8", kv_cache_dtype="int8"),
    "moegather_gradbf16": Policy(name="moegather_gradbf16",
                                 moe_dispatch="gather", grad_compress=True),
    "moegather_dots": Policy(name="moegather_dots", moe_dispatch="gather",
                             remat="dots"),
    "ring_kvint8": Policy(name="ring_kvint8", window_ring_cache=True,
                          kv_cache_dtype="int8"),
    "dots_gradbf16": Policy(name="dots_gradbf16", remat="dots",
                            grad_compress=True),
}


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake default process group of ``world_size`` ranks, this process
    rank 0, for the time of the block."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a default process group already exists")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def build_cell(arch: str, shape_name: str, mesh, policy: Policy,
               device="meta", impl="torch"):
    """Returns ``(cfg, shape, fn, args)`` for one cell: ``fn(*args)`` runs
    the step on rank 0's local shards, allocated on ``device`` (meta:
    none).  ``args[0]`` is the placed model; ``fn`` returns what the
    step writes out (``memory_stats``' outputs)."""
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    overrides = {"remat": policy.remat}
    if cfg.moe_experts and policy.moe_fold_gates:
        overrides["moe_fold_gates"] = True
    if cfg.moe_experts and policy.moe_dispatch != "dense":
        overrides["moe_dispatch"] = policy.moe_dispatch
        # group-local dispatch aligned with the DP shard count
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        n = 1
        for a in ("pod", "data"):
            n *= sizes.get(a, 1)
        overrides["moe_groups"] = n
    if shape.kind == "decode":
        overrides["kv_cache_dtype"] = policy.kv_cache_dtype
        cache_len = shape.seq_len
        if policy.window_ring_cache and cfg.window > 0 \
                and not cfg.global_every and not cfg.swa_all_but:
            cache_len = min(cache_len, cfg.window)
            overrides["window_ring_cache"] = True
        overrides["max_cache_len"] = cache_len
    cfg = dataclasses.replace(cfg, **overrides)

    dpa = dp_axes(mesh)
    sp = ShardingPolicy(mesh=mesh, batch_axes=dpa, seq_axis=policy.seq_axis)
    model = Transformer(cfg, device="meta")
    opt = AdamW(lr=1e-4)
    state = opt.init(model) if shape.kind == "train" else None
    place_model(model, mesh, zero3=policy.zero3, device=device)
    batch = place_batch(input_specs(cfg, shape), mesh, dpa, device=device)

    if shape.kind == "train":
        state = place_opt_state(cfg, state, mesh, zero3=policy.zero3,
                                device=device)
        step = make_train_step(cfg, opt, grad_compress=policy.grad_compress,
                               impl=impl, policy=sp)

        def fn(model, state, batch):
            metrics = step(model, state, batch)
            return model, state, metrics
        return cfg, shape, fn, (model, state, batch)
    if shape.kind == "prefill":
        def fn(model, batch):
            return prefill(model, batch["tokens"], cache_len=shape.seq_len,
                           impl=impl, vision=batch.get("vision"),
                           policy=sp)[:2]
        return cfg, shape, fn, (model, batch)
    cache = place_cache(cfg, make_cache(cfg, shape.global_batch,
                                        cfg.max_cache_len, "meta"),
                        mesh, dpa, device=device)
    # one token at the end of the context (the ring cache wraps)
    pos = shape.seq_len - 1

    def fn(model, tokens, cache):
        return decode_step(model, tokens, cache, pos, impl=impl,
                           policy=sp)[:2]
    return cfg, shape, fn, (model, batch["tokens"], cache)


def run_cell(arch, shape_name, mesh_kind, policy, out_dir,
             with_roofline=True):
    multi = mesh_kind == "multi"
    shape_dims, _ = PRODUCTION_SHAPES[multi]
    n_chips = 1
    for n in shape_dims:
        n_chips *= n
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "policy": policy.name, "n_chips": n_chips}
    try:
        t0 = time.perf_counter()
        with fake_group(n_chips):
            mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
            cfg, shape, fn, args = build_cell(arch, shape_name, mesh, policy)
            with roofline.StepCost() as cost:
                outputs = fn(*args)
            # written in place: the model and its AdamW state in training,
            # the cache at decode
            aliased = (args[:2] if shape.kind == "train"
                       else args[2] if shape.kind == "decode" else ())
            memory = roofline.memory_stats(args, outputs, aliased)
        seconds = time.perf_counter() - t0
        rec["memory"] = memory
        rec["params_total"] = cfg.param_count()
        rec["params_active"] = cfg.active_param_count()
        rec["trace_s"] = seconds
        rec["ok"] = True
        if with_roofline:
            rec["roofline"] = roofline.roofline_terms(
                cost, n_chips, roofline.model_flops(cfg, shape))
            dom = rec["roofline"]["dominant"]
        else:
            dom = "-"
        print(f"[OK]   {arch:24s} {shape_name:12s} {mesh_kind:6s} "
              f"{policy.name:10s} trace={seconds:6.1f}s dom={dom}",
              flush=True)
    except Exception as e:
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[FAIL] {arch:24s} {shape_name:12s} {mesh_kind:6s} "
              f"{policy.name:10s}: {rec['error'][:200]}", flush=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, _fname(arch, shape_name, mesh_kind,
                                           policy) + ".json"), "w") as f:
        json.dump(rec, f, indent=1, default=float)
    return rec


def _fname(arch, shape_name, mesh_kind, policy):
    fname = f"{arch}__{shape_name}__{mesh_kind}"
    if policy.name != "baseline":
        fname += f"__{policy.name}"
    return fname


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--policy", default="baseline")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCH_NAMES if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = (["single", "multi"] if args.mesh == "both" else [args.mesh])
    policy = POLICIES[args.policy]

    n_ok = n_fail = n_skip = 0
    for arch in archs:
        cfg = get_config(arch)
        for shape_name in shapes:
            if not shape_applicable(cfg, SHAPES[shape_name]):
                print(f"[SKIP] {arch:24s} {shape_name:12s} "
                      f"(full-attention arch; see DESIGN.md §4)")
                n_skip += 1
                continue
            for mesh_kind in meshes:
                path = os.path.join(args.out, _fname(
                    arch, shape_name, mesh_kind, policy) + ".json")
                if args.skip_existing and os.path.exists(path):
                    with open(path) as f:
                        if json.load(f).get("ok"):
                            n_ok += 1
                            continue
                rec = run_cell(arch, shape_name, mesh_kind, policy,
                               args.out,
                               with_roofline=(mesh_kind == "single"))
                n_ok += rec["ok"]
                n_fail += not rec["ok"]
    print(f"\ndry-run complete: ok={n_ok} fail={n_fail} skipped={n_skip}")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
