"""End-to-end trainer with checkpoint/restart fault tolerance.

    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \
        --batch 4 --seq 2048 --steps 5                   # on a CUDA card
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
        --smoke --steps 100 --ckpt-dir ckpt --device cpu  # plain path, CPU

The reference's trainer (``repro/launch/train.py``) with its flags, plus
``--device`` (default ``cuda``, which raises without a card; on the card
the forward pass runs the CUDA kernels K2 and K3) and ``--layers`` (a
depth cut, for a model whose whole depth does not fit one card).
Parameters come from ``init_params(cfg, generator, device)`` with a
``torch.Generator`` seeded by ``--seed``; batches are the step-keyed
``TokenPipeline``'s (and, for the vision family, the stub's input drawn
per step), so with atomic keep-N checkpoints a preempted run restarted
with the same flags reproduces the remaining steps.  A SIGTERM
(preemption notice) triggers a checkpoint before exit.  Prints the loss
and ms/step every ``--log-every`` steps, then the first and the warm
ms/step and tokens/s (host clock around steps that end in a device read
of the loss).
"""
from __future__ import annotations

import argparse
import dataclasses
import signal
import statistics
import time

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..configs import get_config, smoke_config
from ..data import DataConfig, TokenPipeline
from ..device import resolve_device
from ..models import init_params, make_train_step
from ..optim import AdamW


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config to this many layers (0: its "
                    "own depth); a vision model keeps whole groups")
    return ap.parse_args(argv)


def run(argv=None):
    """Train as ``main`` does; returns a dict with the ``losses``, the
    ms of each step (``step_ms``), ``start_step``, tokens/s of the warm
    steps, the seconds of the checkpoint restore and of each save
    (``ckpt_s``), and the ``model``, ``opt_state``, ``step_fn``, ``cfg`` and
    ``make_batch`` of the run."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        if cfg.cross_attn_every and args.layers % cfg.cross_attn_every:
            raise ValueError(f"{cfg.name}: --layers {args.layers} is not "
                             f"a multiple of its {cfg.cross_attn_every}"
                             f"-layer groups")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    pipe = TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed,
        codebooks=cfg.codebooks if cfg.frontend == "audio" else 0))

    model = init_params(cfg, torch.Generator(device=dev)
                        .manual_seed(args.seed), device=dev)
    opt = AdamW(lr=args.lr, warmup_steps=min(20, args.steps // 5))
    opt_state = opt.init(model)
    step_fn = make_train_step(cfg, opt, accum=args.accum, clip_norm=1.0)

    start_step = 0
    mgr = None
    ckpt_s = dict(restore=None, save=[])    # host seconds of each call
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3)
        t0 = time.perf_counter()
        restored = mgr.restore(model, opt_state)
        ckpt_s["restore"] = time.perf_counter() - t0
        if restored:
            start_step = restored["step"]
            print(f"restored checkpoint at step {start_step}")

    def make_batch(step):
        """The step's batch on the device: ``tokens`` (``[B, S]``, audio
        ``[B, S, K]``) and, for the vision family, the stub's encoder
        states drawn as the reference draws them, in the activation
        type."""
        toks = pipe.batch(step)["tokens"]
        batch = {"tokens": torch.as_tensor(toks, dtype=torch.long,
                                           device=dev)}
        if cfg.frontend == "vision":
            vision = np.random.default_rng(step).standard_normal(
                (args.batch, cfg.cross_tokens, cfg.d_model)).astype(
                np.float32) * 0.02
            batch["vision"] = torch.as_tensor(vision).to(
                device=dev, dtype=cfg.activation_dtype)
        return batch

    stop = {"now": False}

    def _sigterm(signum, frame):       # preemption notice
        stop["now"] = True
    previous = signal.signal(signal.SIGTERM, _sigterm)

    losses, step_ms = [], []
    try:
        for step in range(start_step, args.steps):
            batch = make_batch(step)
            t0 = time.perf_counter()
            metrics = step_fn(model, opt_state, batch)
            losses.append(float(metrics["loss"]))    # waits for the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if (step + 1) % args.log_every == 0:
                recent = step_ms[-args.log_every:]
                print(f"step {step + 1:5d} loss "
                      f"{np.mean(losses[-args.log_every:]):.4f} "
                      f"({statistics.mean(recent):.0f} ms/step)")
            if mgr and ((step + 1) % args.ckpt_every == 0 or stop["now"]
                        or step + 1 == args.steps):
                t0 = time.perf_counter()
                mgr.save(step + 1, model, opt_state,
                         extra={"loss": losses[-1]})
                ckpt_s["save"].append(time.perf_counter() - t0)
            if stop["now"]:
                print(f"preemption: checkpointed at step {step + 1}, "
                      f"exiting")
                break
    finally:
        signal.signal(signal.SIGTERM, previous)

    warm = step_ms[1:] or step_ms
    warm_ms = statistics.median(warm) if warm else float("nan")
    tokens_per_s = args.batch * args.seq / (warm_ms / 1e3)
    if losses:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
        print(f"arch={cfg.name} batch={args.batch} seq={args.seq} "
              f"accum={args.accum} dtype={cfg.dtype} remat={cfg.remat} "
              f"device={dev}: first step {step_ms[0]:.1f} ms, warm "
              f"{warm_ms:.1f} ms/step ({tokens_per_s:.0f} tokens/s)")
    return dict(losses=losses, step_ms=step_ms, start_step=start_step,
                warm_ms=warm_ms, tokens_per_s=tokens_per_s, ckpt_s=ckpt_s,
                model=model, opt_state=opt_state, step_fn=step_fn, cfg=cfg,
                make_batch=make_batch, device=str(dev))


def main(argv=None):
    """The reference's ``main``: trains and returns the losses."""
    return run(argv)["losses"]


if __name__ == "__main__":
    main()
