"""Batched serving: prefill a batch of prompts, then decode with a
shared KV cache (greedy sampling).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
        --batch 4 --prompt-len 1536 --gen 32             # on a CUDA card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
        --smoke --device cpu                             # plain path, CPU

Every family of the registry serves: audio prompts are ``[B, S, K]``
codebook tokens and generate ``[B, gen, K]``; a vision model reads a
stub of ``cross_tokens`` encoder states (``0.02 * normal``).
``--kv-dtype int8`` stores the KV cache as int8 with per-vector scales.
Parameters, prompts and the vision stub are drawn from an explicit
``torch.Generator`` seeded by ``--seed`` on the chosen device.  On the
card, attention and the SSD scan run as the port's CUDA kernels.
``--device`` defaults to ``cuda`` and raises without a card.  Prints
the prefill time, the decode time per step and the aggregate tokens per
second.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..configs import get_config, smoke_config
from ..device import resolve_device
from ..models import decode_step, init_params, prefill


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def greedy(logits):
    """Next token ``[B, 1]`` (audio ``[B, 1, K]``): the first maximal
    index of the last position's logits."""
    return torch.argmax(logits[:, -1:], dim=-1)


def make_inputs(cfg, batch, prompt_len, generator, device):
    """``(prompts, vision)`` drawn from ``generator``: prompts ``[batch,
    prompt_len]`` (audio ``[batch, prompt_len, K]``) and, for the vision
    family, the stub's encoder states ``0.02 * normal [batch,
    cross_tokens, d_model]`` in the activation type (else None)."""
    shape = (batch, prompt_len) + ((cfg.codebooks,)
                                   if cfg.frontend == "audio" else ())
    prompts = torch.randint(0, cfg.vocab_size, shape, generator=generator,
                            device=device)
    vision = None
    if cfg.frontend == "vision":
        vision = (0.02 * torch.randn(batch, cfg.cross_tokens, cfg.d_model,
                                     generator=generator, device=device)
                  ).to(cfg.activation_dtype)
    return prompts, vision


def generate(model, prompts, gen, vision=None):
    """Prefill ``prompts`` (with ``vision``) and decode ``gen`` tokens
    greedily with ``model`` as it is configured (``model.cfg``).
    Returns a dict with the generated tokens ``[batch, gen]`` (audio
    ``[batch, gen, K]``) and the timings (host clock around work that
    ends in a device synchronisation)."""
    dev = prompts.device
    batch, prompt_len = prompts.shape[:2]
    cache_len = prompt_len + gen
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache, pos = prefill(model, prompts, cache_len=cache_len,
                                 vision=vision)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    generated = []
    tok = greedy(logits)
    t0 = time.perf_counter()
    for _ in range(gen):
        generated.append(tok[:, 0])
        logits, cache, pos = decode_step(model, tok, cache, pos)
        tok = greedy(logits)
    _sync(dev)
    t_decode = (time.perf_counter() - t0) / max(gen, 1)
    out = (torch.stack(generated, dim=1) if generated
           else torch.zeros(batch, 0, *prompts.shape[2:], dtype=torch.long,
                            device=dev))
    return dict(tokens=out, prefill_ms=t_prefill * 1e3,
                decode_ms_per_token=t_decode * 1e3,
                tokens_per_s=batch / max(t_decode, 1e-9))


def serve(cfg, *, batch=4, prompt_len=32, gen=16, device="cuda", seed=0):
    """Initialise ``cfg`` from ``seed``, prefill ``batch`` random prompts
    of ``prompt_len`` tokens and decode ``gen`` tokens greedily.  Returns
    ``generate``'s dict with the config, the model, the prompts and the
    vision stub (on the device)."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(cfg, max_cache_len=prompt_len + gen)
    g = torch.Generator(device=dev).manual_seed(seed)
    model = init_params(cfg, g, device=dev)
    prompts, vision = make_inputs(cfg, batch, prompt_len, g, dev)
    res = generate(model, prompts, gen, vision)
    return dict(res, cfg=cfg, model=model, prompts=prompts, vision=vision,
                device=str(dev))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--kv-dtype", default="none", choices=["none", "int8"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = (smoke_config if args.smoke else get_config)(
        args.arch, kv_cache_dtype=args.kv_dtype)
    res = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                gen=args.gen, device=args.device, seed=args.seed)
    out = res["tokens"].cpu()
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen} kv={args.kv_dtype} dtype={cfg.dtype} "
          f"device={res['device']}")
    print(f"prefill: {res['prefill_ms']:.1f} ms; decode: "
          f"{res['decode_ms_per_token']:.1f} ms/token "
          f"({res['tokens_per_s']:.1f} tok/s aggregate)")
    print(f"first sequences: {out[0][:12].tolist()}...")
    if out.numel() and not (int(out.min()) >= 0
                            and int(out.max()) < cfg.vocab_size):
        raise AssertionError("generated tokens outside the vocabulary")
    return res


if __name__ == "__main__":
    main()
