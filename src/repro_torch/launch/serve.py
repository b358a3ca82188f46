"""Batched serving: prefill a batch of prompts, then decode with a
shared KV cache (greedy sampling).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
        --batch 4 --prompt-len 1536 --gen 32             # on a CUDA card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
        --smoke --device cpu                             # plain path, CPU

Parameters and prompts are drawn from an explicit ``torch.Generator``
seeded by ``--seed`` on the chosen device.  On the card, attention and
the SSD scan run as the port's CUDA kernels.  ``--device`` defaults to
``cuda`` and raises without a card.  Prints the prefill time, the decode
time per step and the aggregate tokens per second.
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
    """Next token ``[B, 1]``: the first maximal index of the last
    position's logits."""
    return torch.argmax(logits[:, -1:], dim=-1)


def serve(cfg, *, batch=4, prompt_len=32, gen=16, device="cuda", seed=0):
    """Initialise ``cfg`` from ``seed``, prefill ``batch`` random prompts
    of ``prompt_len`` tokens and decode ``gen`` tokens greedily.  Returns
    a dict with the generated tokens ``[batch, gen]`` (on the device),
    the prompts, and the timings (host clock around work that ends in a
    device synchronisation)."""
    dev = resolve_device(device)
    cache_len = prompt_len + gen
    cfg = dataclasses.replace(cfg, max_cache_len=cache_len)
    g = torch.Generator(device=dev).manual_seed(seed)
    model = init_params(cfg, g, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=g, device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache, pos = prefill(model, prompts, cache_len=cache_len)
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
           else torch.zeros(batch, 0, dtype=torch.long, device=dev))
    return dict(cfg=cfg, model=model, prompts=prompts, tokens=out,
                prefill_ms=t_prefill * 1e3, decode_ms_per_token=t_decode
                * 1e3, tokens_per_s=batch / max(t_decode, 1e-9),
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
