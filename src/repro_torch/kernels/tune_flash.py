"""Time variants of K2's tensor-core route on the card, in turns.

    PYTHONPATH=src python -m repro_torch.kernels.tune_flash   # every variant
    PYTHONPATH=src python -m repro_torch.kernels.tune_flash base ieee_exp2

Each variant is the source ``csrc/flash_attention.cu`` with a few text
substitutions (``VARIANTS``), built with the port's ``nvcc`` flags into
``build/repro_torch/variants/`` (all builds started together), checked
against ``ref.attention_ref`` at the bfloat16 limits of ``chip_smoke.py``
(atol 4e-3, rtol 8e-3) and timed with CUDA events at Hymba-1.5B's
prefill shape (B 4, Hq 25, Hkv 5, Sq 1536, Skv 1568, D 64, the KV
cache's strided layout, window 1024 and 0): 20 calls per timing, four
rounds, the variant order reversed every other round.  Prints the
card's ``nvidia-smi`` name and power limit, then one JSON line per
(variant, window) with the least and every round's ms.  Needs one card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch

from . import _build, ref
from .flash_attention import _SIGNATURES, _strides

# name -> (old, new) substitutions in csrc/flash_attention.cu
VARIANTS = {
    "base": (),
    # the exponentials by IEEE exp2f instead of the SFU's ex2.approx
    "ieee_exp2": (('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : '
                   '"f"(x));', "y = exp2f(x);"),),
    "stages3": (("static constexpr int kStages = 2;",
                 "static constexpr int kStages = 3;"),),
    "min_blocks3": (("static constexpr int kMinBlocks = D <= 64 ? 4 : 1;",
                     "static constexpr int kMinBlocks = D <= 64 ? 3 : 1;"),),
    "min_blocks1": (("static constexpr int kMinBlocks = D <= 64 ? 4 : 1;",
                     "static constexpr int kMinBlocks = 1;"),),
    "warps8": (("constexpr int kTcWarps = 4;", "constexpr int kTcWarps = 8;"),
               ("static constexpr int kMinBlocks = D <= 64 ? 4 : 1;",
                "static constexpr int kMinBlocks = 1;")),
    "keys32": (("constexpr int kTcKeys = 64;",
                "constexpr int kTcKeys = 32;"),),
    "keys128": (("constexpr int kTcKeys = 64;",
                 "constexpr int kTcKeys = 128;"),
                ("static constexpr int kMinBlocks = D <= 64 ? 4 : 1;",
                 "static constexpr int kMinBlocks = 1;")),
}
SHAPE = dict(B=4, Hq=25, Hkv=5, Sq=1536, Skv=1568, D=64)
WINDOWS = (1024, 0)


def build(names):
    """Write and compile each named variant; ``{name: launch function}``."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise ValueError(f"variant {name}: {old!r} not in source")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        lib = out_dir / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    fns = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        fn = ctypes.CDLL(str(lib)).flash_attention_tc_launch
        fn.argtypes = _SIGNATURES["flash_attention_tc_launch"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def inputs(seed=0):
    """Per window: (q, k, v, the plain version's output as float32)."""
    B, Hq, Hkv, Sq, Skv, D = (SHAPE[k] for k in
                              ("B", "Hq", "Hkv", "Sq", "Skv", "D"))
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").bfloat16()

    out = {}
    for w in WINDOWS:
        q = randn(B, Sq, Hq, D).transpose(1, 2)
        k = randn(B, Skv, Hkv, D).transpose(1, 2)
        v = randn(B, Skv, Hkv, D).transpose(1, 2)
        out[w] = (q, k, v, ref.attention_ref(q, k, v, window=w,
                                             kv_len=Sq).float())
    return out


def call(fn, q, k, v, window):
    B, Hq, Hkv, Sq, Skv, D = (SHAPE[k] for k in
                              ("B", "Hq", "Hkv", "Sq", "Skv", "D"))
    o = torch.empty(B, Hq, Sq, D, dtype=torch.bfloat16, device="cuda")
    st = _strides(q, k, v, o)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             ctypes.addressof(st), B, Hq, Hkv, Sq, Skv, D, Sq, 1, window,
             D ** -0.5, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return o


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tune_flash: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    fns = build(args.variants)
    data = inputs()
    for name, fn in fns.items():
        for w, (q, k, v, want) in data.items():
            err = (call(fn, q, k, v, w).float() - want).abs()
            if not bool((err <= 4e-3 + 8e-3 * want.abs()).all()):
                raise AssertionError(f"variant {name} disagrees with the "
                                     f"plain version at window {w}")
    times = {(n, w): [] for n in fns for w in data}
    for rnd in range(4):
        order = list(fns) if rnd % 2 == 0 else list(fns)[::-1]
        for name in order:
            for w, (q, k, v, _) in data.items():
                for _ in range(3):
                    call(fns[name], q, k, v, w)
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(20):
                    call(fns[name], q, k, v, w)
                end.record()
                end.synchronize()
                times[(name, w)].append(start.elapsed_time(end) / 20)
    for (name, w), ts in times.items():
        print(json.dumps(dict(variant=name, window=w, ms_min=min(ts),
                              ms=ts)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
