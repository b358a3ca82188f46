"""Time variants of K3's kernels on the card, in turns.

    PYTHONPATH=src python -m repro_torch.kernels.tune_ssd      # every variant
    PYTHONPATH=src python -m repro_torch.kernels.tune_ssd base exp_fast

Each variant is the source ``csrc/ssd.cu`` with a few text substitutions
(``VARIANTS``), built with the port's ``nvcc`` flags into
``build/repro_torch/variants/`` (all builds started together).  A
variant that computes the function is checked against the plain pieces
(``ref.ssd_chunk_states``, ``ssd_pass_states``, ``ssd_chunk_scan``) at
atol/rtol 1e-4; a variant marked diagnostic leaves out a step to show
what that step costs, and is timed only.  Each of the three kernels is
timed alone with CUDA events at Hymba-1.5B's prefill shape (Bt 4,
L 1536, H 50, P 64, N 16, chunk 64): 20 launches per timing, four
rounds, the variant order reversed every other round.  Prints the
card's ``nvidia-smi`` name and power limit, then one JSON line per
variant with the least and every round's ms of each kernel.  Needs one
card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch

from . import _build, ref
from .ssd import _SIGNATURES

# name -> (diagnostic, ((old, new), ...)) substitutions in csrc/ssd.cu
VARIANTS = {
    "base": (False, ()),
    # Γ's exponentials by the SFU's fast __expf instead of IEEE expf
    "exp_fast": (False, ((
        "gv[k] = cbv[k] * expf(ci - cmv[k]) * dtv[k];",
        "gv[k] = cbv[k] * __expf(ci - cmv[k]) * dtv[k];"),)),
    # the tf32 split by cvt.rna.tf32.f32 (the conversion pipe)
    "cvt_split": (False, ((
        "  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;\n"
        "  lo = __float_as_uint(v - __uint_as_float(hi));\n",
        "  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(hi) : \"f\"(v));\n"
        "  const float rest = v - __uint_as_float(hi);\n"
        "  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(lo) : "
        "\"f\"(rest));\n"),)),
    # chunk_state with one head per block (more, smaller blocks)
    "state_group1": (False, ((
        "  int hg = (kStateThreads / 32 + per_head - 1) / per_head;",
        "  int hg = 1;"),)),
    # diagnostic: no G (the products read whatever G holds)
    "no_g": (True, (("i < lay.Q16; i += 2 * nwarps) {",
                     "i < 0; i += 2 * nwarps) {"),)),
    # diagnostic: no products of y (the epilogue stores D x alone)
    "no_mma": (True, (
        ("        mma_rows<false, kNT>(intra, low, g_s, lg, xs, lx, r0, c0,\n"
         "                             min(r0 + 16, Q8));\n", ""),
        ("        mma_rows<true, kNT>(inter, low, ct_s, lt, hs, lx, r0, c0, "
         "lay.N8);\n", ""))),
    # one head per block: C Bᵀ and the block's set-up are not shared
    "group1": (False, (("int scan_group(int Bt, int nc, int H) {\n",
                        "int scan_group(int Bt, int nc, int H) {\n"
                        "  if (H > 0) return 1;\n"),)),
}
SHAPE = dict(Bt=4, L=1536, H=50, P=64, N=16, Q=64)
KERNELS = ("ssd_chunk_state_launch", "ssd_state_pass_launch",
           "ssd_chunk_scan_launch")


def build(names):
    """Compile each named variant; ``{name: {kernel: fn}}``."""
    fns = {}
    for name, so in _build.build_variants("ssd", VARIANTS, names).items():
        fns[name] = {}
        for k in KERNELS:
            fn = getattr(so, k)
            fn.argtypes = _SIGNATURES[k]
            fn.restype = ctypes.c_int
            fns[name][k] = fn
    return fns


def inputs(seed=0):
    """x, dt, A, B, C, D at SHAPE, and the plain pieces' S_loc, total,
    h_in, final state and y."""
    Bt, L, H, P, N, Q = (SHAPE[k] for k in ("Bt", "L", "H", "P", "N", "Q"))
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.rand(*shape, generator=g, device="cuda")

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    xs = (randn(Bt, L, H, P), 0.001 + 0.099 * rand(Bt, L, H),
          -(0.5 + 1.5 * rand(H)), randn(Bt, L, N), randn(Bt, L, N),
          randn(H))
    S, total = ref.ssd_chunk_states(*xs[:4], chunk=Q)
    h_in, final = ref.ssd_pass_states(S, total)
    y = ref.ssd_chunk_scan(*xs, h_in, chunk=Q)
    # contiguous: the kernels take raw pointers, and the plain pieces may
    # return strided views
    return xs, {k: v.contiguous() for k, v in dict(
        S=S, total=total, h_in=h_in, final=final, y=y).items()}


def calls(fns, xs, want):
    """One launcher per kernel, each on its own outputs; and the outputs
    as ``{name: tensor}`` after one launch of each."""
    Bt, L, H, P, N, Q = (SHAPE[k] for k in ("Bt", "L", "H", "P", "N", "Q"))
    x, dt, A, B, C, D = xs
    S = torch.empty_like(want["S"])
    total = torch.empty_like(want["total"])
    h_in = want["S"].clone()
    final = torch.empty_like(want["final"])
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream

    def run(k, *args):
        err = fns[k](*args, stream)
        if err != 0:
            raise RuntimeError(f"{k} failed: CUDA error {err}")

    launch = {
        "chunk_state": lambda: run(KERNELS[0], x.data_ptr(), dt.data_ptr(),
                                   A.data_ptr(), B.data_ptr(), S.data_ptr(),
                                   total.data_ptr(), Bt, L, H, P, N, Q),
        "state_pass": lambda: run(KERNELS[1], h_in.data_ptr(),
                                  want["total"].data_ptr(),
                                  final.data_ptr(), Bt, L // Q, H, N, P),
        "chunk_scan": lambda: run(KERNELS[2], x.data_ptr(), dt.data_ptr(),
                                  A.data_ptr(), B.data_ptr(), C.data_ptr(),
                                  D.data_ptr(), want["h_in"].data_ptr(),
                                  y.data_ptr(), Bt, L, H, P, N, Q),
    }
    return launch, dict(S=S, total=total, h_in=h_in, final=final, y=y)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tune_ssd: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    # float32 products of the plain pieces in full float32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fns = build(args.variants)
    xs, want = inputs()
    launches = {}
    for name in fns:
        launch, got = calls(fns[name], xs, want)
        for fn in launch.values():
            fn()
        torch.cuda.synchronize()
        if not VARIANTS[name][0]:
            for key, w in want.items():
                err = (got[key] - w).abs()
                if not bool((err <= 1e-4 + 1e-4 * w.abs()).all()):
                    raise AssertionError(f"variant {name} disagrees with "
                                         f"the plain pieces on {key}: max "
                                         f"abs {float(err.max())}")
        launches[name] = launch
    times = {(n, k): [] for n in fns for k in launches[next(iter(fns))]}
    for rnd in range(4):
        order = list(fns) if rnd % 2 == 0 else list(fns)[::-1]
        for name in order:
            for k, fn in launches[name].items():
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(20):
                    fn()
                end.record()
                end.synchronize()
                times[(name, k)].append(start.elapsed_time(end) / 20)
    for name in fns:
        print(json.dumps(dict(
            variant=name, diagnostic=VARIANTS[name][0],
            ms_min={k: min(times[(name, k)]) for k in launches[name]},
            ms={k: times[(name, k)] for k in launches[name]})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
