"""Time variants of K1's warp route on the card, in turns.

    PYTHONPATH=src python -m repro_torch.kernels.tune_waterfill   # all
    PYTHONPATH=src python -m repro_torch.kernels.tune_waterfill base rows8

Each variant is the source ``csrc/waterfill.cu`` with a few text
substitutions (``VARIANTS``), built with the port's ``nvcc`` flags into
``build/repro_torch/variants/`` (all builds started together).  A
variant that computes the function must be bitwise equal to the plain
version (``core.vectorized.waterfill``) on every input below; a variant
marked diagnostic leaves out a step to show what that step costs, and
is timed only.  Inputs: random flow sets at W 32, F 128 (seed 0, 60 %
of the flows active, capacities uniform in [50, 150)) at R 96 (the
survey's full-width call) and R 4096.  Each variant's warp route is
timed by device time of 200 launches replayed from a CUDA graph, four
rounds, the variant order reversed every other round.  Prints the
card's ``nvidia-smi`` name and power limit, then one JSON line per
variant with the least and every round's µs per launch at each R.
Needs one card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from . import _build
from ..core.vectorized.waterfill import waterfill as plain

# name -> (diagnostic, ((old, new), ...)) substitutions in csrc/waterfill.cu
VARIANTS = {
    "base": (False, ()),
    # the row's min share in 5 shuffle steps instead of one redux.sync
    "shfl_min": (False, ((
        "const float min_share = warp_min_redux(fminf(su, sd));",
        "const float min_share = warp_min(fminf(su, sd));"),)),
    # the division only in lanes whose resource has a live flow (a branch
    # around it)
    "div_in_branch": (False, ((
        "    const float qu = __fdiv_rn(cu > 0 ? cap_u : 1.0f,\n"
        "                               static_cast<float>"
        "(cu > 0 ? cu : 1));\n"
        "    const float qd = __fdiv_rn(cd > 0 ? cap_d : 1.0f,\n"
        "                               static_cast<float>"
        "(cd > 0 ? cd : 1));\n"
        "    const float su = cu > 0 ? qu : CUDART_INF_F;\n"
        "    const float sd = cd > 0 ? qd : CUDART_INF_F;\n",
        "    const float su = cu > 0 ? __fdiv_rn(cap_u, "
        "static_cast<float>(cu))\n"
        "                            : CUDART_INF_F;\n"
        "    const float sd = cd > 0 ? __fdiv_rn(cap_d, "
        "static_cast<float>(cd))\n"
        "                            : CUDART_INF_F;\n"),)),
    # live counts by popcounts of (resource mask & live mask) every round
    "recount": (False, ((
        "    cu -= uu;\n    cd -= ud;\n",
        "    cu = cd = 0;\n"
        "#pragma unroll\n"
        "    for (int k = 0; k < NK; ++k) {\n"
        "      cu += __popc(mu[k] & live[k]);\n"
        "      cd += __popc(md[k] & live[k]);\n"
        "    }\n"),)),
    # the frozen flows by ballots: the bottleneck sets as two ballot
    # masks, a test of each flow's own src and dst bits, one ballot per
    # 32 flows
    "ballot_freeze": (False, (
        ("    const bool bn_d = cd > 0 && sd <= min_share;\n",
         "    const bool bn_d = cd > 0 && sd <= min_share;\n"
         "    const unsigned bu_mask = __ballot_sync(kFull, bn_u);\n"
         "    const unsigned bd_mask = __ballot_sync(kFull, bn_d);\n"),
        ("      const unsigned z = live[k] & __reduce_or_sync(\n"
         "          kFull, (bn_u ? mu[k] : 0u) | (bn_d ? md[k] : 0u));",
         "      const unsigned z = __ballot_sync(kFull, ((live[k] >> lane) "
         "& 1u) && (((bu_mask >> (u[k] & 31)) | (bd_mask >> (v[k] & 31))) "
         "& 1u));"))),
    # 8 or 2 rows (warps) per block instead of 4
    "rows8": (False, (("constexpr int kWarpRows = 4;",
                       "constexpr int kWarpRows = 8;"),)),
    "rows2": (False, (("constexpr int kWarpRows = 4;",
                       "constexpr int kWarpRows = 2;"),)),
    # diagnostic: no filling round (loads, masks, stores and the launch)
    "no_rounds": (True, ((
        "for (int round = 0; round < max_rounds && any; ++round) {",
        "for (int round = 0; round < 0 && any; ++round) {"),)),
    # diagnostic: every warp returns at once (the launch alone)
    "empty": (True, (("  if (row >= R) return;  // the whole warp",
                      "  if (row >= 0) return;  // the whole warp"),)),
}
ROWS = (96, 4096)
W = 32
F = 4 * W


def build(names):
    """Compile each named variant; ``{name: launch fn}``."""
    fns = {}
    for name, so in _build.build_variants("waterfill", VARIANTS,
                                          names).items():
        fn = so.waterfill_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def inputs(rows, seed=0):
    """(src, dst, active, caps) on the card and the plain rates."""
    rng = np.random.default_rng(seed)
    xs = [torch.as_tensor(x, device="cuda") for x in (
        rng.integers(0, W, (rows, F)).astype(np.int32),
        rng.integers(0, W, (rows, F)).astype(np.int32),
        rng.random((rows, F)) < 0.6,
        rng.uniform(50, 150, (rows, W)).astype(np.float32))]
    return xs, plain(xs[0], xs[1], xs[2], xs[3], xs[3])


def launcher(fn, xs, out):
    src, dst, active, caps = xs
    args = (src.data_ptr(), dst.data_ptr(), active.data_ptr(),
            caps.data_ptr(), caps.data_ptr(), out.data_ptr(),
            src.shape[0], F, W, 2 * W, 0)

    def run():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"waterfill variant failed: CUDA error {err}")
    return run


def graph_us(run, iters=200):
    """Device µs per launch of ``iters`` launches replayed from a graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            run()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tune_waterfill: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    fns = build(args.variants)
    data = {rows: inputs(rows) for rows in ROWS}
    runs = {}
    for name, fn in fns.items():
        for rows, (xs, want) in data.items():
            out = torch.empty_like(want)
            run = launcher(fn, xs, out)
            run()
            torch.cuda.synchronize()
            if not VARIANTS[name][0] and not torch.equal(out, want):
                raise AssertionError(f"variant {name} is not bitwise equal "
                                     f"to the plain version at R {rows}")
            runs[(name, rows)] = run
    times = {key: [] for key in runs}
    for rnd in range(4):
        order = list(fns) if rnd % 2 == 0 else list(fns)[::-1]
        for name in order:
            for rows in ROWS:
                times[(name, rows)].append(graph_us(runs[(name, rows)]))
    for name in fns:
        print(json.dumps(dict(
            variant=name, diagnostic=VARIANTS[name][0],
            us_min={f"R{r}": min(times[(name, r)]) for r in ROWS},
            us={f"R{r}": times[(name, r)] for r in ROWS})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
