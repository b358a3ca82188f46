"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                 # every phase, one card

Drives the port's two main paths through the entry points a user calls,
and checks them: the paper survey's batched dynamic simulator with the
max-min waterfill kernel (K1), and serving Hymba-1.5B with the flash
attention (K2) and Mamba-2 SSD scan (K3) kernels.  Phases, each
printing one JSON line:

1. ``env``: the card's name and power limit.
2. ``build``: compiles every CUDA kernel of the port from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, started
   together) and prints the seconds taken.
3. ``kernel_waterfill``: both routes of the waterfill kernel (``warp``
   and ``block``, forced through the wrapper's private entry) against
   the plain PyTorch version on the card, bitwise or fail — random flow
   sets at R = 4096 for W in {1, 8, 16, 32} (F = 4W) and the block
   route alone at W 64 (F 256), edge cases at each W (all inactive,
   single-source contention, equal-share ties, worker ids outside
   [0, W), max_rounds 3), R 1, 7 and 33, and F 100 at W 20.  Both
   routes are timed in turns (warp, block, block, warp) at the survey's
   shape (R 96, W 32, F 128) and at R 4096: ``ms`` is device time of
   calls replayed from a CUDA graph, ``eager_ms`` CUDA events around a
   loop of calls, ``host_us`` the host's enqueue time per call; the
   plain version by CUDA events around eager calls.  Then K1 on the
   main path's own inputs: a hook of this script copies the inputs of
   every K1 call of one blevel run of the ``survey_full_width`` cell;
   both routes must be bitwise equal to the plain version on all of
   them, and each replays them from a CUDA graph (in turns); the plain
   version gives the filling rounds per row.
4. ``golden``: the dynamic simulator against the reference package's
   recorded ``BENCH_PR7.json`` dynamic rows (blevel, maxmin, frontier
   on, 100 MiB/s, exact imode, msd 0).
5. ``survey_mini``: the mini survey grid without the agreement pass;
   every simulation must be ok.
6. ``survey_agreement``: the mini grid again through ``survey(...)``
   with the agreement pass: 512 ok simulations, 16 agreement rows and
   the ``__pergraph_path__`` row; each ``makespan_ratio`` (batched
   makespan on the card over the reference event loop's deterministic
   twin on the host) must equal the reference package's recorded value
   (``MINI_AGREEMENT``) within rtol 1e-5.  Prints the survey's wall
   time and events/s, the agreement pass's wall time, the geomean
   ``speedup`` and the per-graph against bucketed cold seconds.
7. ``survey_dataset``: the mini grid over ``--dataset wfcommons-mini``
   with the agreement pass: the derived edges must be (128, 288), all
   768 simulations ok, and the two bucket labels and 24 ratios equal
   the reference's recorded ones (``DATASET_AGREEMENT``); prints K1's
   launches by route.
8. ``survey_full_width``: the full grid's T512 bucket on cluster 32x4
   (W = 32, 128 flow slots, 64 resources), all 24 points, blevel and
   greedy on maxmin, through the plain version and the kernel in turns
   (plain, kernel, kernel, plain) on the card; the results must agree
   and every launch of the main path must take the warp route.  One
   more blevel run through the kernel, under ``torch.profiler`` and
   outside the timed turns, gives the card's busy and idle share during
   a survey and K1's share of the device time.  Then the agreement at
   full width, at point 0 (32 MiB/s, exact, msd 0): each graph's twin
   makespan must equal the reference twin's recorded value exactly,
   and the kernel run's batched makespan the reference package's
   recorded one within rtol 1e-5 (``FULL_WIDTH_AGREEMENT``; crossvx
   under blevel, where the reference's frontier overflows, is printed
   and not compared).
9. ``kernel_flash_attention``: K2 against its plain version on the card
   (float32 and bfloat16) at Hymba's prefill shape (B 4, Hq 25, Hkv 5,
   Sq 1536, Skv 1568, kv_len 1536, window 1024 and 0, the KV cache's
   strided layout), its decode shape (Sq 1), gemma3's head dim 256, an
   MQA case (one kv head) and a non-causal case, then bfloat16 cases at
   the edges of the tensor-core and split routes (``Sq``, ``Skv`` and
   ``kv_len`` off the tile, a window ending inside a tile, decode at
   ``kv_len`` 1, with one split and with several, more than 8 query
   heads per kv head); fails above atol/rtol 1e-5 (float32) or atol
   4e-3 / rtol 8e-3 (bfloat16).  The split route's two kernels are also
   held alone against ``ref.attention_partials`` (atol/rtol 1e-4) and
   ``ref.combine_splits`` (the bfloat16 limits).  Times the kernel, the
   plain version and ``scaled_dot_product_attention`` with the same
   boolean mask (the yardstick only; the port never calls it) with CUDA
   events around eager calls.  At decode (Sq 1) one call takes less
   time on the card than on the host's clock, so an eager loop times
   the host: there ``ms`` and ``library_ms`` are device times of calls
   replayed from a CUDA graph, and the eager times stand beside them
   (``eager_ms``, ``library_eager_ms``).
10. ``kernel_ssd``: K3's three kernels (``ssd_chunk_state``,
    ``ssd_state_pass``, ``ssd_chunk_scan``) each alone against its plain
    piece (``ref.ssd_chunk_states``, ``ssd_pass_states``,
    ``ssd_chunk_scan``), and the whole call against ``ssd_chunked`` and
    the sequential final state, at Hymba's prefill shape (Bt 4, L 1536,
    H 50, P 64, N 16), mamba2-130m's (H 24, N 128) and edge cases (one
    chunk, chunk 32, P 16, N 128, a short last head group, a decay that
    overflows above the diagonal, Q/P/N off a multiple of 4, the smoke
    serve's L 8); fails above atol/rtol 1e-4.  Times the call and each
    phase alone with CUDA events around eager calls.
11. ``serve_hymba``: ``repro_torch.launch.serve`` at full width in
    bfloat16 (batch 4, prompt 1536, gen 32) through the kernels, with the
    launches of K2 (32 layers x 33 forward passes) and K3 (32); then the
    same prompt in float32, prefill and 4 teacher-forced decode steps,
    through the kernels and through the plain versions on the card:
    logits within atol/rtol 1e-3 and equal greedy tokens.  K2's launches
    are also counted by route (bf16: ``tc`` at prefill, ``split`` at
    decode; float32: ``f32``), and the prefill profile gives K2's and
    K3's device time and share.
12. ``kernels``: each kernel with its launches on the main path (K1 and
    K2 also by route); needs every kernel's check phase and the phase of
    its path in the same run.

The last lines are the card's ``nvidia-smi`` name and power limit, the
``{"kernels": [...]}`` summary, and ``{"ok": true, "device": ...}``.
Any failure raises and exits non-zero.  Imports nothing of JAX or of
the reference package.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

PHASES = ("env", "build", "kernel_waterfill", "golden", "survey_mini",
          "survey_agreement", "survey_dataset", "survey_full_width",
          "kernel_flash_attention", "kernel_ssd", "serve_hymba", "kernels")

# the recorded dynamic rows of BENCH_PR7.json (reference package, CPU)
GOLDEN = {
    "merge_triplets": dict(cluster="8x4", makespan=249.30433654785156,
                           n_events=232, n_steps=232,
                           transferred=8741974016.0),
    "t2048_layered": dict(cluster="16x4", makespan=61.638973236083984,
                          n_events=1908, n_steps=1801,
                          transferred=60276342784.0),
}
RTOL = 1e-5

# the reference package's agreement rows (``benchmarks.survey.survey``,
# JAX on a CPU): ``makespan_ratio`` of the first cluster (8x4) on maxmin
# at the first point (32 MiB/s, exact imode, msd 0), by (graph,
# scheduler).  fastcrossv's 0.9 % under blevel and 0.3 % under etf are
# the reference's own gap (equal-priority downloads admitted in another
# order by the twin), kept, not repaired.
MINI_AGREEMENT = {
    ("merge_triplets", "blevel"): 1.0000000482825693,
    ("merge_triplets", "random"): 1.0000000661360724,
    ("merge_triplets", "etf"): 1.0000000482825693,
    ("merge_triplets", "greedy"): 0.9999999430160557,
    ("fastcrossv", "blevel"): 1.0089501486911263,
    ("fastcrossv", "random"): 1.000000095528131,
    ("fastcrossv", "etf"): 0.9973245098278471,
    ("fastcrossv", "greedy"): 1.0000001172150574,
    ("sipht", "blevel"): 1.0000000967933749,
    ("sipht", "random"): 1.000000022031648,
    ("sipht", "etf"): 1.0000000967933749,
    ("sipht", "greedy"): 0.9999999938955136,
    ("montage-77-s0", "blevel"): 1.0000000160654554,
    ("montage-77-s0", "random"): 1.000000098542022,
    ("montage-77-s0", "etf"): 1.0000000160654554,
    ("montage-77-s0", "greedy"): 1.0000000955980914,
}

# the same over ``dataset="wfcommons-mini"`` (reference package, JAX on a
# CPU): derived edges, bucket labels and the 24 ratios
DATASET_EDGES = (128, 288)
DATASET_BUCKETS = {
    "T128xO160xE224": ("montage-77-s0", "cybershake-104-s0",
                       "epigenomics-84-s0"),
    "T288xO448xE544": ("montage-220-s1", "cybershake-257-s1",
                       "epigenomics-204-s1"),
}
DATASET_AGREEMENT = {
    ("montage-77-s0", "blevel"): 1.0000000160654554,
    ("cybershake-104-s0", "blevel"): 0.9999998962777956,
    ("epigenomics-84-s0", "blevel"): 1.0000000329239538,
    ("montage-220-s1", "blevel"): 1.0000001139469195,
    ("cybershake-257-s1", "blevel"): 1.0000000263225237,
    ("epigenomics-204-s1", "blevel"): 1.000000097037555,
    ("montage-77-s0", "random"): 1.000000098542022,
    ("cybershake-104-s0", "random"): 0.9999999449282616,
    ("epigenomics-84-s0", "random"): 1.000000116388402,
    ("montage-220-s1", "random"): 0.9999999568163955,
    ("cybershake-257-s1", "random"): 0.9999999481465672,
    ("epigenomics-204-s1", "random"): 0.9999999669237336,
    ("montage-77-s0", "etf"): 1.0000000160654554,
    ("cybershake-104-s0", "etf"): 0.9999999889216464,
    ("epigenomics-84-s0", "etf"): 0.9999999823311638,
    ("montage-220-s1", "etf"): 1.0000001139469195,
    ("cybershake-257-s1", "etf"): 0.9999999724103024,
    ("epigenomics-204-s1", "etf"): 1.000000018823098,
    ("montage-77-s0", "greedy"): 1.0000000955980914,
    ("cybershake-104-s0", "greedy"): 0.9999996082406636,
    ("epigenomics-84-s0", "greedy"): 0.9999999097351874,
    ("montage-220-s1", "greedy"): 1.0000000903638595,
    ("cybershake-257-s1", "greedy"): 1.000000046415712,
    ("epigenomics-204-s1", "greedy"): 0.9999999633295135,
}

# the T512 bucket on 32x4, maxmin, point 0 (32 MiB/s, exact, msd 0):
# (reference package's batched makespan, JAX on a CPU; the reference
# event loop's twin makespan) by (scheduler, graph).  The reference's
# blevel run of crossvx overflows its spec-derived frontier (None).
FULL_WIDTH_AGREEMENT = {
    ("blevel", "fork1"): (129.60316467285156, 129.6031635621222),
    ("blevel", "size_stairs"): (627.4307861328125, 627.4308240257641),
    ("blevel", "crossvx"): (None, 2160.9993905861115),
    ("blevel", "epigenomics-204-s0"): (456.88427734375, 456.88428325455067),
    ("greedy", "fork1"): (129.2369842529297, 129.2369876105791),
    ("greedy", "size_stairs"): (1507.3096923828125, 1507.3097556032444),
    ("greedy", "crossvx"): (8054.41015625, 8054.410844914582),
    ("greedy", "epigenomics-204-s0"): (1436.7587890625, 1436.7587918781019),
}

# peak rates of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
# non-tensor float32 operations/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# dense bfloat16 tensor-core operations/s (same data sheet)
BF16_OPS_PER_S = 989e12


T_START = time.perf_counter()


def emit(phase, **fields):
    """One JSON line per phase, with the seconds since the script began
    (``at_s``)."""
    print(json.dumps({"phase": phase, **fields,
                      "at_s": time.perf_counter() - T_START}), flush=True)


# the card's nvidia-smi name and power limit, set by phase_env; the LM
# phases carry it on their lines
CARD = None


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters, warmup=5):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def t2048_graph(layers=8, width=72, fanin=4):
    """Synthetic layered workflow in the T2048 shape bucket (T = 576,
    E = 2016), built as the reference benchmark builds it."""
    from repro_torch.core import MiB, TaskGraph
    g = TaskGraph("t2048_layered")
    prev = []
    for layer in range(layers):
        cur = []
        for i in range(width):
            k = layer * width + i
            inputs = ([prev[(i * 3 + j * 7) % len(prev)].outputs[0]
                       for j in range(fanin)] if prev else ())
            cur.append(g.new_task(0.5 + 0.01 * (k % 37), inputs=inputs,
                                  outputs=[(20 + k % 50) * MiB],
                                  expected_duration=0.6 + 0.01 * (k % 29)))
        prev = cur
    return g


# ---------------------------------------------------------------- phases
def phase_env():
    import torch
    global CARD
    line = CARD = nvidia_smi_line()
    emit("env", device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=line,
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])
    return line


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all(verbose=bool(os.environ.get("PTXAS_VERBOSE")))
    emit("build", seconds=time.perf_counter() - t0,
         libs={n: os.path.relpath(str(p), HERE) for n, p in libs.items()})


def _flow_sets(rng, R, W, F, p_active=0.6):
    src = rng.integers(0, W, (R, F)).astype("int32")
    dst = rng.integers(0, W, (R, F)).astype("int32")
    active = rng.random((R, F)) < p_active
    caps = rng.uniform(50, 150, (R, W)).astype("float32")
    return src, dst, active, caps


def _edge_cases(W, F):
    import numpy as np
    cases = {}
    z = np.zeros((4, F), np.int32)
    cases["all_inactive"] = (z, z, np.zeros((4, F), bool),
                             np.full((4, W), 100.0, np.float32))
    src = np.zeros((4, F), np.int32)
    dst = np.broadcast_to(1 + (np.arange(F) % max(W - 1, 1)),
                          (4, F)).astype(np.int32) % W
    cases["single_source"] = (src, dst, np.ones((4, F), bool),
                              np.full((4, W), 90.0, np.float32))
    ring_s = np.broadcast_to(np.arange(F) % W, (4, F)).astype(np.int32)
    ring_d = ((ring_s + 1) % W).astype(np.int32)
    cases["equal_share_ties"] = (ring_s, ring_d, np.ones((4, F), bool),
                                 np.full((4, W), 64.0, np.float32))
    # every third flow with a worker id outside [0, W): treated as
    # inactive by the kernels
    rng = np.random.default_rng(W)
    src, dst, active, caps = _flow_sets(rng, 4, W, F, p_active=0.9)
    src[:, ::3] = np.where(np.arange(4)[:, None] % 2, W, -1)
    dst[:, 1::3] = W + 3
    cases["ids_out_of_range"] = (src, dst, active, caps)
    return cases


def _plain_rates(plain, src, dst, active, caps, max_rounds=None):
    """The plain version's rates, with flows whose ids fall outside
    ``[0, W)`` made inactive (what the kernels do with them; the plain
    version indexes by id)."""
    W = caps.shape[1]
    inside = (src >= 0) & (src < W) & (dst >= 0) & (dst < W)
    return plain(src.clamp(0, W - 1), dst.clamp(0, W - 1),
                 active & inside, caps, caps, max_rounds)


def _compare(got, want):
    import torch
    got, want = got.double(), want.double()
    abs_err = (got - want).abs()
    rel = abs_err / want.abs().clamp(min=1e-30)
    return (float(abs_err.max()) if abs_err.numel() else 0.0,
            float(rel.max()) if rel.numel() else 0.0,
            bool(torch.equal(got, want)))


def _waterfill_work(rounds, R, F, W):
    """(bytes, operations) the function needs on these inputs: each
    input read once and the output written once; per row, its filling
    rounds (from the plain version) x (4F count/use increments + 12W
    share, min, test and capacity ops)."""
    nbytes = R * (F * 4 * 2 + F * 1 + W * 4 * 2 + F * 4)
    ops = int(rounds.sum()) * (4 * F + 12 * W)
    return nbytes, ops


@functools.lru_cache(maxsize=None)
def _full_width_group():
    """(encoded graphs, the T512 group, cores, points) of the full grid's
    T512 bucket on 32x4 — the survey_full_width cell."""
    import numpy as np
    from repro_torch.core import parse_cluster
    from repro_torch.core.graphs import encode_graph_batch, survey_names
    from repro_torch.survey import FULL_GRID, grid_points
    encoded, groups = encode_graph_batch(
        survey_names(FULL_GRID["graphs_per_family"]), seed=0, bucket=True)
    grp = next(g for g in groups if g.shape[0] == 512)
    cores = np.asarray(parse_cluster("32x4"), np.int32)[None, :]
    return encoded, grp, cores, grid_points(FULL_GRID)


def _full_width_runner(sched, impl):
    from repro_torch.core.vectorized import make_grid_runner
    from repro_torch.survey import full_frontier_caps
    encoded, grp, cores, _ = _full_width_group()
    return make_grid_runner(
        [encoded[n] for n in grp.names], sched, 32, cores,
        netmodel="maxmin", shape=grp.shape, batch=grp.batch,
        device="cuda", waterfill_impl=impl,
        frontier_caps=full_frontier_caps(grp.shape))


def _record_path_inputs(sched="blevel"):
    """The inputs of every K1 call of one run of the survey_full_width
    cell (``sched`` on maxmin), copied by a hook on the kernel wrapper
    that this script installs for the run and removes after it."""
    from repro_torch.kernels import waterfill as wk
    calls = []
    wrapped = wk.waterfill

    def hook(src, dst, active, caps_up, caps_down, max_rounds=None):
        calls.append(tuple(x.clone() for x in (src, dst, active, caps_up,
                                               caps_down)))
        return wrapped(src, dst, active, caps_up, caps_down, max_rounds)

    wk.waterfill = hook
    try:
        _full_width_runner(sched, "auto")(_full_width_group()[3])
    finally:
        wk.waterfill = wrapped
    return calls


def _turns(routes, fn):
    """``fn(route)`` for each route in turns (a, b, b, a): ``{route:
    [result, result]}``."""
    out = {r: [] for r in routes}
    for r in list(routes) + list(reversed(routes)):
        out[r].append(fn(r))
    return out


def _host_us(fn, calls=200, repeats=5):
    """Host microseconds per call of ``fn`` (the enqueue, on the host's
    clock; the device drains after each loop): the least and the median
    of ``repeats`` loops, since the host's clock is noisy."""
    import torch
    fn()
    out = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    out.sort()
    return dict(min=out[0], median=out[len(out) // 2])


def phase_kernel_waterfill(seed=0, path_rows=96, path_w=32):
    import numpy as np
    import torch
    from repro_torch.core.vectorized.waterfill import waterfill as plain
    from repro_torch.core.vectorized.waterfill import waterfill_rounds
    from repro_torch.kernels import waterfill as wk  # the module
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    checks = []
    worst_abs = 0.0

    def check(name, src, dst, active, caps, max_rounds=None):
        """Every route that takes the shape against the plain version:
        bitwise, or fail."""
        nonlocal worst_abs
        t = [torch.as_tensor(x, device=dev) for x in (src, dst, active, caps)]
        F, W = t[0].shape[1], t[3].shape[1]
        want = _plain_rates(plain, *t, max_rounds)
        routes = wk.ROUTES if wk.route_for(F, W) == "warp" else ("block",)
        for route in routes:
            got = wk._waterfill(t[0], t[1], t[2], t[3], t[3], max_rounds,
                                route=route)
            torch.cuda.synchronize()
            a, r, exact = _compare(got, want)
            worst_abs = max(worst_abs, a)
            checks.append(dict(case=name, route=route, rows=int(t[0].shape[0]),
                               W=W, F=F, max_rounds=max_rounds, max_abs=a,
                               max_rel=r, bitwise=exact))
            if not exact:
                emit("kernel_waterfill", checks=checks, ok=False)
                raise AssertionError(f"waterfill {route} route is not "
                                     f"bitwise equal to the plain version "
                                     f"on {name}: abs {a}, rel {r}")

    for W in (1, 8, 16, 32, 64):
        F = 4 * W
        check(f"random_W{W}", *_flow_sets(rng, 4096, W, F))
        for name, case in _edge_cases(W, F).items():
            check(f"{name}_W{W}", *case)
        check(f"random_W{W}_max_rounds_3", *_flow_sets(rng, 64, W, F),
              max_rounds=3)
    for rows in (1, 7, 33):
        check(f"random_R{rows}", *_flow_sets(rng, rows, path_w, 4 * path_w))
    check("random_W20_F100", *_flow_sets(rng, 300, 20, 100))
    check("random_path_shape", *_flow_sets(rng, path_rows, path_w,
                                           4 * path_w))

    # both routes timed in turns at the survey's full-width shape and at
    # R 4096: ms is device time of calls replayed from a CUDA graph, and
    # the eager time (CUDA events around a loop of calls) and the host's
    # enqueue time per call stand beside it
    timings = {}
    for rows in (path_rows, 4096):
        src, dst, active, caps = (torch.as_tensor(x, device=dev)
                                  for x in _flow_sets(rng, rows, path_w,
                                                      4 * path_w))

        def timed(route):
            def kernel():
                return wk._waterfill(src, dst, active, caps, caps,
                                     route=route)
            return dict(ms=cuda_graph_ms(kernel, iters=200),
                        eager_ms=cuda_time_ms(kernel, iters=200),
                        host_us=_host_us(kernel))

        by_route = _turns(wk.ROUTES, timed)
        p_ms = cuda_time_ms(lambda: plain(src, dst, active, caps, caps),
                            iters=20, warmup=2)
        _, rounds = waterfill_rounds(src, dst, active, caps, caps)
        nbytes, ops = _waterfill_work(rounds, rows, 4 * path_w, path_w)
        bound_ms, bound_by = _bound(nbytes, ops, F32_OPS_PER_S)
        warp = by_route["warp"]
        timings[rows] = dict(
            rows=rows, W=path_w, F=4 * path_w, order="warp,block,block,warp",
            routes=by_route,
            ms=sum(x["ms"] for x in warp) / len(warp), timed="cuda_graph",
            eager_ms=sum(x["eager_ms"] for x in warp) / len(warp),
            plain_ms=p_ms, rounds_mean=float(rounds.float().mean()),
            rounds_max=int(rounds.max()), bytes=nbytes, ops=ops,
            bound_ms=bound_ms, bound_by=bound_by)
    path = _path_input_timing()
    worst_abs = max(worst_abs, path["max_abs"])
    emit("kernel_waterfill", checks=checks, max_abs=worst_abs,
         all_bitwise=all(c["bitwise"] for c in checks),
         timing=list(timings.values()), path_inputs=path, card=CARD)
    return dict(max_abs_err=worst_abs, path=timings[path_rows])


def _path_input_timing(plain_sample=16):
    """K1 on the main path's own inputs: every call of one blevel run of
    the survey_full_width cell, recorded, then checked bitwise on both
    routes and replayed from a CUDA graph per route in turns; rounds per
    row from the plain version, which is timed on a sample of the calls."""
    import torch
    from repro_torch.core.vectorized.waterfill import waterfill as plain
    from repro_torch.core.vectorized.waterfill import waterfill_rounds
    from repro_torch.kernels import waterfill as wk
    calls = _record_path_inputs("blevel")
    n = len(calls)
    cat = [torch.cat([c[i] for c in calls]) for i in range(5)]
    want, rounds = waterfill_rounds(*cat)
    R, F = calls[0][0].shape
    W = calls[0][3].shape[1]
    exact, worst = {}, 0.0
    for route in wk.ROUTES:
        got = wk._waterfill(*cat, route=route)
        torch.cuda.synchronize()
        a, _, exact[route] = _compare(got, want)
        worst = max(worst, a)
    if not all(exact.values()):
        raise AssertionError(f"waterfill disagrees with the plain version "
                             f"on the main path's inputs: {exact}")

    def timed(route):
        def replay():
            for c in calls:
                wk._waterfill(*c, route=route)
        return dict(ms=cuda_graph_ms(replay, iters=1) / n,
                    eager_ms=cuda_time_ms(replay, iters=2, warmup=1) / n)

    by_route = _turns(wk.ROUTES, timed)
    step = max(1, n // plain_sample)
    sample = calls[::step][:plain_sample]
    p_ms = cuda_time_ms(lambda: [plain(*c) for c in sample], iters=2,
                        warmup=1) / len(sample)
    nbytes, ops = _waterfill_work(rounds, R * n, F, W)
    bound_ms, bound_by = _bound(nbytes / n, ops / n, F32_OPS_PER_S)
    live_rows = rounds > 0
    warp = by_route["warp"]
    return dict(calls=n, rows_per_call=R, F=F, W=W, bitwise=exact,
                max_abs=worst, order="warp,block,block,warp", routes=by_route,
                ms=sum(x["ms"] for x in warp) / len(warp),
                plain_ms=p_ms, plain_sample=len(sample),
                rounds_mean=float(rounds.float().mean()),
                rounds_mean_live_rows=float(rounds[live_rows].float().mean())
                if bool(live_rows.any()) else 0.0,
                rounds_max=int(rounds.max()),
                rows_without_live_flow=float((~live_rows).float().mean()),
                bytes_per_call=nbytes / n, ops_per_call=ops / n,
                bound_ms=bound_ms, bound_by=bound_by)


def _golden_row(name, spec_graph):
    import numpy as np
    import torch
    from repro_torch.core import parse_cluster
    from repro_torch.core.imodes import encode_imode
    from repro_torch.core.vectorized import make_bucket_dynamic_simulator
    from repro_torch.core.vectorized.specs import (encode_graph, pad_spec,
                                                   pad_to, round_up,
                                                   t_bucket)
    want = GOLDEN[name]
    spec = encode_graph(spec_graph)
    shape = (t_bucket(spec.T), round_up(spec.O), round_up(spec.E))
    cores = parse_cluster(want["cluster"])
    d, s = encode_imode(spec_graph, "exact")
    run = make_bucket_dynamic_simulator(len(cores), cores, "blevel",
                                        "maxmin", frontier=True,
                                        device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run(pad_spec(spec, shape), pad_to(d, shape[0]),
              pad_to(s, shape[1]), 0.0, 0.0, np.float32(100 * 1024 * 1024),
              0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = dict(makespan=float(res.makespan), transferred=float(
        res.transferred), n_events=int(res.n_events),
        n_steps=int(res.n_steps), ok=bool(res.ok))
    good = (got["ok"] and got["n_events"] == want["n_events"]
            and got["n_steps"] == want["n_steps"]
            and abs(got["makespan"] - want["makespan"])
            <= RTOL * abs(want["makespan"])
            and abs(got["transferred"] - want["transferred"])
            <= RTOL * abs(want["transferred"]))
    return dict(graph=name, shape=list(shape), got=got, want=want,
                match=good, wall_s=wall,
                events_per_s=got["n_events"] / wall), good


def phase_golden():
    from repro_torch.core.graphs import make_graph
    from repro_torch.kernels import WATERFILL_LAUNCHES
    WATERFILL_LAUNCHES.reset()
    rows = []
    for name, graph in (("merge_triplets", make_graph("merge_triplets",
                                                      seed=0)),
                        ("t2048_layered", t2048_graph())):
        row, good = _golden_row(name, graph)
        rows.append(row)
        if not good:
            emit("golden", rows=rows, ok=False)
            raise AssertionError(f"golden row {name} does not match: {row}")
    emit("golden", rows=rows, ok=True,
         waterfill_launches=WATERFILL_LAUNCHES.count)


def phase_survey_mini():
    from repro_torch.kernels import WATERFILL_LAUNCHES
    from repro_torch.survey import MINI_GRID, survey
    WATERFILL_LAUNCHES.reset()
    rows, _, stats = survey(MINI_GRID, out_dir=os.path.join(
        HERE, "results", "chip_smoke"), device="cuda", agreement=False)
    emit("survey_mini", rows=len(rows), sims=stats["sims"],
         groups=stats["groups"], events=stats["events"],
         wall_s=stats["wall_s"], events_per_s=stats["events_per_s"],
         all_ok=stats["all_ok"], waterfill_launches=WATERFILL_LAUNCHES.count)
    if not stats["all_ok"] or len(rows) != 512:
        raise AssertionError(f"mini survey failed: {len(rows)} rows, "
                             f"all_ok={stats['all_ok']}")


def _agreement_survey(phase, dataset, want):
    """The mini grid over ``dataset`` through ``survey(...)`` with the
    agreement pass on the card, K1's launches counted from just before
    to just after.  Returns ``(rows, stats, line, good)``: ``line`` the
    phase's fields, ``good`` whether every simulation was ok, K1 ran and
    every ratio equals ``want[(graph, scheduler)]`` within RTOL."""
    from repro_torch.kernels import WATERFILL_LAUNCHES
    from repro_torch.survey import MINI_GRID, geomean, survey
    grid = dict(MINI_GRID, dataset=dataset)
    WATERFILL_LAUNCHES.reset()
    rows, agree, stats = survey(grid, out_dir=os.path.join(
        HERE, "results", "chip_smoke", phase), device="cuda",
        agreement=True)
    launches = WATERFILL_LAUNCHES.count
    routes = dict(WATERFILL_LAUNCHES.routes)
    plain = [a for a in agree if a["graph_name"] != "__pergraph_path__"]
    per = [a for a in agree if a["graph_name"] == "__pergraph_path__"]
    ratios, worst = [], 0.0
    for a in plain:
        key = (a["graph_name"], a["scheduler_name"])
        ref = want.get(key)
        rel = (abs(a["makespan_ratio"] - ref) / abs(ref)
               if ref is not None else None)
        ratios.append(dict(graph=key[0], scheduler=key[1],
                           cluster=a["cluster_name"], bucket=a["bucket"],
                           ratio=a["makespan_ratio"], reference=ref,
                           rel_err=rel))
        worst = max(worst, rel if rel is not None else float("inf"))
    line = dict(dataset=stats["dataset"], t_edges=stats["t_edges"],
                buckets=stats["buckets"], rows=len(rows),
                sims=stats["sims"], groups=stats["groups"],
                events=stats["events"], all_ok=stats["all_ok"],
                survey_wall_s=stats["wall_s"],
                events_per_s=stats["events_per_s"],
                agreement_wall_s=stats["agreement_s"],
                speedup_geomean=(geomean([a["speedup"] for a in plain])
                                 if plain else None),
                bucket_cold_s=per[0]["bucket_cold_s"] if per else None,
                pergraph_cold_s=per[0]["pergraph_cold_s"] if per else None,
                agreement_rows=len(plain), pergraph_rows=len(per),
                ratios=ratios, worst_rel_err=worst,
                waterfill_launches=launches,
                waterfill_launch_routes=routes, card=CARD)
    good = (stats["all_ok"] and len(plain) == len(want) and len(per) == 1
            and {(r["graph"], r["scheduler"]) for r in ratios} == set(want)
            and worst <= RTOL and launches > 0)
    return rows, stats, line, good


def phase_survey_agreement():
    rows, _, line, good = _agreement_survey("survey_agreement", "default",
                                            MINI_AGREEMENT)
    good = good and len(rows) == 512
    emit("survey_agreement", **line, ok=good)
    if not good:
        raise AssertionError("survey_agreement: the mini survey's agreement "
                             "rows disagree with the reference's")
    return line["waterfill_launches"], line["waterfill_launch_routes"]


def phase_survey_dataset():
    rows, stats, line, good = _agreement_survey(
        "survey_dataset", "wfcommons-mini", DATASET_AGREEMENT)
    buckets = dict(b.split(":") for b in stats["buckets"])
    good = (good and len(rows) == 768
            and tuple(stats["t_edges"]) == DATASET_EDGES
            and buckets == {k: ",".join(v)
                            for k, v in DATASET_BUCKETS.items()})
    emit("survey_dataset", **line, ok=good)
    if not good:
        raise AssertionError("survey_dataset: the wfcommons-mini survey "
                             "disagrees with the reference's")
    return line["waterfill_launches"], line["waterfill_launch_routes"]


def _full_width_agreement(sched, res, points):
    """Agreement rows of the T512 bucket on 32x4 at point 0: the kernel
    run's batched makespan over the reference event loop's twin, each
    held against the reference's recorded values."""
    from repro_torch.core import parse_cluster
    from repro_torch.survey import time_reference_twin
    _, grp, _, _ = _full_width_group()
    cores = parse_cluster("32x4")
    out = []
    for b, gname in enumerate(grp.names):
        want_vec, want_twin = FULL_WIDTH_AGREEMENT[(sched, gname)]
        reps, ref_us = time_reference_twin(gname, sched, len(cores), cores,
                                           points[:1])
        vec = float(res.makespan[0, b, 0])
        twin = reps[0].makespan
        out.append(dict(
            graph=gname, batched=vec, twin=twin, ratio=vec / twin,
            ref_us=ref_us, reference_batched=want_vec,
            reference_twin=want_twin, twin_equal=twin == want_twin,
            batched_rel_err=(abs(vec - want_vec) / abs(want_vec)
                             if want_vec is not None else None)))
    return out


def phase_survey_full_width(schedulers=("blevel", "greedy")):
    import numpy as np
    import torch
    from repro_torch.kernels import WATERFILL_LAUNCHES
    _, grp, _, points = _full_width_group()
    out = []
    main_path = dict(count=0, routes=dict.fromkeys(WATERFILL_LAUNCHES.routes,
                                                   0))
    for sched in schedulers:
        runners = {impl: _full_width_runner(sched, impl)
                   for impl in ("auto", "torch")}
        res = {"auto": [], "torch": []}
        # in turns (plain, kernel, kernel, plain) on one card, so host
        # noise does not favour either side
        for impl in ("torch", "auto", "auto", "torch"):
            # the main path's own count: zeroed just before, read just after
            WATERFILL_LAUNCHES.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = runners[impl](points)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            res[impl].append((r, wall, WATERFILL_LAUNCHES.count,
                              dict(WATERFILL_LAUNCHES.routes)))
        ra, la, routes = (res["auto"][0][i] for i in (0, 2, 3))
        rt, lt = res["torch"][0][0], res["torch"][0][2]
        main_path["count"] += la
        for k, v in routes.items():
            main_path["routes"][k] += v
        runs = [x[0] for impl in res for x in res[impl]]
        same_counts = all(np.array_equal(getattr(x, f), getattr(rt, f))
                          for x in runs
                          for f in ("ok", "n_events", "n_steps"))
        ms_rel = max(float(np.max(np.abs(x.makespan - rt.makespan)
                                  / np.abs(rt.makespan))) for x in runs)
        x_rel = max(float(np.max(np.abs(x.transferred - rt.transferred)
                                 / np.maximum(np.abs(rt.transferred), 1.0)))
                    for x in runs)
        ev = int(ra.n_events.sum())
        k_walls = [x[1] for x in res["auto"]]
        p_walls = [x[1] for x in res["torch"]]
        row = dict(scheduler=sched, bucket=grp.label, graphs=list(grp.names),
                   cluster="32x4", points=len(points),
                   rows=int(ra.ok.size), all_ok=bool(ra.ok.all()),
                   events=ev, max_steps=int(ra.n_steps.max()),
                   order="plain,kernel,kernel,plain",
                   kernel_wall_s=k_walls,
                   kernel_events_per_s=[ev / w for w in k_walls],
                   plain_wall_s=p_walls,
                   plain_events_per_s=[ev / w for w in p_walls],
                   kernel_launches=[x[2] for x in res["auto"]],
                   kernel_launch_routes=[x[3] for x in res["auto"]],
                   plain_launches=[x[2] for x in res["torch"]],
                   counts_equal=same_counts, makespan_max_rel=ms_rel,
                   transferred_max_rel=x_rel,
                   bitwise_makespan=all(np.array_equal(x.makespan,
                                                       rt.makespan)
                                        for x in runs))
        if sched == "blevel":
            # one more kernel run, outside the timed turns, under the
            # profiler: how busy the card is during a survey, and K1's
            # share of its device time
            row["profile"] = _device_profile(lambda: runners["auto"](points))
        # the agreement at full width, after the timed turns: the first
        # kernel run's makespans at point 0 against the twins
        agree = _full_width_agreement(sched, ra, points)
        row["agreement"] = agree
        agree_ok = all(a["twin_equal"] and (a["batched_rel_err"] is None
                                            or a["batched_rel_err"] <= RTOL)
                       for a in agree)
        out.append(row)
        if not (row["all_ok"] and same_counts and ms_rel <= RTOL
                and x_rel <= RTOL and la > 0 and lt == 0
                and routes["warp"] == la and agree_ok
                and all(n == 0 for n in row["plain_launches"])):
            emit("survey_full_width", rows=out, ok=False)
            raise AssertionError(f"full-width group disagrees: {row}")
    ratios = [a["ratio"] for r in out for a in r["agreement"]]
    emit("survey_full_width", rows=out, ok=True, card=CARD,
         agreement_worst_abs_ratio_minus_1=max(abs(x - 1) for x in ratios),
         waterfill_launches=main_path["count"],
         waterfill_launch_routes=main_path["routes"])
    return main_path


# ------------------------------------------------------- LM kernels, serve
def _bound(nbytes, ops, ops_per_s):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the peak rate for their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _close(got, want, atol, rtol):
    """(max abs error, every element within atol + rtol * |want|)."""
    got, want = got.double(), want.double()
    err = (got - want).abs()
    ok = bool((err <= atol + rtol * want.abs()).all()) \
        and bool(got.isfinite().all())
    return float(err.max()), ok


# name, B, Hq, Hkv, Sq, Skv, D, kv_len, window, causal, cache layout
ATTN_CASES = (
    ("prefill_w1024", 4, 25, 5, 1536, 1568, 64, 1536, 1024, True, True),
    ("prefill_w0", 4, 25, 5, 1536, 1568, 64, 1536, 0, True, True),
    ("decode_w1024", 4, 25, 5, 1, 1568, 64, 1552, 1024, True, True),
    ("decode_w0", 4, 25, 5, 1, 1568, 64, 1552, 0, True, True),
    ("gemma3_d256", 2, 4, 1, 512, 512, 256, 512, 256, True, False),
    ("mqa_d32", 2, 8, 1, 300, 300, 32, 300, 0, True, False),
    ("noncausal_d16", 2, 4, 2, 100, 100, 16, 100, 0, False, False),
)
ATTN_PATH = ("prefill_w1024", "prefill_w0", "decode_w1024", "decode_w0")
# bfloat16 only: the edges of the tensor-core (Sq > 1) and split (Sq 1)
# routes
ATTN_EDGE_CASES = (
    # Sq, Skv, kv_len off the 64 tile; window ends inside a tile;
    # kv_len < Skv at prefill
    ("edge_sq1000_w100", 2, 8, 2, 1000, 1100, 64, 1030, 100, True, True),
    ("edge_d256_sq600_w100", 1, 8, 2, 600, 650, 256, 630, 100, True, True),
    ("edge_noncausal_w64", 2, 4, 1, 130, 200, 32, 190, 64, False, False),
    ("edge_decode_kv1", 4, 25, 5, 1, 1568, 64, 1, 0, True, True),
    ("edge_decode_1split", 4, 25, 5, 1, 1568, 64, 30, 0, True, True),
    ("edge_decode_7splits", 4, 25, 5, 1, 1568, 64, 200, 0, True, True),
    ("edge_decode_w100", 4, 25, 5, 1, 1568, 64, 1000, 100, True, True),
    ("edge_decode_d256_g12", 1, 12, 1, 1, 300, 256, 250, 0, True, True),
    ("edge_decode_d16", 2, 6, 2, 1, 300, 16, 299, 0, True, False),
)


def _attn_inputs(case, dtype, seed):
    import torch
    _, B, Hq, Hkv, Sq, Skv, D, _, _, _, cache_layout = case
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    q = randn(B, Sq, Hq, D).transpose(1, 2)
    if cache_layout:     # the model's KV cache [B, S, Hkv, D], transposed
        k = randn(B, Skv, Hkv, D).transpose(1, 2)
        v = randn(B, Skv, Hkv, D).transpose(1, 2)
    else:
        k, v = randn(B, Hkv, Skv, D), randn(B, Hkv, Skv, D)
    return q, k, v


def _attn_work(case, itemsize):
    """(bytes, operations) this call needs: q read and o written once,
    each key and value that some query sees read once; 4 D operations
    per visible (query, key) pair."""
    from repro_torch.kernels.ref import attention_mask
    _, B, Hq, Hkv, Sq, Skv, D, kv_len, window, causal, _ = case
    mask = attention_mask(Sq, Skv, causal=causal, window=window,
                          kv_len=kv_len, device="cuda")
    keys = int(mask.any(dim=0).sum())
    nbytes = (2 * B * Hq * Sq * D + 2 * B * Hkv * keys * D) * itemsize
    ops = 4 * D * int(mask.sum()) * B * Hq
    return nbytes, ops, mask


def cuda_graph_ms(fn, iters=20):
    """Device time of one call of ``fn``, from ``iters`` calls captured
    in a CUDA graph and replayed (no host cost per call)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _check_split_kernels(case, seed, tol_bf16):
    """The split route's two kernels alone: the partials against
    ``ref.attention_partials`` (float32 sums over up to 128 keys in
    another order: atol/rtol 1e-4), the combine kernel against
    ``ref.combine_splits`` on the same partials (the bfloat16 limits)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    name, B, Hq, Hkv, Sq, Skv, D, kv_len, window, causal, _ = case
    q, k, v = _attn_inputs(case, torch.bfloat16, seed)
    plan, (o, m, l) = fa.split_partials(q, k, v, window=window,
                                        kv_len=kv_len)
    bounds = fa.split_bounds(*plan, kv_len)
    wo, wm, wl = ref.attention_partials(q, k, v, bounds, causal=causal,
                                        window=window, kv_len=kv_len)
    got = fa.combine_splits(o, m, l)
    want = ref.combine_splits(o[..., None, :], m[..., None], l[..., None],
                              torch.bfloat16)
    torch.cuda.synchronize()
    errs = [_close(x, y[..., 0, :] if y.dim() == 5 else y[..., 0],
                   1e-4, 1e-4) for x, y in ((o, wo), (m, wm), (l, wl))]
    c_err, c_ok = _close(got.float(), want.float(), *tol_bf16)
    row = dict(case=name, splits=plan[2], keys_per_split=plan[1],
               partials_max_abs=max(e for e, _ in errs),
               partials_ok=all(ok for _, ok in errs),
               combine_max_abs=c_err, combine_ok=c_ok)
    row["ok"] = row["partials_ok"] and c_ok
    return row


def phase_kernel_flash_attention(seed=0):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     route_for, split_plan)
    # (atol, rtol): float32 to rounding; bfloat16 about two units in the
    # last place of the output
    tol = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (4e-3, 8e-3)}
    checks, timings, split_checks = [], {}, []
    worst = 0.0
    runs = [(dtype, i, case) for dtype in (torch.float32, torch.bfloat16)
            for i, case in enumerate(ATTN_CASES)]
    runs += [(torch.bfloat16, len(ATTN_CASES) + i, case)
             for i, case in enumerate(ATTN_EDGE_CASES)]
    for dtype, i, case in runs:
        name, B, Hq, Hkv, Sq, Skv, D, kv_len, window, causal, _ = case
        q, k, v = _attn_inputs(case, dtype, seed + i)
        kw = dict(causal=causal, window=window, kv_len=kv_len)
        got = flash_attention(q, k, v, **kw)
        want = ref.attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err, ok = _close(got.float(), want.float(), *tol[dtype])
        worst = max(worst, err)
        checks.append(dict(case=name, dtype=str(dtype)[6:], max_abs=err,
                           atol=tol[dtype][0], rtol=tol[dtype][1],
                           route=route_for(dtype, Sq), ok=ok,
                           out_dtype=str(got.dtype)[6:]))
        if not ok or got.dtype != q.dtype:
            emit("kernel_flash_attention", card=CARD, checks=checks,
                 ok=False)
            raise AssertionError(f"flash attention kernel disagrees "
                                 f"with the plain version: {checks[-1]}")
        if dtype != torch.bfloat16:
            continue
        if Sq == 1:
            split_checks.append(_check_split_kernels(
                case, seed + i, tol[torch.bfloat16]))
            if not split_checks[-1]["ok"]:
                emit("kernel_flash_attention", card=CARD, checks=checks,
                     split_checks=split_checks, ok=False)
                raise AssertionError(f"split route kernels disagree with "
                                     f"their plain versions: "
                                     f"{split_checks[-1]}")
        if name not in ATTN_PATH:
            continue
        nbytes, ops, mask = _attn_work(case, q.element_size())
        bound_ms, bound_by = _bound(nbytes, ops, BF16_OPS_PER_S)
        ke = k.repeat_interleave(Hq // Hkv, dim=1).contiguous()
        ve = v.repeat_interleave(Hq // Hkv, dim=1).contiguous()
        qc = q.contiguous()
        iters = 20 if Sq > 1 else 200
        k_ms = cuda_time_ms(lambda: flash_attention(q, k, v, **kw),
                            iters=iters)
        p_ms = cuda_time_ms(lambda: ref.attention_ref(q, k, v, **kw),
                            iters=max(iters // 10, 3), warmup=2)
        lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qc, ke, ve, attn_mask=mask), iters=iters)
        lib_err = float((F.scaled_dot_product_attention(
            qc, ke, ve, attn_mask=mask).float() - want.float())
            .abs().max())
        row = dict(case=name, dtype="bfloat16", route=route_for(dtype, Sq),
                   timed="eager", ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                   library_max_abs=lib_err, bytes=nbytes, ops=ops,
                   bound_ms=bound_ms, bound_by=bound_by)
        if Sq == 1:
            # one decode call is shorter on the card than on the host's
            # clock, so an eager loop times the host: ms and library_ms
            # are device times (CUDA graph) here, the eager times beside
            row.update(timed="cuda_graph", eager_ms=k_ms,
                       library_eager_ms=lib_ms,
                       splits=split_plan(kv_len, window, B, Hkv, Hq)[2],
                       ms=cuda_graph_ms(lambda: flash_attention(q, k, v,
                                                                **kw)),
                       library_ms=cuda_graph_ms(
                           lambda: F.scaled_dot_product_attention(
                               qc, ke, ve, attn_mask=mask)))
        row.update(frac_of_bound=bound_ms / row["ms"],
                   vs_library=row["library_ms"] / row["ms"])
        timings[name] = row
    emit("kernel_flash_attention", card=CARD, checks=checks,
         split_checks=split_checks, max_abs=worst,
         timing=list(timings.values()), ok=True)
    return dict(max_abs_err=worst, path=timings["prefill_w1024"],
                timing=timings)


def _ssd_inputs(Bt, L, H, P, N, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.rand(*shape, generator=g, device="cuda")

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    return (randn(Bt, L, H, P), 0.001 + 0.099 * rand(Bt, L, H),
            -(0.5 + 1.5 * rand(H)), randn(Bt, L, N), randn(Bt, L, N),
            randn(H))


def _ssd_work(Bt, L, H, P, N, Q=64):
    """(bytes, operations): every input read once, y and the final state
    written once; per (batch, head, chunk) the causal C Bᵀ and G (dt x)
    products, the inter-chunk term, the state update and the skip."""
    tri = Q * (Q + 1) // 2
    per_chunk = 2 * tri * N + 2 * tri * P + 2 * Q * N * P \
        + 2 * N * P * Q + 2 * N * P + 2 * Q * P
    ops = per_chunk * Bt * H * (L // Q)
    nbytes = 4 * (2 * Bt * L * H * P + Bt * L * H + 2 * H + 2 * Bt * L * N
                  + Bt * H * N * P)
    return nbytes, ops


# name, Bt, L, H, P, N, chunk, (A, dt) held constant or None; the first
# two are the models' prefill shapes and are timed
SSD_CASES = (
    ("hymba", 4, 1536, 50, 64, 16, 64, None),
    ("mamba2_130m", 4, 1536, 24, 64, 128, 64, None),
    ("single_chunk", 2, 64, 6, 64, 16, 64, None),
    ("chunk32", 2, 256, 10, 64, 16, 32, None),
    ("n128_p32", 1, 128, 3, 32, 128, 64, None),
    # 53 heads: the last head group of both phases runs short
    ("ragged_group_h53", 4, 1536, 53, 64, 16, 64, None),
    ("p16", 2, 512, 12, 16, 16, 64, None),
    # exp(cum_i - cum_j) grows to e^50 above the diagonal: Γ's select
    ("strong_decay", 2, 256, 8, 64, 16, 64, (-8.0, 0.1)),
    # Q, P and N off a multiple of 4: padded tiles, 4-byte copies
    ("odd_q9_p10_n6", 2, 36, 3, 10, 6, 9, None),
    ("smoke_serve_l8", 2, 8, 4, 16, 8, 64, None),
)
SSD_TIMED = ("hymba", "mamba2_130m")
# the single-kernel K3 that the three-phase design replaced, at Hymba's
# shape (PERF.md §6; NVIDIA H100 80GB HBM3, 700 W)
SSD_EARLIER_MS = 0.8908240318298339


def _ssd_case_inputs(case, seed):
    import torch
    _, Bt, L, H, P, N, _, decay = case
    x, dt, A, B, C, D = _ssd_inputs(Bt, L, H, P, N, seed)
    if decay is not None:
        A, dt = torch.full_like(A, decay[0]), torch.full_like(dt, decay[1])
    return x, dt, A, B, C, D


def phase_kernel_ssd(seed=0):
    """Each of K3's three kernels alone against its plain piece, fed the
    plain piece's inputs, and the whole call against ``ssd_chunked`` and
    the sequential final state, all at atol/rtol 1e-4; times at the
    models' prefill shapes, each phase alone at Hymba's."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd as sk
    out, worst, timings = [], 0.0, {}
    for i, case in enumerate(SSD_CASES):
        name, Bt, L, H, P, N, chunk, _ = case
        x, dt, A, B, C, D = _ssd_case_inputs(case, seed + i)
        S_ref, tot_ref = ref.ssd_chunk_states(x, dt, A, B, chunk=chunk)
        h_ref, fin_ref = ref.ssd_pass_states(S_ref, tot_ref)
        y_ref = ref.ssd_chunked(x, dt, A, B, C, D, chunk=chunk)
        got = dict(S_loc=sk.chunk_states(x, dt, A, B, chunk=chunk))
        got["pass"] = sk.pass_states(S_ref, tot_ref)
        got["scan"] = sk.chunk_scan(x, dt, A, B, C, D, h_ref, chunk=chunk)
        got["ssd_scan"] = sk.ssd_scan(x, dt, A, B, C, D, chunk=chunk,
                                      return_state=True)
        torch.cuda.synchronize()
        pairs = dict(
            chunk_state_S=(got["S_loc"][0], S_ref),
            chunk_state_total=(got["S_loc"][1], tot_ref),
            state_pass_h_in=(got["pass"][0], h_ref),
            state_pass_final=(got["pass"][1], fin_ref),
            chunk_scan_y=(got["scan"], ref.ssd_chunk_scan(
                x, dt, A, B, C, D, h_ref, chunk=chunk)),
            y=(got["ssd_scan"][0], y_ref),
            state=(got["ssd_scan"][1], ref.ssd_final_state(x, dt, A, B)))
        errs = {k: _close(a, w, 1e-4, 1e-4) for k, (a, w) in pairs.items()}
        row = dict(case=name, Bt=Bt, L=L, H=H, P=P, N=N,
                   Q=min(chunk, L), max_abs={k: e for k, (e, _) in
                                             errs.items()},
                   ok=all(ok for _, ok in errs.values()))
        worst = max([worst] + [e for e, _ in errs.values()])
        out.append(row)
        if not row["ok"]:
            emit("kernel_ssd", card=CARD, rows=out, ok=False)
            raise AssertionError(f"ssd kernels disagree with their plain "
                                 f"versions: {row}")
        if name not in SSD_TIMED:
            continue
        Q = min(chunk, L)
        nbytes, ops = _ssd_work(Bt, L, H, P, N, Q)
        bound_ms, bound_by = _bound(nbytes, ops, F32_OPS_PER_S)
        k_ms = cuda_time_ms(lambda: sk.ssd_scan(x, dt, A, B, C, D,
                                                return_state=True), iters=20)
        p_ms = cuda_time_ms(lambda: ref.ssd_chunked(x, dt, A, B, C, D),
                            iters=3, warmup=1)
        # each phase alone, on the call's own scratch (the pass rewrites
        # its buffer in place on every launch; its time does not depend
        # on the values)
        S, tot = got["S_loc"]
        h_in = S.clone()
        state = torch.empty_like(got["ssd_scan"][1])
        phase_ms = dict(
            chunk_state=cuda_time_ms(
                lambda: sk._chunk_states(x, dt, A, B, Q), iters=20),
            state_pass=cuda_time_ms(
                lambda: sk._pass_states(h_in, tot, state), iters=20),
            chunk_scan=cuda_time_ms(
                lambda: sk._chunk_scan(x, dt, A, B, C, D, S, Q), iters=20))
        row.update(ms=k_ms, phase_ms=phase_ms, earlier_ms=(
            SSD_EARLIER_MS if name == "hymba" else None), plain_ms=p_ms,
            library_ms=None, bytes=nbytes, ops=ops, bound_ms=bound_ms,
            bound_by=bound_by, frac_of_bound=bound_ms / k_ms)
        timings[name] = row
    emit("kernel_ssd", card=CARD, rows=out, max_abs=worst, ok=True)
    return dict(max_abs_err=worst, path=timings["hymba"])


def _device_profile(fn):
    """Wall time, device busy time and idle share of one call of ``fn``,
    and the device time of K1 and of the top kernels, from the raw device
    events of ``torch.profiler`` with CUDA activity only: a survey run
    makes some 500,000 device events, whose summary by ``key_averages``
    takes minutes, and recording no host ops slows the host less (the
    idle share is still an upper bound)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, events = {}, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            events += 1
            by_name[e.name()] = by_name.get(e.name(), 0) + e.duration_ns()
    if not events:
        raise AssertionError("the profiled run recorded no device event")
    busy_ms = sum(by_name.values()) / 1e6
    # K1: both kernels of csrc/waterfill.cu are named waterfill_*
    k1_ms = sum(v for k, v in by_name.items() if "waterfill_" in k) / 1e6
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:10]
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_idle_share=1 - busy_ms / wall_ms,
                device_events=events, k1_device_ms=k1_ms,
                k1_share=k1_ms / busy_ms,
                top_device=[(k[:70], v / 1e6) for k, v in top])


def _profile(fn):
    """Wall time, device busy time and the top device kernels and host
    ops of one call of ``fn`` under ``torch.profiler`` (the profiler
    slows the host, so the idle share is an upper bound)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avg = prof.key_averages()
    # device-side events only (kernels, copies): a host op's device time
    # repeats the time of the kernels it launched
    on_dev = [e for e in avg if e.device_type == DeviceType.CUDA]
    on_host = [e for e in avg if e.device_type == DeviceType.CPU]
    busy_ms = sum(e.self_device_time_total for e in on_dev) / 1e3
    # K2: every kernel of csrc/flash_attention.cu is named flash_*
    k2_ms = sum(e.self_device_time_total for e in on_dev
                if "flash_" in e.key) / 1e3
    # K3: every kernel of csrc/ssd.cu is named ssd_*
    k3_ms = sum(e.self_device_time_total for e in on_dev
                if e.key.startswith("ssd_") or "::ssd_" in e.key) / 1e3
    top_dev = sorted(on_dev, key=lambda e: e.self_device_time_total,
                     reverse=True)[:10]
    top_host = sorted(on_host, key=lambda e: e.self_cpu_time_total,
                      reverse=True)[:10]
    return dict(wall_ms=wall * 1e3, device_busy_ms=busy_ms,
                device_idle_share=1 - busy_ms / (wall * 1e3),
                device_events=sum(e.count for e in on_dev),
                k2_device_ms=k2_ms, k2_share=k2_ms / busy_ms,
                k3_device_ms=k3_ms, k3_share=k3_ms / busy_ms,
                top_device=[(e.key[:70], e.self_device_time_total / 1e3,
                             e.count) for e in top_dev],
                top_host=[(e.key[:70], e.self_cpu_time_total / 1e3,
                           e.count) for e in top_host])


def _profile_serve(model, prompts, forced, cache_len):
    """Profiles of one prefill and of two decode steps (bf16 model)."""
    from repro_torch.models import decode_step, prefill
    state = {}

    def run_prefill():
        state["out"] = prefill(model, prompts, cache_len=cache_len)

    def run_decode():
        _, cache, pos = state["out"]
        for i in range(forced.shape[1]):
            _, cache, pos = decode_step(model, forced[:, i:i + 1], cache,
                                        pos)

    return dict(prefill=_profile(run_prefill),
                decode_steps=forced.shape[1], decode=_profile(run_decode))


def phase_serve_hymba(seed=0, gen=32, prompt_len=1536, forced=4):
    import gc

    import torch
    from repro_torch.kernels import FLASH_ATTENTION_LAUNCHES as FA
    from repro_torch.kernels import SSD_LAUNCHES as SS
    from repro_torch.launch import serve
    from repro_torch.models import decode_step, init_params, prefill
    dev = torch.device("cuda")
    argv = ["--arch", "hymba-1.5b", "--batch", "4", "--prompt-len",
            str(prompt_len), "--gen", str(gen), "--seed", str(seed)]
    # the main path's own counts: zeroed just before, read just after
    FA.reset()
    SS.reset()
    torch.cuda.reset_peak_memory_stats()
    res = serve.main(argv)
    torch.cuda.synchronize()
    launches = dict(flash_attention=FA.count, ssd=SS.count)
    routes = dict(FA.routes)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg = res["cfg"]
    del res["model"]
    # a second, warm run of the same entry point (the first one pays for
    # first-use set-up: library handles, module loading), then a profile
    warm = serve.main(argv)
    profile = _profile_serve(warm["model"], warm["prompts"],
                             warm["tokens"][:, :2], prompt_len + gen)
    warm = dict({k: warm[k] for k in ("prefill_ms", "decode_ms_per_token",
                                      "tokens_per_s")},
                same_tokens=bool(torch.equal(warm["tokens"], res["tokens"])))
    gc.collect()
    torch.cuda.empty_cache()
    want = dict(flash_attention=cfg.n_layers * (gen + 1), ssd=cfg.n_layers)
    # bf16: the tensor-core route at prefill, the split route at decode
    want_routes = dict(tc=cfg.n_layers, split=cfg.n_layers * gen, f32=0)
    tokens, prompts = res["tokens"], res["prompts"]
    bf16 = dict(dtype=cfg.dtype, batch=4, prompt=prompt_len, gen=gen,
                params=cfg.param_count(),
                prefill_ms=res["prefill_ms"],
                decode_ms_per_token=res["decode_ms_per_token"],
                tokens_per_s=res["tokens_per_s"], warm_run=warm,
                profile=profile, peak_mem_gb=peak_gb,
                launches=launches, launches_expected=want,
                launch_routes=routes, launch_routes_expected=want_routes,
                tokens_in_vocab=bool((tokens >= 0).all()
                                     and (tokens < cfg.vocab_size).all()),
                first_tokens=tokens[0, :8].tolist())
    del res
    gc.collect()
    torch.cuda.empty_cache()
    if launches != want or routes != want_routes \
            or not bf16["tokens_in_vocab"] or tokens.shape != (4, gen):
        emit("serve_hymba", card=CARD, bf16=bf16, ok=False)
        raise AssertionError(f"serve_hymba: bf16 run wrong: {bf16}")

    # float32: the same prompt, kernels vs plain versions on the card
    cfg32 = dataclasses.replace(cfg, dtype="float32", max_cache_len=0)
    g = torch.Generator(device=dev).manual_seed(seed)
    model = init_params(cfg32, g, device=dev)
    teacher = tokens[:, :forced]
    runs = {}
    for impl in ("auto", "torch"):
        FA.reset()
        SS.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache, pos = prefill(model, prompts,
                                     cache_len=prompt_len + forced, impl=impl)
        outs = [logits]
        for i in range(forced):
            logits, cache, pos = decode_step(model, teacher[:, i:i + 1],
                                             cache, pos, impl=impl)
            outs.append(logits)
        torch.cuda.synchronize()
        runs[impl] = dict(logits=outs, wall_s=time.perf_counter() - t0,
                          launches=dict(flash_attention=FA.count,
                                        ssd=SS.count),
                          routes=dict(FA.routes))
        del cache
    steps = []
    ok = True
    for i, (a, b) in enumerate(zip(runs["auto"]["logits"],
                                   runs["torch"]["logits"])):
        err, close = _close(a, b, 1e-3, 1e-3)
        same = bool(torch.equal(a.argmax(-1), b.argmax(-1)))
        steps.append(dict(step=i, max_abs=err, close=close,
                          greedy_equal=same,
                          logit_absmax=float(b.abs().max())))
        ok = ok and close and same
    f32 = dict(dtype="float32", forced_steps=forced,
               kernel_wall_s=runs["auto"]["wall_s"],
               plain_wall_s=runs["torch"]["wall_s"],
               kernel_launches=runs["auto"]["launches"],
               plain_launches=runs["torch"]["launches"],
               kernel_launch_routes=runs["auto"]["routes"], steps=steps)
    ok = ok and runs["torch"]["launches"] == dict(flash_attention=0, ssd=0) \
        and runs["auto"]["launches"] == dict(
            flash_attention=cfg32.n_layers * (forced + 1),
            ssd=cfg32.n_layers) \
        and runs["auto"]["routes"] == dict(
            tc=0, split=0, f32=cfg32.n_layers * (forced + 1))
    emit("serve_hymba", card=CARD, bf16=bf16, f32=f32, ok=ok)
    if not ok:
        raise AssertionError("serve_hymba: the kernel path disagrees with "
                             "the plain path in float32")
    del model, runs
    gc.collect()
    torch.cuda.empty_cache()
    return launches, routes


# ------------------------------------------------------------------ main
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of phases (default all)")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; the port's smoke "
              "run needs one card", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401 — fails outside a checkout of the repo
    # float32 products in full float32 on the card (no TF32), as the
    # plain versions and the reference compute them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    smi = phase_env()
    if "build" in phases:
        phase_build()
    wf = None
    if "kernel_waterfill" in phases:
        wf = phase_kernel_waterfill()
    if "golden" in phases:
        phase_golden()
    if "survey_mini" in phases:
        phase_survey_mini()
    launches = {}
    k1 = []          # (launches, by route) of each of K1's path phases
    if "survey_agreement" in phases:
        k1.append(phase_survey_agreement())
    if "survey_dataset" in phases:
        k1.append(phase_survey_dataset())
    if "survey_full_width" in phases:
        main_path = phase_survey_full_width()
        k1.append((main_path["count"], main_path["routes"]))
    k1_routes = None
    if k1:
        launches["waterfill"] = sum(n for n, _ in k1)
        k1_routes = {r: sum(rt[r] for _, rt in k1) for r in k1[0][1]}
    fa = ss = None
    if "kernel_flash_attention" in phases:
        fa = phase_kernel_flash_attention()
    if "kernel_ssd" in phases:
        ss = phase_kernel_ssd()
    k2_routes = None
    if "serve_hymba" in phases:
        serve_launches, k2_routes = phase_serve_hymba()
        launches.update(serve_launches)
    kernels = []
    for name, res, src, replaces, lib in (
            ("waterfill", wf, "waterfill.cu",
             "src/repro/kernels/waterfill.py:30", False),
            ("flash_attention", fa, "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:25", True),
            ("ssd", ss, "ssd.cu", "src/repro/kernels/ssd.py:24", False)):
        if res is None:
            continue
        # launches: null unless this run drove the kernel's path
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{src}",
            replaces=replaces, launches=launches.get(name),
            max_abs_err=res["max_abs_err"], ms=res["path"]["ms"],
            plain_ms=res["path"]["plain_ms"],
            bound_ms=res["path"]["bound_ms"],
            bound_by=res["path"]["bound_by"],
            library_ms=res["path"]["library_ms"] if lib else None))
        # the main path's launches by route (null without its phase)
        if name == "waterfill":
            kernels[-1]["launch_routes"] = k1_routes
        if name == "flash_attention":
            kernels[-1]["launch_routes"] = k2_routes
    if "kernels" in phases:
        emit("kernels", kernels=[dict(name=k["name"],
                                      launches=k["launches"],
                                      held_against_plain=True)
                                 for k in kernels],
             total_s=time.perf_counter() - t_start)
        # every kernel held against its plain version and launched on its
        # path in this run
        checked = {k["name"] for k in kernels}
        missing = sorted({"waterfill", "flash_attention", "ssd"}
                         - (checked & set(launches)))
        if missing:
            raise AssertionError(
                f"the kernels phase needs every kernel's check and path "
                f"phases; not run for {missing}")
        never = sorted(n for n, c in launches.items() if c <= 0)
        if never:
            raise AssertionError(f"the main path never launched {never}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
