"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                 # every phase, one card

Drives the port's main path — the paper survey's batched dynamic
simulator with the max-min waterfill kernel — through the entry points
a user calls, and checks it.  Phases, each printing one JSON line:

1. ``env``: the card's name and power limit.
2. ``build``: compiles every CUDA kernel of the port from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, started
   together) and prints the seconds taken.
3. ``kernel_waterfill``: the waterfill kernel against its plain PyTorch
   version on the card — random flow sets at R = 4096 rows for
   W in {8, 16, 32} (F = 4W) plus edge cases, bitwise equality expected
   (fails above rtol 1e-6) — and both versions timed with CUDA events at
   the survey's shape.
4. ``golden``: the dynamic simulator against the reference package's
   recorded ``BENCH_PR7.json`` dynamic rows (blevel, maxmin, frontier
   on, 100 MiB/s, exact imode, msd 0).
5. ``survey_mini``: the mini survey grid; every simulation must be ok.
6. ``survey_full_width``: the full grid's T512 bucket on cluster 32x4
   (W = 32, 128 flow slots, 64 resources), all 24 points, blevel and
   greedy on maxmin, through the plain version and the kernel in turns
   (plain, kernel, kernel, plain) on the card; the results must agree
   and the kernel's launch count must be positive.
7. ``kernels``: each kernel with its launches on the main path.

The last lines are the card's ``nvidia-smi`` name and power limit, the
``{"kernels": [...]}`` summary, and ``{"ok": true, "device": ...}``.
Any failure raises and exits non-zero.  Imports nothing of JAX or of
the reference package.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

PHASES = ("env", "build", "kernel_waterfill", "golden", "survey_mini",
          "survey_full_width", "kernels")

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

# peak rates of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
# non-tensor float32 operations/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


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
    line = nvidia_smi_line()
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
    return cases


def _compare(got, want):
    import torch
    got, want = got.double(), want.double()
    abs_err = (got - want).abs()
    rel = abs_err / want.abs().clamp(min=1e-30)
    return (float(abs_err.max()) if abs_err.numel() else 0.0,
            float(rel.max()) if rel.numel() else 0.0,
            bool(torch.equal(got, want)))


def _waterfill_work(rates, active, F, W):
    """(bytes, operations) the function needs on these inputs: each
    input read once and the output written once; per row, rounds x
    (4F count/use increments + 12W share, min, test and capacity ops),
    rounds taken as the row's distinct frozen rates."""
    import torch
    R = rates.shape[0]
    nbytes = R * (F * 4 * 2 + F * 1 + W * 4 * 2 + F * 4)
    masked = torch.where(active, rates, torch.full_like(rates, -1.0))
    srt = masked.sort(dim=1).values
    distinct = ((srt[:, 1:] != srt[:, :-1]) & (srt[:, 1:] > 0)).sum(dim=1)
    distinct = distinct + (srt[:, 0] > 0).long()
    ops = int(distinct.sum()) * (4 * F + 12 * W)
    return nbytes, ops


def phase_kernel_waterfill(seed=0, path_rows=96, path_w=32):
    import numpy as np
    import torch
    from repro_torch.core.vectorized.waterfill import waterfill as plain
    from repro_torch.kernels import waterfill as wk  # the module
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    checks = []
    worst_abs, worst_rel = 0.0, 0.0

    def check(name, src, dst, active, caps):
        nonlocal worst_abs, worst_rel
        t = [torch.as_tensor(x, device=dev) for x in (src, dst, active, caps)]
        got = wk.waterfill(t[0], t[1], t[2], t[3], t[3])
        want = plain(t[0], t[1], t[2], t[3], t[3])
        torch.cuda.synchronize()
        a, r, exact = _compare(got, want)
        worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
        checks.append(dict(case=name, rows=int(src.shape[0]),
                           W=int(caps.shape[1]), F=int(src.shape[1]),
                           max_abs=a, max_rel=r, bitwise=exact))
        if r > 1e-6:
            raise AssertionError(f"waterfill kernel disagrees with the "
                                 f"plain version on {name}: rel {r}")

    for W in (8, 16, 32):
        check(f"random_W{W}", *_flow_sets(rng, 4096, W, 4 * W))
        for name, case in _edge_cases(W, 4 * W).items():
            check(f"{name}_W{W}", *case)
    check("random_W1", *_flow_sets(rng, 256, 1, 4))
    check("random_path_shape", *_flow_sets(rng, path_rows, path_w,
                                           4 * path_w))

    # timing at the survey's full-width shape and at R = 4096
    timings = {}
    for rows in (path_rows, 4096):
        src, dst, active, caps = (torch.as_tensor(x, device=dev)
                                  for x in _flow_sets(rng, rows, path_w,
                                                      4 * path_w))
        k_ms = cuda_time_ms(lambda: wk.waterfill(src, dst, active, caps,
                                                 caps), iters=200)
        p_ms = cuda_time_ms(lambda: plain(src, dst, active, caps, caps),
                            iters=20, warmup=2)
        rates = plain(src, dst, active, caps, caps)
        nbytes, ops = _waterfill_work(rates, active, 4 * path_w, path_w)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_OPS_PER_S * 1e3
        timings[rows] = dict(rows=rows, W=path_w, F=4 * path_w, ms=k_ms,
                             plain_ms=p_ms, bytes=nbytes, ops=ops,
                             bound_ms=max(t_bytes, t_ops),
                             bound_by="bytes" if t_bytes >= t_ops
                             else "operations")
    emit("kernel_waterfill", checks=checks, max_abs=worst_abs,
         max_rel=worst_rel, timing=list(timings.values()))
    return dict(max_abs_err=worst_abs, path=timings[path_rows])


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
    rows, stats = survey(MINI_GRID, out_dir=os.path.join(
        HERE, "results", "chip_smoke"), device="cuda")
    emit("survey_mini", rows=len(rows), sims=stats["sims"],
         groups=stats["groups"], events=stats["events"],
         wall_s=stats["wall_s"], events_per_s=stats["events_per_s"],
         all_ok=stats["all_ok"], waterfill_launches=WATERFILL_LAUNCHES.count)
    if not stats["all_ok"] or len(rows) != 512:
        raise AssertionError(f"mini survey failed: {len(rows)} rows, "
                             f"all_ok={stats['all_ok']}")


def phase_survey_full_width(schedulers=("blevel", "greedy")):
    import numpy as np
    import torch
    from repro_torch.core import parse_cluster
    from repro_torch.core.graphs import encode_graph_batch, survey_names
    from repro_torch.core.vectorized import make_grid_runner
    from repro_torch.kernels import WATERFILL_LAUNCHES
    from repro_torch.survey import FULL_GRID, full_frontier_caps, grid_points
    encoded, groups = encode_graph_batch(
        survey_names(FULL_GRID["graphs_per_family"]), seed=0, bucket=True)
    grp = next(g for g in groups if g.shape[0] == 512)
    cores = np.asarray(parse_cluster("32x4"), np.int32)[None, :]
    points = grid_points(FULL_GRID)
    out = []
    main_path_launches = 0
    for sched in schedulers:
        runners = {impl: make_grid_runner(
            [encoded[n] for n in grp.names], sched, 32, cores,
            netmodel="maxmin", shape=grp.shape, batch=grp.batch,
            device="cuda", waterfill_impl=impl,
            frontier_caps=full_frontier_caps(grp.shape))
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
            res[impl].append((r, wall, WATERFILL_LAUNCHES.count))
        ra, la = res["auto"][0][0], res["auto"][0][2]
        rt, lt = res["torch"][0][0], res["torch"][0][2]
        main_path_launches += la
        runs = [r for impl in res for r, _, _ in res[impl]]
        same_counts = all(np.array_equal(getattr(x, f), getattr(rt, f))
                          for x in runs
                          for f in ("ok", "n_events", "n_steps"))
        ms_rel = max(float(np.max(np.abs(x.makespan - rt.makespan)
                                  / np.abs(rt.makespan))) for x in runs)
        x_rel = max(float(np.max(np.abs(x.transferred - rt.transferred)
                                 / np.maximum(np.abs(rt.transferred), 1.0)))
                    for x in runs)
        ev = int(ra.n_events.sum())
        k_walls = [w for _, w, _ in res["auto"]]
        p_walls = [w for _, w, _ in res["torch"]]
        row = dict(scheduler=sched, bucket=grp.label, graphs=list(grp.names),
                   cluster="32x4", points=len(points),
                   rows=int(ra.ok.size), all_ok=bool(ra.ok.all()),
                   events=ev, max_steps=int(ra.n_steps.max()),
                   order="plain,kernel,kernel,plain",
                   kernel_wall_s=k_walls,
                   kernel_events_per_s=[ev / w for w in k_walls],
                   plain_wall_s=p_walls,
                   plain_events_per_s=[ev / w for w in p_walls],
                   kernel_launches=[n for _, _, n in res["auto"]],
                   plain_launches=[n for _, _, n in res["torch"]],
                   counts_equal=same_counts, makespan_max_rel=ms_rel,
                   transferred_max_rel=x_rel,
                   bitwise_makespan=all(np.array_equal(x.makespan,
                                                       rt.makespan)
                                        for x in runs))
        out.append(row)
        if not (row["all_ok"] and same_counts and ms_rel <= RTOL
                and x_rel <= RTOL and la > 0 and lt == 0
                and all(n == 0 for n in row["plain_launches"])):
            emit("survey_full_width", rows=out, ok=False)
            raise AssertionError(f"full-width group disagrees: {row}")
    emit("survey_full_width", rows=out, ok=True,
         waterfill_launches=main_path_launches)
    return main_path_launches


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
    launches = None
    if "survey_full_width" in phases:
        launches = phase_survey_full_width()
    kernels = []
    if wf is not None:
        kernels.append(dict(
            name="waterfill", route="cuda",
            source="src/repro_torch/kernels/csrc/waterfill.cu",
            replaces="src/repro/kernels/waterfill.py:30",
            launches=launches if launches is not None else 0,
            max_abs_err=wf["max_abs_err"], ms=wf["path"]["ms"],
            plain_ms=wf["path"]["plain_ms"],
            bound_ms=wf["path"]["bound_ms"],
            bound_by=wf["path"]["bound_by"], library_ms=None))
    if "kernels" in phases:
        emit("kernels", kernels=[dict(name=k["name"],
                                      launches=k["launches"],
                                      held_against_plain=True)
                                 for k in kernels],
             total_s=time.perf_counter() - t_start)
        if launches is not None and launches <= 0:
            raise AssertionError("the main path never launched the "
                                 "waterfill kernel")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
