"""What the grid engine's span record costs, and what its spans account
for, in the benchmark's cells on a CUDA card.

    python3 tools/span_overhead.py [--cells a,b,...] [--seconds 15]
        [--seed N] [--profiled 0|1] [--out results/span_overhead.json]

For each cell (default: every cell of ``BENCHMARK.json``) the
benchmark's client (``perfbench.bench``) sets up, warms up and runs a
window of ``--seconds``; from the program's span log over the window
(``repro_torch.core.vectorized.span_log``) it prints the per-layer
metrics that read it, and checks per ``drive`` that step 0, the
capture and the summed per-step spans fit in ``loop``, that the loop
ran ``replays + 1`` steps with ``steps / check_every + 1`` polls, and
how much of each ``grid_call`` its children cover.  With ``--profiled
1`` it also times the benchmark's traced pass (``perfbench.trace``: one
cycle device-only, one call a shape with the host) with the spans'
``record_function`` ranges on and off, in turns (on, off, off, on).
Last, with no profiler, the always-on cost of a span: 10**6 summed
spans inside a drive and 10**5 once-spans, less an empty loop.
Writes one JSON object to ``--out`` and its summary to standard output.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time
import types

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

CHILDREN = ("rows_in", "prepare", "drive", "results_out")


def accounting(records, check_every=16):
    """Per drive: ``fits`` (step0 + capture + the summed spans <= loop),
    ``steps``, ``polls_ok``; per call: the share of ``grid_call`` its
    children cover."""
    by_id = {r["id"]: r for r in records}
    loops = {r["parent"]: r for r in records if r["name"] == "loop"}
    once = {}
    for r in records:
        if r["name"] in ("step0", "capture"):
            drive_id = by_id[r["parent"]]["parent"]
            once[drive_id] = once.get(drive_id, 0.0) + r["end"] - r["start"]
    drives = []
    for d in (r for r in records if r["name"] == "drive"):
        loop = loops[d["id"]]
        inside = once.get(d["id"], 0.0) + sum(
            d["sums"].get(n, (0, 0.0))[1]
            for n in ("replay", "poll", "step"))
        c = d["counters"]
        steps = 1 + c["replays"] + d["sums"].get("step", (0,))[0]
        drives.append(dict(
            loop_s=loop["end"] - loop["start"], inside_s=inside,
            fits=inside <= loop["end"] - loop["start"], steps=steps,
            replays=c["replays"], polls=c["polls"],
            polls_ok=c["polls"] == steps // check_every + 1
            and steps % check_every == 0))
    covers = []
    for g in (r for r in records if r["name"] == "grid_call"):
        kids = sum(r["end"] - r["start"] for r in records
                   if r["parent"] == g["id"] and r["name"] in CHILDREN)
        covers.append(kids / (g["end"] - g["start"]))
    return dict(drives=len(drives), all_fit=all(d["fits"] for d in drives),
                all_polls_ok=all(d["polls_ok"] for d in drives),
                steps=[d["steps"] for d in drives],
                slack_s=min((d["loop_s"] - d["inside_s"] for d in drives),
                            default=None),
                cover_min=min(covers, default=None),
                cover_mean=sum(covers) / len(covers) if covers else None)


def run_cell(name, seed, seconds, profiled, device):
    from perfbench import bench, run, trace
    from repro_torch.core.vectorized import _spans, span_log
    w = bench.cell(name)
    wl = bench.Workload(w, seed)
    client = bench.Client(wl, device)
    client.setup()
    client.warmup()
    window = client.window(seconds)
    rundict = dict(kind=wl.kind, setup_s=0.0, window=window,
                   calls=client.calls, W=wl.W, trace=None)
    names = [m["name"] for m in w["per_layer"]
             if m["source"] in ("program_span", "program_counter")]
    metrics = run.read_metrics([m for m in w["per_layer"]
                                if m["name"] in names], rundict, w["dir"])
    records, dropped = span_log(*window)
    out = dict(cell=name, seed=seed, window_s=window[1] - window[0],
               calls=len(client.calls), dropped=dropped,
               metrics={k: v["value"] for k, v in metrics.items()},
               accounting=accounting(records),
               cc_steps=[c["sim_calls"] + c["replays"]
                         for c in client.calls])
    if profiled:
        real = _spans._prof
        off = types.SimpleNamespace(_is_profiler_enabled=False)
        walls = []
        for on in (True, False, False, True):
            _spans._prof = real if on else off
            try:
                t0 = time.perf_counter()
                tr = trace.profile(lambda: client.cycle(record=False))
                gaps = trace.profile(lambda: client.cycle(
                    record=False, units=client.one_per_shape()), host=True)
                walls.append(dict(
                    record_function=on, cycle_wall_s=tr["wall_s"],
                    host_pass_wall_s=gaps["wall_s"],
                    total_s=time.perf_counter() - t0,
                    idle_gaps=gaps["idle_gaps"]))
            finally:
                _spans._prof = real
        out["profiled"] = walls
    return out


def span_cost():
    """ns a span with no profiler: summed (inside a drive) and once."""
    from repro_torch.core.vectorized import _spans
    n, m = 10 ** 6, 10 ** 5
    t = time.perf_counter()
    for _ in range(n):
        pass
    empty = (time.perf_counter() - t) / n
    with _spans.span("span_cost"), _spans.drive():
        t = time.perf_counter()
        for _ in range(n):
            with _spans.POLL:
                pass
        summed = (time.perf_counter() - t) / n - empty
        t = time.perf_counter()
        for _ in range(m):
            with _spans.span("once"):
                pass
        once = (time.perf_counter() - t) / m - empty
    return dict(summed_ns=summed * 1e9, once_ns=once * 1e9, empty_ns=empty
                * 1e9, n_summed=n, n_once=m)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default=None)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 2701)
    ap.add_argument("--profiled", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default="results/span_overhead.json")
    args = ap.parse_args(argv)
    import torch
    from perfbench import bench
    if not torch.cuda.is_available():
        print("span_overhead: needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    cells = (args.cells.split(",") if args.cells else
             [w["name"] for w in bench.benchmark()["workloads"]])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    result = dict(card=card, torch=torch.__version__, cells=[])
    for i, name in enumerate(cells):
        res = run_cell(name, args.seed + i, args.seconds, args.profiled,
                       device)
        result["cells"].append(res)
        print(json.dumps({k: v for k, v in res.items()
                          if k not in ("cc_steps",)}), flush=True)
    result["span_cost"] = span_cost()
    print(json.dumps(result["span_cost"]))
    path = ROOT / args.out
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
