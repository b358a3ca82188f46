"""Run one cell of the benchmark once and print its result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with the CUDA cards the cell
asks for.  Set-up (imports, the CUDA context, loading or building the
port's kernels, drawing and encoding the inputs, one warm-up of every
shape) is timed as ``setup_s``; then whole cycles of calls run until
``--seconds`` have passed.  With ``--trace 1`` one more cycle runs under
the profiler (device only), and one call of each shape bucket with the
host recorded, which names the device's idle gaps.  Then the peak device memory is read, the
program's state freed, and the reference works out the sampled answers
(``check.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted`` and ``failed`` simulations, ``metrics`` (the cell's
end-to-end metrics, or its per-layer ones with ``--trace 1``),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
compared number with its limit (also the last lines of standard
error).  The run exits 1 and prints no result without enough CUDA
cards, or when a module of JAX or of the JAX package is loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list:
    """Loaded modules (or ``names``) whose top-level name is JAX's,
    Flax's or the JAX package's, compared whole (``repro_torch`` is not
    ``repro``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def reader(name: str, folder):
    """``read`` of ``metrics/<name>.py``."""
    path = folder / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(entries, run, folder) -> dict:
    out = {}
    for m in entries:
        v = reader(m["name"], folder)(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def power_limit():
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def run_cell(w, seed, seconds, traced, device, t_start=None) -> dict:
    """One run of cell ``w`` (``bench.cell``) on ``device``; returns the
    result line as a dict."""
    import torch

    from . import bench, check, trace
    t_start = time.perf_counter() if t_start is None else t_start
    wl = bench.Workload(w, seed)
    client = bench.Client(wl, device)
    client.setup()
    client.warmup()
    setup_s = time.perf_counter() - t_start
    window = client.window(seconds)
    run = dict(kind=wl.kind, setup_s=setup_s, window=window,
               calls=client.calls, W=wl.W, trace=None)
    line_device = dict(platform="gpu" if device.type == "cuda" else "cpu",
                       kind=(torch.cuda.get_device_name(device)
                             if device.type == "cuda" else "cpu"),
                       count=1)
    t_trace = time.perf_counter()
    breakdown = None
    if traced:
        cycle = []
        tr = trace.profile(lambda: cycle.extend(client.cycle(record=False)))
        tr["calls"] = cycle
        gaps = trace.profile(lambda: client.cycle(
            record=False, units=client.one_per_shape()), host=True)
        run["trace"] = tr
        line_device.update(busy_s=tr["busy_s"], window_s=tr["wall_s"])
        breakdown = dict(device_ops=tr["device_ops"],
                         idle_gaps=gaps["idle_gaps"])
        print(f"perfbench: traced cycle {tr['wall_s']:.3f} s, "
              f"{tr['device_events']} device events read in "
              f"{tr['read_s']:.3f} s; with the host {gaps['wall_s']:.3f} s, "
              f"read in {gaps['read_s']:.3f} s", file=sys.stderr)
    metrics = read_metrics(w["per_layer"] if traced else w["end_to_end"],
                           run, w["dir"])
    if device.type == "cuda":
        line_device["memory_peak_bytes"] = torch.cuda.max_memory_allocated(
            device)
        line_device["power"] = power_limit()
    else:
        line_device["memory_peak_bytes"] = 0
    # the program's state goes before the reference runs
    calls = client.calls
    del client, run
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = check.check(wl, calls, seed, device)
    t_end = time.perf_counter()
    print(f"perfbench: {w['name']} seed {seed}: set-up {setup_s:.3f} s, "
          f"window {window[1] - window[0]:.3f} s, trace "
          f"{t_ref - t_trace:.3f} s, reference {t_end - t_ref:.3f} s; "
          f"calls (unit rows wall_s loop_steps): " + " ".join(
              f"{c['unit']}:{c['rows']}:{c['t1'] - c['t0']:.3f}:"
              f"{c['sim_calls'] + c['replays']}" for c in calls),
          file=sys.stderr)
    correct, checks = check.verdict(numbers, check.limits(w))
    attempted = sum(c["rows"] for c in calls)
    failed = attempted - sum(c["ok"] for c in calls)
    line = dict(correct=bool(correct and attempted > 0 and failed == 0),
                attempted=attempted, failed=failed, metrics=metrics,
                device=line_device)
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from . import bench
    w = bench.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"perfbench: {args.workload} needs {w['chips']} CUDA card(s), "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    line = run_cell(w, args.seed, args.seconds, bool(args.trace),
                    torch.device("cuda", 0), T_START)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: modules of JAX or the JAX package were loaded: "
              f"{bad}", file=sys.stderr)
        return 1
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
