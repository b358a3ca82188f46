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

A cell whose traffic asks for ``ranks`` above 1 runs as that many
processes of this module, one a card (``launch``):
every rank runs set-up, warm-up, the window's cycles and the traced
cycle in lockstep over a gloo group (``Ranks``); rank 0 keeps the
clock, records the calls, profiles its own card, works out the
reference and prints the line, which this process passes on.
``setup_s`` runs from this process's start to the first timed call.

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
# the same instant on the machine's clock, which the ranks share
T_MONO = time.clock_gettime(time.CLOCK_MONOTONIC)

import argparse  # noqa: E402
import contextlib  # noqa: E402
import datetime  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# a run that compiles may take 1200 s; the ranks are ended past this
LAUNCH_TIMEOUT_S = 1500
# the gloo group's wait for a rank, as the program's own grid group
RANK_TIMEOUT = datetime.timedelta(minutes=10)


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


class OneRank:
    """The one process of a cell that runs on one card."""
    rank, size = 0, 1

    @staticmethod
    def agree(flag):
        return flag

    @staticmethod
    def gather(obj):
        return [obj]

    @staticmethod
    def barrier():
        pass


class Ranks:
    """The ranks of a started gloo group, one process a card, kept in
    lockstep: ``agree`` hands every rank rank 0's flag, ``gather`` every
    rank's object to every rank."""

    def __init__(self):
        import torch.distributed as dist
        self.dist = dist
        self.rank, self.size = dist.get_rank(), dist.get_world_size()

    def agree(self, flag):
        import torch
        t = torch.tensor([int(bool(flag))])
        self.dist.broadcast(t, 0)
        return bool(t.item())

    def gather(self, obj):
        out = [None] * self.size
        self.dist.all_gather_object(out, obj)
        return out

    def barrier(self):
        self.dist.barrier()


def run_cell(w, seed, seconds, traced, device, t_start=None,
             ranks=OneRank) -> dict | None:
    """One run of cell ``w`` (``bench.cell``) on ``device``; returns the
    result line as a dict on rank 0 of ``ranks``, ``None`` on the
    others."""
    import torch

    from . import bench, check, spans, trace
    t_start = time.perf_counter() if t_start is None else t_start
    marks = [("start", time.perf_counter())]
    wl = bench.Workload(w, seed)
    client = bench.Client(wl, device)
    marks.append(("inputs", time.perf_counter()))
    client.setup()
    marks.append(("encoded", time.perf_counter()))
    client.warmup()
    marks.append(("warm", time.perf_counter()))
    ranks.barrier()
    setup_s = time.perf_counter() - t_start
    print(f"perfbench: rank {ranks.rank} set-up (s since the start): "
          + ", ".join(f"{k} {t - t_start:.3f}" for k, t in marks)
          + f", all ranks {setup_s:.3f}", file=sys.stderr)
    window = client.window(seconds, ranks.agree)
    lead = ranks.rank == 0
    run = dict(kind=wl.kind, setup_s=setup_s, window=window,
               calls=client.calls, W=wl.W, ranks=wl.ranks,
               stream_rows=wl.stream_rows, trace=None)
    t_trace = time.perf_counter()
    tr = gaps = None
    if traced:
        cycle = []

        def one_cycle():
            cycle.extend(client.cycle(record=False))

        def host_pass():
            client.cycle(record=False, units=client.one_per_shape())
        # every rank runs both passes; rank 0 profiles its own card
        tr = trace.profile(one_cycle) if lead else one_cycle()
        gaps = trace.profile(host_pass, host=True) if lead else host_pass()
    on_card = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    # gathered once the window and the traced cycles are over
    held = ranks.gather(dict(peak=peak, card=str(device),
                             drive_s=spans.drive_per_call(run)))
    if not lead:
        return None
    run["rank_drive_s"] = [h["drive_s"] for h in held]
    line_device = dict(platform="gpu" if on_card else "cpu",
                       kind=(torch.cuda.get_device_name(device)
                             if on_card else "cpu"),
                       count=len({h["card"] for h in held}))
    breakdown = None
    if traced:
        tr["calls"] = cycle
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
    line_device["memory_peak_bytes"] = max(h["peak"] for h in held)
    if on_card:
        line_device["power"] = power_limit()
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


def _terminate(proc):
    """End ``proc`` if it still runs, and wait for it."""
    if proc.poll() is not None:
        return
    proc.terminate()
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def _raise_exit(signum, frame):
    raise SystemExit(128 + signum)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_ranks(procs, timeout) -> bool:
    """Wait until every rank has exited 0 (``True``), one has failed or
    ``timeout`` seconds have passed (``False``)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        codes = [p.poll() for p in procs]
        if any(c not in (None, 0) for c in codes):
            return False
        if all(c == 0 for c in codes):
            return True
        time.sleep(0.1)
    print(f"perfbench: the ranks did not end in {timeout} s", file=sys.stderr)
    return False


def launch(w, args, device="cuda") -> int:
    """Run cell ``w`` as its traffic's ``ranks`` processes on this
    machine, one a card, with the environment ``torch.distributed.run``
    would give them (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, a free
    port on 127.0.0.1), and pass on rank 0's result line as the last
    line of standard output; the ranks' standard error is passed on
    first, then the compared numbers as its last lines.  When a rank
    fails the others are ended: the run returns 1 and prints no line."""
    n = w["traffic_data"]["ranks"]
    cmd = [sys.executable, "-m", "perfbench.run", "--workload", w["name"],
           "--seed", str(args.seed), "--seconds", repr(args.seconds),
           "--trace", str(args.trace), "--launched-at", repr(T_MONO),
           "--device", device]
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(n),
               LOCAL_WORLD_SIZE=str(n))
    env.setdefault("OMP_NUM_THREADS", "1")
    procs = []
    previous = signal.signal(signal.SIGTERM, _raise_exit)
    with contextlib.ExitStack() as files:
        outs = [files.enter_context(tempfile.TemporaryFile("w+"))
                for _ in range(2 * n)]
        try:
            for r in range(n):
                procs.append(subprocess.Popen(
                    cmd, stdout=outs[2 * r], stderr=outs[2 * r + 1],
                    text=True, cwd=w["dir"].parent,
                    env=dict(env, RANK=str(r), LOCAL_RANK=str(r))))
            ok = _wait_ranks(procs, LAUNCH_TIMEOUT_S)
        finally:
            for proc in procs:
                _terminate(proc)
            signal.signal(signal.SIGTERM, previous)
        for f in outs:
            f.seek(0)
        texts = [f.read() for f in outs]
    out, err = texts[0], "".join(texts[1::2]) + "".join(texts[2::2])
    # the compared numbers go last, once
    sys.stderr.writelines(t for t in err.splitlines(keepends=True)
                          if not t.startswith("check "))
    lines = out.splitlines()
    try:
        line = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        line = None
    if not ok or not isinstance(line, dict) or len(lines) != 1:
        sys.stderr.write(out)
        print(f"perfbench: {w['name']}: the ranks exited "
              f"{[p.returncode for p in procs]}, {len(lines)} line(s) on "
              f"rank 0's standard output", file=sys.stderr)
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: modules of JAX or the JAX package were loaded: "
              f"{bad}", file=sys.stderr)
        return 1
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


def rank_main(w, args) -> int:
    """One rank of a launched cell: its card, the gloo group, its part of
    the run; rank 0 prints the result line."""
    import torch
    import torch.distributed as dist
    local = int(os.environ["LOCAL_RANK"])
    if args.device == "cuda":
        if not enough_cards(w):
            return 1
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device(args.device)
    t_start = time.perf_counter() - (
        time.clock_gettime(time.CLOCK_MONOTONIC) - args.launched_at)
    dist.init_process_group("gloo", timeout=RANK_TIMEOUT)
    try:
        line = run_cell(w, args.seed, args.seconds, bool(args.trace),
                        device, t_start, Ranks())
    finally:
        dist.destroy_process_group()
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: rank {os.environ.get('RANK')}: modules of JAX "
              f"or the JAX package were loaded: {bad}", file=sys.stderr)
        return 1
    if line is not None:
        print(json.dumps(line))
    return 0


def enough_cards(w) -> bool:
    import torch
    if torch.cuda.is_available() and torch.cuda.device_count() >= w["chips"]:
        return True
    print(f"perfbench: {w['name']} needs {w['chips']} CUDA card(s), "
          f"found {torch.cuda.device_count()}", file=sys.stderr)
    return False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # set by ``launch`` for its ranks: the launcher's start, the device
    ap.add_argument("--launched-at", type=float, help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    from . import bench
    w = bench.cell(args.workload)
    if args.launched_at is not None:
        return rank_main(w, args)
    if w["traffic_data"].get("ranks", 1) > 1:
        # each rank looks for its cards (this process loads no torch)
        return launch(w, args)
    if not enough_cards(w):
        return 1
    import torch
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
