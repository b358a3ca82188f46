"""The control of the benchmark's check: the reference put in the
program's place, computed in bfloat16 (the precision below the float32
the configurations state), held against the float32 reference on the
rows a run compares.  Its numbers are the upper readings the limits in
``limits/<cell>.json`` were set below; every number a control run gives
is one a sound program must not come near.

    python3 -m perfbench.control --workload <cell> --seeds <n> [<n> ...]

prints one JSON line a seed with the compared numbers and whether the
cell's limits call them correct (they must not).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import bench, check


def control(w, seed, device) -> dict:
    """The compared numbers of the bfloat16 reference against the
    float32 one on the rows a run of ``w`` with ``seed`` samples."""
    wl = bench.Workload(w, seed)
    answers = []
    for i, rows in check.sample(wl, [], seed).items():
        want = check.reference(wl, i, rows, device)
        got = check.reference(wl, i, rows, device, fdt=torch.bfloat16)
        answers.append((got, want))
    return check.compare(answers)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    w = bench.cell(args.workload)
    lim = check.limits(w)
    dev = torch.device(args.device)
    for seed in args.seeds:
        t0 = time.perf_counter()
        numbers = control(w, seed, dev)
        passed = all(numbers[k] <= lim[k] for k in check.NAMES)
        print(json.dumps(dict(workload=w["name"], seed=seed, numbers=numbers,
                              passes_limits=passed,
                              seconds=time.perf_counter() - t0)))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
