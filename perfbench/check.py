"""How ``correct`` is decided: the program's answers against the plain
reference (``reference.sim``), on the rows the window ran.

Every call of a unit runs the same rows, so each sampled row is worked
out once by the reference and held against that row of every call made.
A grid call's sample is drawn from the seed: one (graph, cluster) per
point, so every imode, msd and bandwidth is in it, and the row that
took the most steps.  A proto request is small, so all of its rows are
compared.

The numbers compared, each against the limit in
``limits/<cell>.json``:

* ``makespan_rel``: the largest ``|program - reference| / reference``
  of a row's makespan;
* ``transferred_rel``: the same of the bytes moved between workers
  (over ``max(reference, 1 byte)``);
* ``counts_rel``: the same of the completions a row processed
  (``n_events``) and of the loop steps it took (``n_steps``), the
  larger of the two (``n_events`` alone does not depend on precision:
  every task and download completes once);
* ``not_ok``: rows that the program or the reference did not finish,
  and rows of a call that raised.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

from .reference import encode as enc
from .reference import sim as rsim

NAMES = ("makespan_rel", "transferred_rel", "counts_rel", "not_ok")


def limits(w: dict) -> dict:
    """The cell's limits, ``limits/<cell>.json``."""
    with open(w["dir"] / "limits" / f"{w['name']}.json") as f:
        lim = json.load(f)
    return {k: lim[k] for k in NAMES}


def unit_rows(wl, i):
    """``[(k, b, n), ...]`` of unit ``i``: cluster, graph and point of
    every row, in the program's ``[K, B, N]`` order."""
    names, ks = wl.units[i]
    return [(k, b, n) for k in range(len(ks)) for b in range(len(names))
            for n in range(len(wl.points))]


def sample(wl, calls, seed):
    """``{unit: [(k, b, n), ...]}``: the rows the reference works out."""
    rng = np.random.default_rng(seed % 2 ** 63)
    out = {}
    for i, (names, ks) in enumerate(wl.units):
        if wl.kind == "proto":
            out[i] = unit_rows(wl, i)
            continue
        rows = {(int(rng.integers(len(ks))), int(rng.integers(len(names))), n)
                for n in range(len(wl.points))}
        done = [c["result"] for c in calls
                if c["unit"] == i and c["result"] is not None]
        if done:
            steps = done[0].n_steps
            rows.add(tuple(int(x) for x in np.unravel_index(
                int(np.argmax(steps)), steps.shape)))
        out[i] = sorted(rows)
    return out


def reference(wl, i, rows, device, fdt=torch.float32) -> dict:
    """The reference's answers for ``rows`` of unit ``i``, worked out
    from the graphs, clusters and points alone."""
    names, ks = wl.units[i]
    graphs = [wl.graph(n) for n in names]
    shape = enc.shape_of(graphs)
    pads = [enc.padded(g, shape) for g in graphs]
    est = {(b, im): enc.estimates(g, im, shape)
           for b, g in enumerate(graphs) for im in {p["imode"]
                                                     for p in wl.points}}
    pts = [wl.points[n] for _, _, n in rows]
    cores = wl.cores[list(ks)]
    spec = {f: np.stack([pads[b][f] for _, b, _ in rows]) for f in enc.FIELDS}
    return rsim.simulate(
        spec,
        np.stack([est[b, p["imode"]][0] for (_, b, _), p in zip(rows, pts)]),
        np.stack([est[b, p["imode"]][1] for (_, b, _), p in zip(rows, pts)]),
        np.array([p["msd"] for p in pts], np.float32),
        np.array([p["decision_delay"] for p in pts], np.float32),
        np.array([p["bandwidth"] for p in pts], np.float32),
        cores[[k for k, _, _ in rows]], scheduler=wl.scheduler,
        netmodel=wl.netmodel, max_cores=max(int(cores.max()), 1),
        device=device, fdt=fdt)


def _rel(got, want, floor):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.size == 0:
        return 0.0
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), floor)))


def compare(answers) -> dict:
    """The compared numbers over ``answers``: ``[(program, reference)]``
    pairs of per-row dicts (``makespan``, ``transferred``, ``n_events``,
    ``n_steps``, ``ok``), a program side of ``None`` for ``n`` rows of a
    call that raised given as ``(None, n)``."""
    out = dict.fromkeys(NAMES, 0.0)
    out["not_ok"] = 0
    for prog, ref in answers:
        if prog is None:
            out["not_ok"] += int(ref)
            continue
        both = np.asarray(prog["ok"], bool) & np.asarray(ref["ok"], bool)
        out["not_ok"] += int(both.size - both.sum())
        for name, key, floor in (("makespan_rel", "makespan", 0.0),
                                 ("transferred_rel", "transferred", 1.0),
                                 ("counts_rel", "n_events", 1.0),
                                 ("counts_rel", "n_steps", 1.0)):
            v = _rel(np.asarray(prog[key])[both], np.asarray(ref[key])[both],
                     floor)
            out[name] = max(out[name], v)
    return out


def program_rows(res, rows) -> dict:
    """A call's ``SimResult`` (numpy ``[K, B, N]``) at ``rows``."""
    idx = tuple(np.array(a) for a in zip(*rows))
    return dict(makespan=res.makespan[idx], transferred=res.transferred[idx],
                n_events=res.n_events[idx], n_steps=res.n_steps[idx],
                ok=res.ok[idx])


def check(wl, calls, seed, device) -> dict:
    """Every recorded call against the reference on the sampled rows;
    returns the compared numbers."""
    picks = sample(wl, calls, seed)
    answers = []
    for i, rows in picks.items():
        mine = [c for c in calls if c["unit"] == i]
        if not mine:
            continue
        ref = reference(wl, i, rows, device)
        for c in mine:
            if c["result"] is None:
                answers.append((None, c["rows"]))
            else:
                answers.append((program_rows(c["result"], rows), ref))
    return compare(answers)


def verdict(numbers: dict, lim: dict) -> tuple:
    """``(correct, {name: {"value", "limit"}})``; also printed to
    standard error, one line a number, as the run's last lines."""
    checks = {k: {"value": numbers[k], "limit": lim[k]} for k in NAMES}
    ok = all(numbers[k] <= lim[k] for k in NAMES)
    for k in NAMES:
        print(f"check {k} {numbers[k]!r} limit {lim[k]!r}", file=sys.stderr)
    return ok, checks
