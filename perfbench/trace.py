"""The device trace of a traced run: ``torch.profiler`` over a bounded
stretch of calls, read from the raw kineto events (a grid call makes
some hundreds of thousands of device events, which ``key_averages``
takes minutes to summarise).

``profile(fn, host=False)`` gives the wall time, the device's busy time
(the union of its events' intervals, so overlapping events count
once), K1's device time (its kernels have ``waterfill_`` in their names) and the
device operations that took most time.  With ``host=True`` the host's
operations are recorded too, and each idle gap of the device is put
down to what the host was doing in its middle: the innermost host
operation or benchmark span (``record_function``) open at that moment.
Recording the host slows it, so that pass gives only the gaps; the
idle share under the profiler is an upper bound either way.
"""
from __future__ import annotations

import time

import torch

K1_PREFIX = "waterfill_"
TOP = 10
NAME = 160          # characters of an operation's name kept in the line


def _collect(prof):
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((e.start_ns(), e.end_ns(), e.name()))
        else:
            host.append((e.start_ns(), e.end_ns(), e.name()))
    dev.sort()
    host.sort()
    return dev, host


def _busy(dev):
    """``(busy ns, [(gap start, gap end), ...])`` of sorted intervals."""
    busy, gaps = 0, []
    cur_s = cur_e = None
    for s, e, _ in dev:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


def _gap_owners(gaps, host):
    """For each gap, in order, the innermost host event open at its
    middle (the latest-started one that has not ended), or ``None``: one
    sweep over both sorted lists."""
    owners, open_, j = [], [], 0
    for s, e in gaps:
        t = (s + e) // 2
        while j < len(host) and host[j][0] <= t:
            open_.append(host[j])
            j += 1
        while open_ and open_[-1][1] < t:
            open_.pop()
        owners.append(open_[-1][2] if open_ else None)
    return owners


def profile(fn, host: bool = False) -> dict:
    """Run ``fn`` once under the profiler; see the module docstring."""
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    dev, hst = _collect(prof)
    if not dev:
        raise RuntimeError("the profiled calls recorded no device event")
    busy_ns, gaps = _busy(dev)
    by_name = {}
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0) + (e - s)
    k1_ns = sum(v for k, v in by_name.items() if K1_PREFIX in k)
    out = dict(wall_s=wall_s, busy_s=busy_ns / 1e9, k1_device_s=k1_ns / 1e9,
               device_events=len(dev),
               device_ops=[[k[:NAME], v / 1e9] for k, v in sorted(
                   by_name.items(), key=lambda kv: kv[1],
                   reverse=True)[:TOP]])
    if host:
        by_host = {}
        for (s, e), name in zip(gaps, _gap_owners(gaps, hst)):
            name = name or "(no host op)"
            by_host[name] = by_host.get(name, 0) + (e - s)
        out["idle_gaps"] = [[k[:NAME], v / 1e9] for k, v in sorted(
            by_host.items(), key=lambda kv: kv[1], reverse=True)[:TOP]]
    out["read_s"] = time.perf_counter() - t1
    return out
