"""Network models (paper §2 "Communication model").

Two models:

* ``SimpleNetModel`` — the model used by most prior scheduler surveys:
  a transfer of ``size`` bytes always takes ``size / bandwidth`` seconds,
  independent of any other concurrently running transfer (no contention).

* ``MaxMinFlowNetModel`` — full-duplex communication where each worker has a
  bounded upload and download bandwidth; concurrent flows share bandwidth
  according to *max-min fairness* (progressive filling / water-filling,
  Bertsekas & Gallager).  Allocations are recomputed immediately whenever a
  flow starts or finishes (paper: the time needed for bandwidth saturation
  is neglected).

A *flow* is a single object download ``src worker -> dst worker``.  The
simulator advances time in jumps between events; between two events all
rates are constant, so remaining bytes decrease linearly.

A copy of ``repro.core.netmodels`` for the PyTorch port, which imports
nothing of the reference package: the logic is the reference's, only the
imports differ."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Flow:
    src: int                 # uploading worker id
    dst: int                 # downloading worker id
    obj: object              # DataObject being transferred
    remaining: float         # bytes left
    rate: float = 0.0        # bytes/s (set by recompute)
    start_time: float = 0.0

    def __hash__(self):
        return id(self)


def maxmin_fairness(flows, upload_cap, download_cap):
    """Progressive filling.  Returns a list of rates aligned with ``flows``.

    ``upload_cap``/``download_cap`` map worker id -> capacity (bytes/s).
    Each flow consumes the upload resource of ``src`` and the download
    resource of ``dst``.  Classic max-min: repeatedly find the bottleneck
    resource (minimal fair share), freeze its flows at that share, remove
    the resource, repeat.
    """
    n = len(flows)
    rates = [0.0] * n
    if n == 0:
        return rates
    # resource id: ("u", w) uploads, ("d", w) downloads
    cap = {}
    members = {}
    for i, f in enumerate(flows):
        for r in (("u", f.src), ("d", f.dst)):
            if r not in cap:
                cap[r] = upload_cap[r[1]] if r[0] == "u" else download_cap[r[1]]
                members[r] = []
            members[r].append(i)
    active = set(range(n))
    while active:
        # fair share of every resource over its still-active flows
        best_share, best_r = None, None
        for r, mem in members.items():
            live = [i for i in mem if i in active]
            if not live:
                continue
            share = cap[r] / len(live)
            if best_share is None or share < best_share:
                best_share, best_r = share, r
        if best_r is None:
            break
        for i in list(members[best_r]):
            if i in active:
                rates[i] = best_share
                active.remove(i)
                f = flows[i]
                for r in (("u", f.src), ("d", f.dst)):
                    cap[r] -= best_share
                    if cap[r] < 0:
                        cap[r] = 0.0
    return rates


class NetModelBase:
    """Tracks active flows, assigns rates, advances remaining bytes."""

    name = "base"
    # w-scheduler download-slot limits (Appendix A)
    max_downloads_per_worker = None      # None = unlimited
    max_downloads_per_source = None

    def __init__(self, bandwidth: float):
        self.bandwidth = float(bandwidth)   # bytes/s per worker (full duplex)
        self.flows: list[Flow] = []
        self._dirty = True

    # ------------------------------------------------------------- flows
    def add_flow(self, flow: Flow):
        self.flows.append(flow)
        self._dirty = True

    def remove_flow(self, flow: Flow):
        self.flows.remove(flow)
        self._dirty = True

    def downloads_of(self, worker_id: int):
        return [f for f in self.flows if f.dst == worker_id]

    def recompute(self, worker_ids):
        raise NotImplementedError

    # ------------------------------------------------------------ timing
    BYTES_EPS = 1e-3   # sub-byte remainders are float artifacts => done

    def earliest_completion(self) -> float:
        """Seconds until the first flow completes (inf if no flows)."""
        best = float("inf")
        for f in self.flows:
            if f.remaining <= self.BYTES_EPS:
                return 0.0
            if f.rate > 0:
                best = min(best, f.remaining / f.rate)
        return best

    def advance(self, dt: float):
        for f in self.flows:
            f.remaining -= f.rate * dt
            if f.remaining < self.BYTES_EPS:
                f.remaining = 0.0

    def completed_flows(self):
        return [f for f in self.flows if f.remaining <= self.BYTES_EPS]


class SimpleNetModel(NetModelBase):
    """No contention: every flow always runs at full worker bandwidth."""

    name = "simple"
    max_downloads_per_worker = None
    max_downloads_per_source = None

    def recompute(self, worker_ids):
        for f in self.flows:
            f.rate = self.bandwidth


class MaxMinFlowNetModel(NetModelBase):
    """Max-min fairness with per-worker full-duplex caps."""

    name = "maxmin"
    # Appendix A: at most 4 concurrent downloads, at most 2 from one source.
    max_downloads_per_worker = 4
    max_downloads_per_source = 2

    def recompute(self, worker_ids):
        caps = {w: self.bandwidth for w in worker_ids}
        rates = maxmin_fairness(self.flows, caps, dict(caps))
        for f, r in zip(self.flows, rates, strict=True):
            f.rate = r


NETMODELS = {
    "simple": SimpleNetModel,
    "maxmin": MaxMinFlowNetModel,
}


def make_netmodel(name: str, bandwidth: float) -> NetModelBase:
    return NETMODELS[name](bandwidth)
