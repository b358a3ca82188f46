"""The port's grid engine — the counterpart of
``repro.core.vectorized.engine``.

The reference runs one compiled XLA program per (bucket, W, scheduler,
netmodel) group — ``jax.jit`` of ``shard_map`` of the vmapped
``while_loop`` over a 1-D ``"grid"`` mesh of devices — so once it is
built an event costs the host nothing; it streams row chunks onto the
devices through ``DoubleBufferQueue``, and keeps the program across
processes with the persistent compile cache and ``ExecutableStore``.
Here:

* The program's counterpart is a CUDA graph of the event step, one per
  simulator call: ``sim._drive`` runs step 0 eagerly, captures the next
  step on the carry and replays it for every later step
  (``SimConfig.step_graph``).  ``capture_counter`` counts captures and
  replays, in place of the reference's ``trace_counter`` and
  ``exec_counter``, and the seconds of the spans each runner call
  records in ``_spans`` (from ``grid_call`` down to step 0, the
  capture, each replay and each poll; always on, reaching a
  ``torch.profiler`` trace only while a profiler runs), which the
  reference has no counterpart of.
* ``ShardedGridRunner`` cuts the ``R = K * B * N`` rows of a
  ``BucketedGridRunner`` call into chunks of one size (the last padded
  by repeating row 0, the padding sliced off) and puts each on the
  card through ``DoubleBufferQueue``: pinned host rows, copied on a side
  stream while the previous chunk computes.  One simulator call runs
  per chunk; the result is the ``vmap`` runner's bit for bit.
* Several cards are several ranks of a ``torch.distributed`` group, one
  process each (``torchrun --nproc-per-node n``): ``devices=n`` or a
  ``mesh`` with a ``"grid"`` dim (``launch.mesh.make_grid_mesh``) in
  place of the reference's ``shard_map``.  Each chunk is a multiple of
  the rank count; every rank rebuilds the same rows, takes its
  contiguous block of each chunk, runs it on its own card (its own
  captures) and all-gathers its results on the host over a gloo group
  (``launch.mesh.grid_host_group``), so every rank returns the whole
  grid, the one-rank result bit for bit.  The rows need no collective
  while they run; a digest of the host rows is compared across the
  ranks before they do.
* ``enable_compile_cache``, ``cache_counter``, ``ExecutableStore``,
  ``exec_counter`` and ``make_sharded_rows_fn`` have no counterpart:
  the port compiles nothing per group (its ops are PyTorch's, built
  already), its kernels are built once and cached on disk by
  ``kernels/_build.py``, and a CUDA graph holds one process's device
  addresses, so it cannot be carried to another.  ``cache_dir``
  raises with that reason (``NO_CACHE_DIR``).
"""
from __future__ import annotations

import hashlib
import os

import numpy as np
import torch
import torch.distributed as dist

from ...device import resolve_device
from ...launch.mesh import grid_host_group, grid_ranks, make_grid_mesh
from ._spans import GRAPH_EVENTS, totals
from .sim import BucketedGridRunner, SimResult
from .specs import spec_from_numpy

__all__ = ["ShardedGridRunner", "DoubleBufferQueue", "capture_counter",
           "grid_mesh", "rank_device", "NO_CACHE_DIR"]

NO_CACHE_DIR = (
    "cache_dir has no counterpart in repro_torch: the port compiles "
    "nothing per group, its kernels are cached on disk by "
    "kernels/_build.py, and a CUDA graph of the event step cannot be "
    "carried across processes")


class capture_counter:
    """Scoped step-graph accounting: ``with capture_counter() as cc:
    ...; cc.calls, cc.captures, cc.replays``.  Every simulator call
    counts in ``calls``; one whose event step runs from a CUDA graph
    captures once and replays once per later step.  ``cc.polls`` counts
    the host's reads of "any row live", ``cc.place_iters`` the greedy
    placer's loop iterations, and ``cc.spans`` is ``{name: (count,
    seconds)}`` of the spans (``_spans``: the span record of every
    runner call, always on) that closed inside the block; a span summed
    per step closes with its simulator call.  The counts run until the
    block exits and hold from then on.  Nests safely — delta-based,
    never resets the process-wide odometers."""

    def __enter__(self):
        self._at = dict(GRAPH_EVENTS)
        self._spans_at = totals()
        self._end = self._spans_end = None
        return self

    def __exit__(self, *exc):
        self._end = dict(GRAPH_EVENTS)
        self._spans_end = totals()
        return False

    def _delta(self, key) -> int:
        end = GRAPH_EVENTS if self._end is None else self._end
        return end[key] - self._at[key]

    @property
    def spans(self) -> dict:
        end = totals() if self._spans_end is None else self._spans_end
        out = {}
        for name, (n, s) in end.items():
            n0, s0 = self._spans_at.get(name, (0, 0.0))
            if n > n0:
                out[name] = (n - n0, s - s0)
        return out

    @property
    def polls(self) -> int:
        return self._delta("polls")

    @property
    def place_iters(self) -> int:
        return self._delta("place_iters")

    @property
    def calls(self) -> int:
        return self._delta("calls")

    @property
    def captures(self) -> int:
        return self._delta("captures")

    @property
    def replays(self) -> int:
        return self._delta("replays")


_EMPTY = object()


class DoubleBufferQueue:
    """Depth-2 prefetch iterator: ``put`` (here a copy onto the card on
    a side stream) is applied to batch k+1 before batch k is handed to
    the consumer, so the k+1 transfer overlaps the k compute.
    Invariants (tested):

    * batches come out in input order, each exactly once — including
      the last batch, which drains with no trailing ``put``;
    * at most two batches are resident (the one consumed + the one
      prefetching);
    * empty and single-batch inputs degrade gracefully.
    """

    def __init__(self, batches, put=None):
        self._it = iter(batches)
        self._put = (lambda x: x) if put is None else put
        self._ahead = _EMPTY
        self._advance()

    def _advance(self):
        try:
            self._ahead = self._put(next(self._it))
        except StopIteration:
            self._ahead = _EMPTY

    def __iter__(self):
        return self

    def __next__(self):
        if self._ahead is _EMPTY:
            raise StopIteration
        current = self._ahead
        self._advance()   # issue the next transfer before k is consumed
        return current


def grid_mesh(devices=None, mesh=None):
    """The 1-D grid mesh a sharded run splits its rows over, or ``None``
    for one rank.  ``mesh`` must have a ``"grid"`` dim (``ValueError``
    otherwise); ``devices=None`` takes every rank of the default group,
    or one card when no group is started; ``devices=n`` above 1 needs a
    started group of at least n ranks (``RuntimeError`` otherwise).  A
    mesh made here is a host mesh (``device_type="cpu"``): the engine's
    only collectives are gathers of host copies."""
    if mesh is not None:
        if "grid" not in (mesh.mesh_dim_names or ()):
            raise ValueError(f"mesh dims {mesh.mesh_dim_names} lack the "
                             f"'grid' dim — build with make_grid_mesh()")
        return mesh if len(grid_ranks(mesh)) > 1 else None
    started = dist.is_initialized()
    if devices is None:
        n = dist.get_world_size() if started else 1
    else:
        n = int(devices)
    if n < 1:
        raise ValueError(f"devices={devices}: need at least one")
    if n == 1:
        return None
    if not started:
        raise RuntimeError(
            f"devices={n}: the grid engine runs one rank per card and no "
            f"process group is started — run under `torchrun "
            f"--nproc-per-node {n}` (or start torch.distributed with "
            f"world_size={n} first)")
    return make_grid_mesh(n, device_type="cpu")


def rank_device(device, mesh) -> torch.device:
    """The device of this rank: ``device`` resolved, and with more than
    one rank on CUDA, ``cuda:{LOCAL_RANK % device_count}`` (the global
    rank when no launcher set ``LOCAL_RANK``), made the current card.
    Two ranks may share a card."""
    dev = resolve_device(device)
    if mesh is None or dev.type != "cuda":
        return dev
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    dev = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


class ShardedGridRunner(BucketedGridRunner):
    """``BucketedGridRunner`` with the grid's rows streamed in chunks,
    split over the ranks of a 1-D ``"grid"`` mesh.

    The rows are ``BucketedGridRunner``'s (``R = K * B * N``, row ``(b
    * N + n) * K + k``), each with its own spec row, estimates, point
    scalars and cluster.  ``stream_rows`` is the chunk size (default:
    all rows in one chunk), rounded up to a multiple of the rank count;
    every chunk has that size, the last padded by repeating row 0, and
    the padding is sliced off the results.  Rank ``i`` of ``n`` takes
    the ``i``-th of ``n`` equal blocks of every chunk (a block of
    padding alone still runs, as the reference's idle shards do); each
    block reaches the rank's card through ``DoubleBufferQueue`` and runs
    as one simulator call (one CUDA graph capture), so device-resident
    rows stay bounded for grids larger than memory.  ``__call__``
    returns the ``vmap`` runner's ``SimResult[K, B, N]`` bit for bit,
    on every rank.

    ``devices=n`` splits over the first n ranks of the started default
    group (``grid_mesh``; default: all of them, or one card when no
    group is started); pass ``mesh`` to share one mesh across runners.
    Every rank of the grid builds the runner and calls it with the same
    arguments, in the same order.  With more than one rank each runs on
    ``cuda:{LOCAL_RANK % device_count}`` (``rank_device``) unless
    ``device="cpu"``."""

    def __init__(self, entries, scheduler, n_workers, cores,
                 netmodel="maxmin", max_steps=None, shape=None,
                 batch=None, est_cache=None, *, mesh=None, devices=None,
                 stream_rows=None, device="cuda", **kwargs):
        self.mesh = grid_mesh(devices, mesh)
        if self.mesh is None:
            self.n_devices, self.rank, self._group = 1, 0, None
        else:
            ranks = grid_ranks(self.mesh)
            if dist.get_rank() not in ranks:
                raise RuntimeError(f"rank {dist.get_rank()} is outside the "
                                   f"grid mesh of ranks {ranks}")
            self.n_devices = len(ranks)
            self.rank = ranks.index(dist.get_rank())
            self._group = grid_host_group(self.mesh)
        self.stream_rows = None if stream_rows is None else int(stream_rows)
        super().__init__(entries, scheduler, n_workers, cores,
                         netmodel=netmodel, max_steps=max_steps, shape=shape,
                         batch=batch, est_cache=est_cache,
                         device=rank_device(device, self.mesh), **kwargs)

    def _row_chunks(self, R):
        """(chunk_rows, padded_R): every chunk the same size, a multiple
        of the rank count."""
        d = self.n_devices
        if self.stream_rows is None:
            chunk = -(-R // d) * d
        else:
            chunk = max(1, -(-self.stream_rows // d)) * d
        return chunk, -(-R // chunk) * chunk

    def _same_rows(self, chunk, b_of, args):
        """Raise on every rank unless all ranks built the same rows: a
        digest of the host row arrays, all-gathered."""
        h = hashlib.sha256(repr((self.scheduler, chunk)).encode())
        for a in (*self.bspec.numpy().values(), b_of, *args):
            h.update(np.ascontiguousarray(a).tobytes())
        mine = torch.frombuffer(bytearray(h.digest()), dtype=torch.uint8)
        got = [torch.empty_like(mine) for _ in range(self.n_devices)]
        dist.all_gather(got, mine, group=self._group)
        differ = [i for i, g in enumerate(got) if not torch.equal(g, got[0])]
        if differ:
            raise RuntimeError(f"grid ranks {differ} built other rows than "
                               f"rank 0: every rank must call the runner "
                               f"with the same entries and points")

    def _gather(self, local, blocks):
        """Every rank's ``SimResult`` of ``blocks`` blocks, all-gathered
        on the host and put in row order: ``[n_chunks * chunk]`` host
        tensors."""
        n = self.n_devices
        out = []
        for x in local:
            h = x.cpu()
            wire = h.to(torch.uint8) if h.dtype == torch.bool else h
            got = [torch.empty_like(wire) for _ in range(n)]
            dist.all_gather(got, wire, group=self._group)
            out.append(torch.stack([g.reshape(blocks, -1) for g in got], 1)
                       .reshape(-1).to(h.dtype))
        return SimResult(*out)

    def _execute(self, points):
        b_of, args = self._row_index(points)
        R = len(b_of)
        chunk, rp = self._row_chunks(R)
        n = self.n_devices
        block = chunk // n
        rows = np.concatenate([np.arange(R), np.zeros(rp - R, np.int64)])
        if n > 1:
            self._same_rows(chunk, b_of, args)
            # this rank's block of every chunk
            rows = rows.reshape(rp // chunk, n, block)[:, self.rank].ravel()
        spec = spec_from_numpy({f: v[b_of[rows]] for f, v
                                in self.bspec.numpy().items()}, "cpu")
        n_spec = len(spec.fields())
        host = [*spec.fields().values(),
                *(torch.from_numpy(np.ascontiguousarray(a[rows]))
                  for a in args)]
        dev = self.device
        on_card = dev.type == "cuda"
        if on_card:
            host = [t.pin_memory() for t in host]
            copy_stream = torch.cuda.Stream(dev)

        def chunks():
            for i in range(rp // chunk):
                yield [t[i * block:(i + 1) * block] for t in host]

        def put(batch):
            if not on_card:
                return batch, None
            with torch.cuda.stream(copy_stream):
                out = [t.to(dev, non_blocking=True) for t in batch]
                ready = torch.cuda.Event()
                ready.record(copy_stream)
            return out, ready

        outs = []
        for batch, ready in DoubleBufferQueue(chunks(), put):
            if ready is not None:
                compute = torch.cuda.current_stream(dev)
                compute.wait_event(ready)
                for t in batch:
                    t.record_stream(compute)
            outs.append(self.run(type(spec)(*batch[:n_spec]),
                                 *batch[n_spec:]))
        res = SimResult(*(torch.cat(xs) for xs in zip(*outs)))
        if n > 1:
            res = self._gather(res, rp // chunk)
        return SimResult(*(x[:R] for x in res))
