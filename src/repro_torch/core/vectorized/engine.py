"""The port's grid engine — the counterpart of
``repro.core.vectorized.engine``.

The reference runs one compiled XLA program per (bucket, W, scheduler,
netmodel) group — ``jax.jit`` of ``shard_map`` of the vmapped
``while_loop`` — so once it is built an event costs the host nothing;
it streams row chunks onto the devices through ``DoubleBufferQueue``,
and keeps the program across processes with the persistent compile
cache and ``ExecutableStore``.  Here:

* The program's counterpart is a CUDA graph of the event step, one per
  simulator call: ``sim._drive`` runs step 0 eagerly, captures the next
  step on the carry and replays it for every later step
  (``SimConfig.step_graph``).  ``capture_counter`` counts captures and
  replays, in place of the reference's ``trace_counter`` and
  ``exec_counter``.
* ``ShardedGridRunner`` cuts the ``R = K * B * N`` rows of a
  ``BucketedGridRunner`` call into chunks of one size (the last padded
  by repeating row 0, the padding sliced off) and puts each on the
  card through ``DoubleBufferQueue``: pinned host rows, copied on a side
  stream while the previous chunk computes.  One simulator call runs
  per chunk; the result is the ``vmap`` runner's bit for bit.
* ``devices`` above 1 raises: the engine runs on one card (ROADMAP
  Queue A, the grid engine across several cards).
* ``enable_compile_cache``, ``cache_counter``, ``ExecutableStore``,
  ``exec_counter`` and ``make_sharded_rows_fn`` have no counterpart:
  the port compiles nothing per group (its ops are PyTorch's, built
  already), its kernels are built once and cached on disk by
  ``kernels/_build.py``, and a CUDA graph holds one process's device
  addresses, so it cannot be carried to another.  ``cache_dir``
  raises with that reason (``NO_CACHE_DIR``).
"""
from __future__ import annotations

import numpy as np
import torch

from .sim import GRAPH_EVENTS, BucketedGridRunner, SimResult
from .specs import spec_from_numpy

__all__ = ["ShardedGridRunner", "DoubleBufferQueue", "capture_counter",
           "NO_CACHE_DIR"]

NO_CACHE_DIR = (
    "cache_dir has no counterpart in repro_torch: the port compiles "
    "nothing per group, its kernels are cached on disk by "
    "kernels/_build.py, and a CUDA graph of the event step cannot be "
    "carried across processes")


class capture_counter:
    """Scoped step-graph accounting: ``with capture_counter() as cc:
    ...; cc.calls, cc.captures, cc.replays``.  Every simulator call
    counts in ``calls``; one whose event step runs from a CUDA graph
    captures once and replays once per later step.  The counts run
    until the block exits and hold from then on.  Nests safely —
    delta-based, never resets the process-wide odometers."""

    def __enter__(self):
        self._at = dict(GRAPH_EVENTS)
        self._end = None
        return self

    def __exit__(self, *exc):
        self._end = dict(GRAPH_EVENTS)
        return False

    def _delta(self, key) -> int:
        end = GRAPH_EVENTS if self._end is None else self._end
        return end[key] - self._at[key]

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


class ShardedGridRunner(BucketedGridRunner):
    """``BucketedGridRunner`` with the grid's rows streamed in chunks.

    The rows are ``BucketedGridRunner``'s (``R = K * B * N``, row ``(b
    * N + n) * K + k``), each with its own spec row, estimates, point
    scalars and cluster.  ``stream_rows`` is the chunk size (default:
    all rows in one chunk); every chunk has that size, the last padded
    by repeating row 0, and the padding is sliced off the results.
    Each chunk reaches the card through ``DoubleBufferQueue`` and runs
    as one simulator call (one CUDA graph capture), so device-resident
    rows stay bounded for grids larger than memory.  ``__call__``
    returns the ``vmap`` runner's ``SimResult[K, B, N]`` bit for bit.

    ``devices`` is ``None`` or 1 (the one card); more raises."""

    def __init__(self, entries, scheduler, n_workers, cores,
                 netmodel="maxmin", max_steps=None, shape=None,
                 batch=None, est_cache=None, *, devices=None,
                 stream_rows=None, **kwargs):
        if devices not in (None, 1):
            raise NotImplementedError(
                f"devices={devices}: the port's grid engine runs on one "
                f"card; a split across several cards is not ported "
                f"(ROADMAP Queue A, the grid engine across several cards)")
        self.stream_rows = None if stream_rows is None else int(stream_rows)
        super().__init__(entries, scheduler, n_workers, cores,
                         netmodel=netmodel, max_steps=max_steps, shape=shape,
                         batch=batch, est_cache=est_cache, **kwargs)

    def _row_chunks(self, R):
        """(chunk_rows, padded_R): every chunk the same size."""
        chunk = R if self.stream_rows is None else max(1, self.stream_rows)
        return chunk, -(-R // chunk) * chunk

    def _execute(self, points):
        b_of, args = self._row_index(points)
        R = len(b_of)
        chunk, rp = self._row_chunks(R)
        rows = np.concatenate([np.arange(R), np.zeros(rp - R, np.int64)])
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
                yield [t[i * chunk:(i + 1) * chunk] for t in host]

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
        return SimResult(*(torch.cat(xs)[:R] for xs in zip(*outs)))
