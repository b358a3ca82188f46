"""Deterministic, resumable, shardable token pipeline (a copy of the
reference package's ``repro/data/pipeline.py``, numpy only).

* **step-keyed determinism** — batch ``i`` is a pure function of
  (seed, step): no iterator state to checkpoint; restart at step N
  reproduces exactly the batches a non-preempted run would have seen.
* **host sharding** — each host materialises only its slice of the global
  batch (``host_id``/``num_hosts``).
* **sources** — synthetic LM streams by default (zipfian unigrams mixed
  with structured spans so the loss has learnable signal) or a memory-
  mapped token file.

Batches are numpy; the trainer moves them to the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    codebooks: int = 0             # audio archs: tokens [B, S, K]
    token_file: str | None = None         # optional mmap token source


class TokenPipeline:
    def __init__(self, cfg: DataConfig, host_id: int = 0,
                 num_hosts: int = 1):
        if cfg.global_batch % num_hosts:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {num_hosts} hosts")
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.local_batch = cfg.global_batch // num_hosts
        self._tokens = None
        if cfg.token_file:
            self._tokens = np.memmap(cfg.token_file, dtype=np.int32,
                                     mode="r")

    # ----------------------------------------------------------- batches
    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, self.host_id]))

    def _synthetic(self, rng, shape):
        v = self.cfg.vocab_size
        # zipfian unigrams
        ranks = rng.zipf(1.3, size=shape).astype(np.int64)
        toks = (ranks - 1) % v
        # structured spans: arithmetic token runs => learnable bigrams
        runs = rng.random(shape[:-1]) < 0.5
        starts = rng.integers(0, v, size=shape[:-1])
        ar = (starts[..., None] + np.arange(shape[-1])) % v
        toks = np.where(runs[..., None], ar, toks)
        return toks.astype(np.int32)

    def batch(self, step: int) -> dict:
        """Local slice of global batch ``step`` (host-sharded)."""
        cfg = self.cfg
        rng = self._rng(step)
        if cfg.codebooks:
            shape = (self.local_batch, cfg.seq_len, cfg.codebooks)
        else:
            shape = (self.local_batch, cfg.seq_len)
        if self._tokens is None:
            toks = self._synthetic(rng, shape)
        else:
            n = len(self._tokens) - cfg.seq_len - 1
            idx = rng.integers(0, n, size=self.local_batch)
            toks = np.stack([self._tokens[i:i + cfg.seq_len] for i in idx])
            toks = toks.reshape(shape)
        return {"tokens": toks}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1
