"""Deterministic synthetic token pipeline (numpy), as in the reference.

Counterpart of ``repro/data/pipeline.py``: batch(step) is a pure function
of (seed, step, shard) through a splitmix-style integer hash, identical
on every platform, so the port and the reference see the same prompts;
``Prefetcher`` makes them ahead of the consumer on a host thread.
"""
from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_frontend_tokens: int = 0   # VLM/audio stubs: emit frontend embeddings
    d_model: int = 0             # needed when n_frontend_tokens > 0


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    z = x
    z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    return z ^ (z >> np.uint64(31))


def batch_at(cfg: DataConfig, step: int, shard: int = 0, n_shards: int = 1
             ) -> dict:
    """The shard's rows of global batch `step`. Pure function -> skip-ahead."""
    rows = cfg.global_batch // n_shards
    row0 = shard * rows
    r = np.arange(rows, dtype=np.uint64)[:, None] + np.uint64(row0)
    c = np.arange(cfg.seq_len, dtype=np.uint64)[None, :]
    base = (np.uint64(cfg.seed) * np.uint64(0x51D2FA7) +
            np.uint64(step) * np.uint64(0x9E3779B1))
    h = _splitmix64(base + r * np.uint64(1_000_003) + c)
    tokens = (h % np.uint64(cfg.vocab_size)).astype(np.int32)
    out = {"tokens": tokens}
    if cfg.n_frontend_tokens:
        f = np.arange(cfg.n_frontend_tokens, dtype=np.uint64)[None, :, None]
        d = np.arange(cfg.d_model, dtype=np.uint64)[None, None, :]
        hf = _splitmix64(base + r[:, :, None] * np.uint64(7919) +
                         f * np.uint64(104_729) + d)
        out["frontend_embs"] = (
            (hf % np.uint64(2048)).astype(np.float32) / 1024.0 - 1.0)
    return out


class Prefetcher:
    """Bounded background prefetch of step-indexed batches: ``next()``
    gives (step, batch) for start_step, start_step + 1, ..."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, depth: int = 2,
                 shard: int = 0, n_shards: int = 1):
        self.cfg, self.shard, self.n_shards = cfg, shard, n_shards
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            b = batch_at(self.cfg, step, self.shard, self.n_shards)
            while not self._stop.is_set():
                try:
                    self._q.put((step, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        self._t.join(timeout=2)
