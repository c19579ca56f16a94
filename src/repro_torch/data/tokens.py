"""Deterministic synthetic token pipeline.

Design goals (the ones that matter at 1000+ nodes):

* **stateless addressing** — batch ``i`` is a pure function of
  (seed, step), so any host can (re)produce its shard after restart or
  elastic resharding without replaying the stream;
* **per-host sharding** — each host materialises only its slice of the
  global batch (rows ``[lo, hi)`` of ``batch_at``);
* **prefetch** — a small background thread keeps ``depth`` batches ready.

The generator is a mixture of Zipf-distributed unigrams and short
repeated motifs, which gives a non-degenerate loss curve for the
examples (``examples/torch_train_lm.py`` trains ~100M params on it).

Numpy only: the same seed gives the same arrays as the reference's copy.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np


class SyntheticTokens:
    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, zipf_a: float = 1.3,
                 motif_len: int = 16, n_motifs: int = 512):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.zipf_a = zipf_a
        rng = np.random.default_rng(seed)
        self.motifs = rng.integers(0, vocab, (n_motifs, motif_len),
                                   dtype=np.int32)

    def batch_at(self, step: int, lo: int = 0,
                 hi: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Rows [lo, hi) of the global batch for ``step`` — pure function."""
        hi = self.global_batch if hi is None else hi
        rows = []
        for r in range(lo, hi):
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, step, r]))
            seq = rng.integers(
                1, self.vocab,
                self.seq_len + 1).astype(np.int32)
            # overlay zipf-heavy tokens
            z = rng.zipf(self.zipf_a, self.seq_len + 1).astype(np.int64)
            seq = np.where(z < self.vocab, z.astype(np.int32), seq)
            # paste motifs (so the model has something learnable)
            for _ in range(4):
                m = self.motifs[rng.integers(0, len(self.motifs))]
                p = rng.integers(0, self.seq_len + 1 - m.size)
                seq[p:p + m.size] = m
            rows.append(seq)
        arr = np.stack(rows)
        return arr[:, :-1], arr[:, 1:]

    def prefetch(self, start_step: int, depth: int = 2,
                 lo: int = 0, hi: Optional[int] = None) -> Iterator:
        """Background-thread prefetching iterator from ``start_step``."""
        q: queue.Queue = queue.Queue(maxsize=depth)
        stop = threading.Event()

        def worker():
            s = start_step
            while not stop.is_set():
                q.put((s, self.batch_at(s, lo, hi)))
                s += 1

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
