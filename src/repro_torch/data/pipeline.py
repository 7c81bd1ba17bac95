"""Data pipeline: deterministic, *seekable* synthetic LM stream + a bounded
host-side prefetch queue (the host-level COPIFTv2 analogue: producer thread
and consumer training loop coupled by a blocking FIFO).

A copy of the JAX package's ``data/pipeline.py`` (numpy only, no JAX), so
that the port imports nothing of it; its batches equal the JAX package's
bit for bit (a test holds the copy to the original).

Seekability is the fault-tolerance contract: ``batch_at(step)`` is a pure
function of (seed, step), so resuming from a checkpointed step reproduces
the exact token stream — no iterator state to persist beyond the step."""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np


class SyntheticLMStream:
    """Language-modeling batches over a Zipf-ish synthetic token process."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, dp_rank: int = 0, dp_size: int = 1):
        assert global_batch % dp_size == 0
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.local_batch = global_batch // dp_size
        self.seed = seed
        self.dp_rank = dp_rank
        self.dp_size = dp_size

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.Generator(np.random.Philox(
            key=self.seed, counter=[step, self.dp_rank, 0, 0]))
        # learnable structure: mixture of a repeated motif and noise so a
        # ~1e8-param model shows a falling loss within a few hundred steps
        B, S = self.local_batch, self.seq_len + 1
        base = rng.zipf(1.5, size=(B, S)).clip(1, self.vocab - 1)
        motif = (np.arange(S)[None] * 7 + rng.integers(0, 13, (B, 1))) \
            % max(self.vocab // 4, 2)
        use_motif = rng.random((B, S)) < 0.7
        toks = np.where(use_motif, motif, base).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class PrefetchLoader:
    """Bounded producer/consumer queue between the data thread and the
    device step — blocking FIFO semantics, depth = ``depth``."""

    _STOP = object()

    def __init__(self, stream: SyntheticLMStream, start_step: int = 0,
                 depth: int = 4):
        self.stream = stream
        self.queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self) -> None:
        step = self._step
        while not self._stop.is_set():
            batch = self.stream.batch_at(step)
            while not self._stop.is_set():
                try:
                    self.queue.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def get(self) -> Dict[str, np.ndarray]:
        step, batch = self.queue.get()
        return batch

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)
