"""LM token pipeline (mirrors `repro/data/lm_data.py`): a deterministic
synthetic token stream and a background prefetcher.

The stream is numpy with the reference's draws, so both packages train on
the same tokens from the same seed. The prefetcher loads `depth` batches
ahead on a daemon thread; a producer's error is raised by the next `get`.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


def synthetic_token_stream(vocab_size: int, seq_len: int, batch_size: int,
                           seed: int = 0, n_codebooks: int = 0
                           ) -> Iterator[dict]:
    """Markov-ish synthetic tokens (next-token structure so loss can fall):
    ``tokens`` and ``labels`` (batch, seq_len) int32 (with a codebook axis
    if `n_codebooks`), and ``step``. Every odd position holds the even
    position before it plus one, mod `vocab_size`."""
    rng = np.random.default_rng(seed)
    step = 0
    while True:
        shape = ((batch_size, n_codebooks, seq_len + 1) if n_codebooks
                 else (batch_size, seq_len + 1))
        toks = rng.integers(0, vocab_size, shape)
        toks[..., 1::2] = (toks[..., 0::2][..., : toks[..., 1::2].shape[-1]]
                           + 1) % vocab_size
        yield {"tokens": toks[..., :-1].astype(np.int32),
               "labels": toks[..., 1:].astype(np.int32),
               "step": step}
        step += 1


class PrefetchIterator:
    """Background-thread prefetcher with a bounded queue.

    `depth` items are loaded ahead; `get(timeout)` raises `queue.Empty`
    on a stuck producer, the producer's own exception once it failed, and
    `StopIteration` at the end of the stream.
    """

    def __init__(self, it: Iterator, depth: int = 4):
        self._it = it
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._err: Exception | None = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        except Exception as e:  # surfaced on the next get()
            self._err = e
        finally:
            self._q.put(self._done)

    def get(self, timeout: float | None = None):
        item = self._q.get(timeout=timeout)
        if item is self._done:
            # put the marker back: every later get() ends the same way
            self._q.put(self._done)
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def __iter__(self):
        return self

    def __next__(self):
        return self.get()
