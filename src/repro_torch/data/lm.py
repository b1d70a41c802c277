"""Synthetic language-model token pipeline (the port's copy of
``repro/data/lm.py``: the seeded prompts of the LM serving path).

No corpus ships with the repository; this generates a deterministic, structured
token stream a transformer can actually learn (so loss curves are
meaningful): a Markov-ish "grammar" over the vocab with local n-gram
structure plus copy spans — losses drop well below uniform as the model
learns.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


def _markov_stream(rng: np.random.Generator, vocab: int, length: int,
                   table: np.ndarray) -> np.ndarray:
    """Tokens from a sparse random transition table + copy spans."""
    order_states = table.shape[0]
    out = np.empty(length, np.int32)
    s = 0
    i = 0
    while i < length:
        if rng.random() < 0.05 and i > 32:
            # copy span: repeat a recent window (in-context structure)
            span = int(rng.integers(8, 32))
            start = int(rng.integers(max(0, i - 256), i - span)) if i - span > 0 else 0
            take = min(span, length - i)
            out[i:i + take] = out[start:start + take]
            i += take
            continue
        tok = int(table[s, int(rng.integers(0, 8))])
        out[i] = tok
        s = tok % order_states
        i += 1
    return out


def token_batches(*, vocab_size: int, batch: int, seq_len: int,
                  n_batches: int, seed: int = 0) -> Iterator[dict]:
    """Yields {tokens: (batch, seq_len) int32, labels: same (shift-by-1)}."""
    rng = np.random.default_rng(seed)
    # ONE fixed transition table for the whole stream — the learnable
    # structure must be stable across batches
    table = rng.integers(0, vocab_size, size=(257, 8))
    for _ in range(n_batches):
        stream = _markov_stream(rng, vocab_size, batch * (seq_len + 1),
                                table)
        chunk = stream.reshape(batch, seq_len + 1)
        yield {"tokens": chunk[:, :-1].astype(np.int32),
               "labels": chunk[:, 1:].astype(np.int32)}
