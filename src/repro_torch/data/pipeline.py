"""Dataset utilities: normalization and splits (numpy).

A copy of ``normalize`` / ``train_test_split`` from
``repro/data/pipeline.py``, which imports jax at module level for its
sharded batch iterator; the port keeps its own copy so that it never
imports the reference package.
"""
from __future__ import annotations

import numpy as np


def normalize(x: np.ndarray, *, kind: str = "standard") -> np.ndarray:
    """standard: zero-mean unit-variance per feature; minmax: [0, 1]."""
    x = np.asarray(x, np.float32)
    if kind == "standard":
        mu = x.mean(0, keepdims=True)
        sd = x.std(0, keepdims=True)
        return (x - mu) / np.maximum(sd, 1e-8)
    if kind == "minmax":
        lo = x.min(0, keepdims=True)
        hi = x.max(0, keepdims=True)
        return (x - lo) / np.maximum(hi - lo, 1e-8)
    raise ValueError(kind)


def train_test_split(x: np.ndarray, y: np.ndarray, *, test_frac: float = 0.2,
                     seed: int = 0):
    rng = np.random.default_rng(seed)
    n = len(y)
    perm = rng.permutation(n)
    n_test = int(round(n * test_frac))
    te, tr = perm[:n_test], perm[n_test:]
    return x[tr], y[tr], x[te], y[te]
