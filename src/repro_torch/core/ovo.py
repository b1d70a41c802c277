"""One-vs-one multiclass decomposition, legacy padded stack (paper Sec.
III, Fig. 4).

Mirrors ``repro/core/ovo.py``. ``OvOTasks`` is the fixed-shape input of
the ``dist.vmapped_ovo_fit`` shim; new code goes through the strategy
layer (``core.multiclass.OneVsOneStrategy``) and ``dist.fit_taskset``.

For m classes the problem splits into C = m(m-1)/2 independent binary
subproblems, built on the host (numpy) as zero-padded arrays:

  x_tasks   (C, n_task, d)   samples of the two classes, zero-padded
  y_tasks   (C, n_task)      +1 / -1, 0 on padding
  mask      (C, n_task)      validity
  pairs     (C, 2)           (class_a -> +1, class_b -> -1)

Prediction is a majority vote over the C binary decisions, ties broken
toward the larger margin, then the lower class index (LIBSVM).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import multiclass as MC


class OvOTasks(NamedTuple):
    x: np.ndarray      # (C, n_task, d)
    y: np.ndarray      # (C, n_task)
    mask: np.ndarray   # (C, n_task)
    pairs: np.ndarray  # (C, 2) original class labels
    classes: np.ndarray  # (m,) sorted unique labels


def n_binary_tasks(m: int) -> int:
    return m * (m - 1) // 2


def build_tasks(x: np.ndarray, y: np.ndarray,
                pad_tasks_to: int | None = None) -> OvOTasks:
    """Host-side task construction. ``pad_tasks_to`` pads the task axis
    (with empty dummy tasks) to a multiple of the worker count — the
    static partition ``N = C / P`` of the paper's Fig. 4."""
    x = np.asarray(x, dtype=np.float32)
    y = np.asarray(y)
    classes = np.unique(y)
    if len(classes) < 2:
        raise ValueError("need at least 2 classes")
    pairs = [(a, b) for ai, a in enumerate(classes) for b in classes[ai + 1:]]
    members = {c: np.where(y == c)[0] for c in classes}
    n_task = max(len(members[a]) + len(members[b]) for a, b in pairs)

    c_total = len(pairs) if pad_tasks_to is None else max(
        len(pairs), -(-len(pairs) // pad_tasks_to) * pad_tasks_to)

    d = x.shape[1]
    xt = np.zeros((c_total, n_task, d), np.float32)
    yt = np.zeros((c_total, n_task), np.float32)
    mk = np.zeros((c_total, n_task), bool)
    pr = np.zeros((c_total, 2), y.dtype if y.dtype.kind in "if" else np.int64)
    for t, (a, b) in enumerate(pairs):
        ia, ib = members[a], members[b]
        k = len(ia) + len(ib)
        xt[t, :k] = np.concatenate([x[ia], x[ib]], axis=0)
        yt[t, :len(ia)] = 1.0
        yt[t, len(ia):k] = -1.0
        mk[t, :k] = True
        pr[t] = (a, b)
    return OvOTasks(x=xt, y=yt, mask=mk, pairs=pr, classes=classes)


def vote(decisions, pairs: np.ndarray, classes: np.ndarray,
         n_real_tasks: int) -> torch.Tensor:
    """Majority vote over ``decisions (C_padded, n_test)``: (n_test,)
    predicted class indices into ``classes``."""
    cls_index = {c: i for i, c in enumerate(classes)}
    pair_idx = np.array(
        [[cls_index[a], cls_index[b]]
         for a, b in np.asarray(pairs)[:n_real_tasks]], np.int64)
    df = torch.as_tensor(decisions, dtype=torch.float32)[:n_real_tasks]
    return MC.vote_decision(df, pair_idx, len(classes))
