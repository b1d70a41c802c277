"""Masked KKT working-set selection: plain version and CUDA launcher.

The CUDA kernel (``csrc/kkt_select.cu``) replaces ``kkt_select_pallas``
(``repro/kernels/kkt_select.py``) and takes the solver's per-sample box
``[lo, hi]``; with ``lo = 0, hi = C`` it is the Pallas kernel's
``[0, C]`` box. ``ops.kkt_select`` is the checked entry point.
"""
from __future__ import annotations

import torch

THREADS = 256   # csrc/kkt_select.cu KKT_THREADS
MAX_BLOCKS = 264


def kkt_select_plain(f, alpha, y, mask, lo, hi):
    """(b_up, i_up, b_low, i_low) as 0-d tensors: min/argmin of f over
    I_up and max/argmax over I_low, +-inf for empty sets, ties to the
    lowest index (``repro/core/smo.py::_selection``). With the task axis
    — (T, n) inputs — four (T,) tensors, each task selected as a lone
    call selects."""
    if f.ndim == 2:
        per_task = [kkt_select_plain(*a)
                    for a in zip(f, alpha, y, mask, lo, hi)]
        return tuple(torch.stack(v) for v in zip(*per_task))
    eps = 1e-6 * (hi - lo)
    pos, neg = y > 0, y <= 0
    not_upper = alpha < hi - eps    # can increase
    not_lower = alpha > lo + eps    # can decrease
    up_mask = mask & ((pos & not_upper) | (neg & not_lower))
    low_mask = mask & ((pos & not_lower) | (neg & not_upper))
    f_up = torch.where(up_mask, f, torch.inf)
    f_low = torch.where(low_mask, f, -torch.inf)
    i_up = torch.argmin(f_up)
    i_low = torch.argmax(f_low)
    return f_up[i_up], i_up, f_low[i_low], i_low


def n_blocks(n: int) -> int:
    return max(1, min(MAX_BLOCKS, -(-n // THREADS)))


def launch(lib, f, alpha, y, mask, lo, hi, part, vals, idx) -> int:
    """Inputs (n,), or (T, n) with the task axis; ``part`` holds
    2 T n_blocks(n) keys, ``vals`` / ``idx`` 2 T entries."""
    n_tasks = f.shape[0] if f.ndim == 2 else 1
    return lib.svm_kkt_select(
        f.data_ptr(), alpha.data_ptr(), y.data_ptr(), lo.data_ptr(),
        hi.data_ptr(), mask.data_ptr(), n_tasks, f.shape[-1],
        part.data_ptr(), part.shape[0] // (2 * n_tasks), vals.data_ptr(),
        idx.data_ptr(), torch.cuda.current_stream().cuda_stream)
