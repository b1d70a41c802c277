"""Masked KKT working-set selection: plain version and CUDA launcher.

The CUDA kernel (``csrc/kkt_select.cu``) replaces ``kkt_select_pallas``
(``repro/kernels/kkt_select.py``) and takes the solver's per-sample box
``[lo, hi]``; with ``lo = 0, hi = C`` it is the Pallas kernel's
``[0, C]`` box. One launch a call: ``n_blocks`` blocks a task, whose
keys the last block of the task to finish combines. ``ops.kkt_select``
is the checked entry point.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels.tile_f32 import current_stream

THREADS = 256       # csrc/kkt_select.cu KKT_THREADS
MAX_BLOCKS = 128


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
    """Blocks a task: one float4 of the inputs a thread (29 at n =
    29,491), at most MAX_BLOCKS (their threads then take several)."""
    return max(1, min(MAX_BLOCKS, -(-n // (4 * THREADS))))


_scratch: dict = {}   # (device, stream) -> (keys int64, tickets int32)
_scratch_lock = threading.Lock()


def scratch(blocks: int, n_tasks: int, device: torch.device, stream: int):
    """(keys, tickets) of a launch, kept per stream and grown when a
    launch needs more: room for 2 T blocks keys and T tickets. The kernel
    leaves its tickets at 0, so they are zeroed only when made, and a
    call allocates nothing besides its outputs."""
    key = (device, stream)
    with _scratch_lock:
        keys, tickets = _scratch.get(key, (None, None))
        if keys is None or keys.numel() < 2 * n_tasks * blocks:
            keys = torch.empty(max(2 * n_tasks * blocks, 4096),
                               dtype=torch.int64, device=device)
        if tickets is None or tickets.numel() < n_tasks:
            tickets = torch.zeros(max(n_tasks, 256), dtype=torch.int32,
                                  device=device)
        _scratch[key] = (keys, tickets)
    return keys, tickets


def launch(lib, f, alpha, y, mask, lo, hi, vals, idx, *,
           blocks: int | None = None, stream: int | None = None) -> int:
    """Inputs (n,), or (T, n) with the task axis; ``vals`` / ``idx`` hold
    2 T entries (each side's value of every task, then the other's);
    ``blocks`` a task, ``n_blocks(n)`` unless given."""
    n_tasks = f.shape[0] if f.ndim == 2 else 1
    n = f.shape[-1]
    blocks = n_blocks(n) if blocks is None else blocks
    stream = current_stream() if stream is None else stream
    keys, tickets = scratch(blocks, n_tasks, f.device, stream)
    return lib.svm_kkt_select(
        f.data_ptr(), alpha.data_ptr(), y.data_ptr(), lo.data_ptr(),
        hi.data_ptr(), mask.data_ptr(), n_tasks, n, blocks, keys.data_ptr(),
        tickets.data_ptr(), vals.data_ptr(), idx.data_ptr(), stream)
