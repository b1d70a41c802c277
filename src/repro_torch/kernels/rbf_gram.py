"""RBF / linear Gram: plain PyTorch version and the CUDA launchers.

The CUDA kernel (``csrc/rbf_gram.cu``) replaces ``rbf_gram_pallas``
(``repro/kernels/rbf_gram.py``); its note says what bounds it on the
H100 and how the design answers. Both modes take the operands already
at the compute precision (float32, or bfloat16 for the mixed-precision
path) and the squared row norms as float32 vectors computed from those
same rounded values; the epilogue is float32.

The row kernel also has a cached entry that folds in the SMO solver's
LRU row cache (``kernel_engine.RowCache``); ``lru_row_plain`` is that
lookup in plain PyTorch, the one the chunked engine runs.

``ops.rbf_gram`` / ``ops.gram_row`` / ``ops.gram_row_cached`` are the
checked entry points; the functions here assume checked inputs.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels.tile_f32 import current_stream

MODES = ("rbf", "linear")


def _epilogue(dot, a2, b2, gamma: float, mode: str):
    if mode == "linear":
        return dot
    d2 = a2 + b2 - 2.0 * dot
    return torch.exp(-gamma * torch.clamp_min(d2, 0.0))


def rbf_gram_plain(a: torch.Tensor, b: torch.Tensor, a2: torch.Tensor,
                   b2: torch.Tensor, *, gamma: float,
                   mode: str = "rbf") -> torch.Tensor:
    """(n, m) float32 Gram block of a (n, d) and b (m, d)."""
    dot = a.to(torch.float32) @ b.to(torch.float32).T
    return _epilogue(dot, a2[:, None], b2[None, :], gamma, mode)


def gram_row_plain(x: torch.Tensor, x2: torch.Tensor, i: torch.Tensor, *,
                   gamma: float, mode: str = "rbf") -> torch.Tensor:
    """(n,) float32 row K(X, x_i); ``i`` is a 0-d int64 tensor. With the
    task axis — x (T, n, d), x2 (T, n), i (T,) — the (T, n) rows, each
    task's row computed as a lone call computes it."""
    if x.ndim == 3:
        return torch.stack([gram_row_plain(xt, x2t, it, gamma=gamma,
                                           mode=mode)
                            for xt, x2t, it in zip(x, x2, i)])
    xf = x.to(torch.float32)
    z = xf.index_select(0, i.reshape(1))[0]
    return _epilogue(xf @ z, x2, x2.index_select(0, i.reshape(1))[0],
                     gamma, mode)


def lru_row_plain(keys, stamp, rows, clock, hits, misses, i, compute):
    """Row ``i`` through an LRU row cache, its state updated in place:
    the first slot whose key is ``i`` is a hit, else the first slot with
    the least stamp is the victim and receives ``compute(i)``; the slot
    takes key ``i`` and stamp ``clock + 1``, the clock ticks, and the hit
    or miss is counted. The row is computed either way and selected on
    the device, so the host never learns hit or miss. Returns a copy of
    the slot's row."""
    hit_vec = keys == i
    hit = hit_vec.any()
    slot = torch.where(hit, torch.argmax(hit_vec.to(torch.int32)),
                       torch.argmin(stamp))
    slot1 = slot.reshape(1)
    cur = rows.index_select(0, slot1)[0]
    rows.index_copy_(0, slot1, torch.where(hit, cur, compute(i))[None])
    tick = clock + 1
    keys.index_copy_(0, slot1, i.reshape(1).to(torch.int64))
    stamp.index_copy_(0, slot1, tick.reshape(1))
    clock.copy_(tick)
    hits.add_(hit.to(torch.int64))
    misses.add_((~hit).to(torch.int64))
    return rows.index_select(0, slot1)[0]


_tickets: dict = {}   # (device, stream) -> one int32, 0 between launches
_tickets_lock = threading.Lock()


def ticket(device: torch.device, stream: int) -> torch.Tensor:
    """The cached entry's ticket counter of a stream: zeroed once when it
    is made; each launch leaves it at 0 (launches on one stream run in
    order), so a row call allocates nothing besides its output."""
    key = (device, stream)
    with _tickets_lock:
        if key not in _tickets:
            _tickets[key] = torch.zeros(1, dtype=torch.int32, device=device)
        return _tickets[key]


def launch_block(lib, a, b, a2, b2, out, *, gamma: float, mode: str) -> int:
    n, d = a.shape
    m = b.shape[0]
    return lib.svm_rbf_gram_block(
        a.data_ptr(), b.data_ptr(), a2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), n, m, d, float(gamma), int(mode == "rbf"),
        int(a.dtype == torch.bfloat16), current_stream())


def launch_row(lib, x, x2, i, out, *, gamma: float, mode: str) -> int:
    """x (n, d), or (T, n, d) with the task axis."""
    n, d = x.shape[-2:]
    n_tasks = x.shape[0] if x.ndim == 3 else 1
    return lib.svm_rbf_gram_row(
        x.data_ptr(), x2.data_ptr(), i.data_ptr(), out.data_ptr(), n_tasks,
        n, d, float(gamma), int(mode == "rbf"),
        int(x.dtype == torch.bfloat16), current_stream())


def launch_row_cached(lib, x, x2, i, out, keys, stamp, rows, clock, hits,
                      misses, *, gamma: float, mode: str) -> int:
    """x (n, d); the LRU state as ``lru_row_plain`` takes it."""
    n, d = x.shape
    stream = current_stream()
    tk = ticket(x.device, stream)
    return lib.svm_rbf_gram_row_cached(
        x.data_ptr(), x2.data_ptr(), i.data_ptr(), out.data_ptr(),
        keys.data_ptr(), stamp.data_ptr(), rows.data_ptr(), clock.data_ptr(),
        hits.data_ptr(), misses.data_ptr(), keys.shape[0], tk.data_ptr(), n,
        d, float(gamma), int(mode == "rbf"), int(x.dtype == torch.bfloat16),
        stream)
