"""RBF / linear Gram: plain PyTorch version and the CUDA launchers.

The CUDA kernel (``csrc/rbf_gram.cu``) replaces ``rbf_gram_pallas``
(``repro/kernels/rbf_gram.py``); its note says what bounds it on the
H100 and how the design answers. Both modes take the operands already
at the compute precision (float32, or bfloat16 for the mixed-precision
path) and the squared row norms as float32 vectors computed from those
same rounded values; the epilogue is float32.

``ops.rbf_gram`` / ``ops.gram_row`` are the checked entry points; the
functions here assume checked inputs.
"""
from __future__ import annotations

import torch

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


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def launch_block(lib, a, b, a2, b2, out, *, gamma: float, mode: str) -> int:
    n, d = a.shape
    m = b.shape[0]
    return lib.svm_rbf_gram_block(
        a.data_ptr(), b.data_ptr(), a2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), n, m, d, float(gamma), int(mode == "rbf"),
        int(a.dtype == torch.bfloat16), _stream())


def launch_row(lib, x, x2, i, out, slot, skip, *, gamma: float,
               mode: str) -> int:
    """x (n, d), or (T, n, d) with the task axis."""
    n, d = x.shape[-2:]
    n_tasks = x.shape[0] if x.ndim == 3 else 1
    return lib.svm_rbf_gram_row(
        x.data_ptr(), x2.data_ptr(), i.data_ptr(), out.data_ptr(),
        None if slot is None else slot.data_ptr(),
        None if skip is None else skip.data_ptr(), n_tasks, n, d,
        float(gamma), int(mode == "rbf"), int(x.dtype == torch.bfloat16),
        _stream())
