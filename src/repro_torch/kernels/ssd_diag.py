"""SSD intra-chunk term: plain PyTorch version and the CUDA launcher.

The CUDA kernel (``csrc/ssd_diag.cu``) replaces ``ssd_diag_pallas``
(``repro/kernels/ssd_diag.py``): per (chunk, head) the masked quadratic
form ``Y = ((C B^T) * L * dt_k) x`` of the Mamba-2 SSD scan, with the
decay ``L[q, k] = exp(cs_q - cs_k)`` for k <= q and 0 above the
diagonal, all in float32. ``ops.ssd_diag`` is the checked entry point;
the functions here assume checked inputs.
"""
from __future__ import annotations

import torch


def ssd_diag_plain(cmat: torch.Tensor, bmat: torch.Tensor, x: torch.Tensor,
                   dt: torch.Tensor, cs: torch.Tensor) -> torch.Tensor:
    """(BC, H, Q, P) float32 of C, B (BC, Q, N), x (BC, H, Q, P) and
    dt, cs (BC, H, Q) — the reference's oracle
    (``repro/kernels/ref.py::ssd_diag``) written in torch. ``where``
    selects the decay, so an overflowing exp above the diagonal never
    meets a zero."""
    scores = torch.einsum("cqn,ckn->cqk", cmat, bmat)
    seg = cs[:, :, :, None] - cs[:, :, None, :]             # (BC, H, Q, Q)
    q = cmat.shape[1]
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=cmat.device))
    l_mat = torch.where(causal, torch.exp(seg), 0.0)
    w = scores[:, None] * l_mat * dt[:, :, None, :]
    return torch.einsum("chqk,chkp->chqp", w, x)


def launch(lib, cmat, bmat, x, dt, cs, out) -> int:
    bc, q, n = cmat.shape
    h, p = x.shape[1], x.shape[3]
    return lib.svm_ssd_diag(
        cmat.data_ptr(), bmat.data_ptr(), x.data_ptr(), dt.data_ptr(),
        cs.data_ptr(), out.data_ptr(), bc, h, q, n, p,
        torch.cuda.current_stream().cuda_stream)
