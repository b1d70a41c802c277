"""Fused decision values: plain versions and CUDA launchers.

The CUDA kernels (``csrc/decision.cu``) replace ``decision_pallas`` and
``multitask_decision_pallas`` (``repro/kernels/decision.py``): the
kernel block K(z, SV) is contracted with coef on the fly and never
stored. Operands come at the compute precision (float32 or bfloat16),
coef in float32; the bias is added by the caller.
``ops.decision`` / ``ops.multitask_decision`` are the checked entry
points.
"""
from __future__ import annotations

import torch


def multitask_decision_plain(z: torch.Tensor, sv: torch.Tensor,
                             coef: torch.Tensor, *, gamma: float,
                             mode: str = "rbf") -> torch.Tensor:
    """(T, nt) float32: f_t(z) = sum_i coef[t, i] K(sv[t, i], z)."""
    zf = z.to(torch.float32)
    svf = sv.to(torch.float32)
    dot = torch.einsum("nd,twd->tnw", zf, svf)
    if mode == "rbf":
        z2 = torch.sum(zf * zf, dim=1)[None, :, None]
        s2 = torch.sum(svf * svf, dim=2)[:, None, :]
        kblock = torch.exp(-gamma * torch.clamp_min(z2 + s2 - 2.0 * dot, 0.0))
    else:
        kblock = dot
    return torch.sum(kblock * coef[:, None, :], dim=2)


def decision_plain(z: torch.Tensor, x: torch.Tensor, coef: torch.Tensor, *,
                   gamma: float) -> torch.Tensor:
    """(nt,) float32 RBF decision values without bias."""
    return multitask_decision_plain(z, x[None], coef[None], gamma=gamma)[0]


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def launch_decision(lib, z, x, coef, out, *, gamma: float) -> int:
    nt, d = z.shape
    return lib.svm_decision(z.data_ptr(), x.data_ptr(), coef.data_ptr(),
                            out.data_ptr(), nt, x.shape[0], d, float(gamma),
                            int(z.dtype == torch.bfloat16), _stream())


def launch_multitask(lib, z, sv, coef, out, *, gamma: float,
                     mode: str) -> int:
    nt, d = z.shape
    n_tasks, w, _ = sv.shape
    return lib.svm_multitask_decision(
        z.data_ptr(), sv.data_ptr(), coef.data_ptr(), out.data_ptr(), nt,
        n_tasks, w, d, float(gamma), int(mode == "rbf"),
        int(z.dtype == torch.bfloat16), _stream())
