"""Random-Fourier-feature map: plain PyTorch version and the CUDA launcher.

The CUDA kernel (``csrc/rff_features.cu``) replaces
``rff_features_pallas`` (``repro/kernels/feature_map.py``):
``Phi = scale * cos(X Omega + phase)``, the whole Gram stage of the RFF
low-rank tier, with the cosine epilogue fused before the single store.
Operands come at the compute precision (float32, or bfloat16 for the
mixed-precision path); accumulation and epilogue are float32.
``ops.rff_features`` is the checked entry point; the functions here
assume checked inputs.
"""
from __future__ import annotations

import torch


def rff_features_plain(x: torch.Tensor, omega: torch.Tensor,
                       phase: torch.Tensor, *, scale: float) -> torch.Tensor:
    """(n, k) float32 ``scale * cos(x @ omega + phase)`` of x (n, d),
    omega (d, k) and phase (k,), with a float32 product and epilogue."""
    dot = x.to(torch.float32) @ omega.to(torch.float32)
    return scale * torch.cos(dot + phase)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def launch(lib, x, omega, phase, out, *, scale: float) -> int:
    n, d = x.shape
    return lib.svm_rff_features(
        x.data_ptr(), omega.data_ptr(), phase.data_ptr(), out.data_ptr(), n,
        omega.shape[1], d, float(scale), int(x.dtype == torch.bfloat16),
        _stream())
