"""Kernel (Gram) functions for SVM — plain PyTorch path.

Mirrors ``repro/core/kernels.py``: the mathematical kernels K(x, z) used
by the solver and the serving path. The hand-written CUDA versions of
the RBF/linear Gram live in ``repro_torch.kernels``; their plain
versions delegate to the functions here.

All functions take matrices ``A (n, d)`` and ``B (m, d)`` on one device
and return the Gram block ``K (n, m)`` in float32. Products run in full
float32: TF32 would break parity with the reference, so callers on the
card keep ``torch.backends.cuda.matmul.allow_tf32`` False (the default,
and what ``repro_torch.core.kernel_engine`` asserts).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class KernelParams:
    """Hyper-parameters of the SVM kernel function.

    gamma:  RBF / poly / sigmoid scale. ``gamma <= 0`` means "scale":
            1 / (d * Var[X]) resolved at fit time.
    degree: polynomial degree.
    coef0:  poly / sigmoid offset.
    """

    name: str = "rbf"  # linear | poly | rbf | sigmoid
    gamma: float = 1.0
    degree: int = 3
    coef0: float = 0.0


COMPUTE_DTYPES = ("fp32", "bf16")


def _check_compute_dtype(compute_dtype: str) -> None:
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}; "
                         f"expected one of {COMPUTE_DTYPES}")


def _compute_cast(a: torch.Tensor, b: torch.Tensor, compute_dtype: str):
    """Round operands to the Gram compute precision and return them as
    float32. Under "bf16" both the dot and the squared norms see the
    SAME rounded values (products of bf16 values are exact in f32 and
    accumulate in f32), so the RBF zero-distance diagonal stays 1 up to
    f32 summation-order rounding instead of drifting by bf16 epsilon."""
    _check_compute_dtype(compute_dtype)
    if compute_dtype == "bf16":
        a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    return a.to(torch.float32), b.to(torch.float32)


def linear_gram(a: torch.Tensor, b: torch.Tensor, *,
                compute_dtype: str = "fp32") -> torch.Tensor:
    a, b = _compute_cast(a, b, compute_dtype)
    return a @ b.T


def poly_gram(a: torch.Tensor, b: torch.Tensor, *, gamma: float,
              degree: int, coef0: float,
              compute_dtype: str = "fp32") -> torch.Tensor:
    return (gamma * linear_gram(a, b, compute_dtype=compute_dtype)
            + coef0) ** degree


def sigmoid_gram(a: torch.Tensor, b: torch.Tensor, *, gamma: float,
                 coef0: float, compute_dtype: str = "fp32") -> torch.Tensor:
    return torch.tanh(gamma * linear_gram(a, b, compute_dtype=compute_dtype)
                      + coef0)


def sqnorms(a: torch.Tensor, compute_dtype: str = "fp32") -> torch.Tensor:
    """(n,) float32 squared row norms of the compute-precision values —
    the norms every RBF path (plain and kernel) feeds its epilogue."""
    a, _ = _compute_cast(a, a[:0], compute_dtype)
    return torch.sum(a * a, dim=-1)


def sqdist(a: torch.Tensor, b: torch.Tensor, *,
           compute_dtype: str = "fp32") -> torch.Tensor:
    """Pairwise squared Euclidean distances, numerically clamped at 0.

    Norms are accumulated in f32 from the compute-precision values, so
    the ``sqdist(x, x)`` diagonal stays ~0 under bf16; the clamp removes
    the negative residues."""
    a, b = _compute_cast(a, b, compute_dtype)
    a2 = torch.sum(a * a, dim=-1, keepdim=True)        # (n, 1)
    b2 = torch.sum(b * b, dim=-1, keepdim=True).T      # (1, m)
    d2 = a2 + b2 - 2.0 * (a @ b.T)
    return torch.clamp_min(d2, 0.0)


def rbf_gram(a: torch.Tensor, b: torch.Tensor, *, gamma: float,
             compute_dtype: str = "fp32") -> torch.Tensor:
    return torch.exp(-gamma * sqdist(a, b, compute_dtype=compute_dtype))


def make_gram_fn(params: KernelParams, *, compute_dtype: str = "fp32"
                 ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Resolve a KernelParams into an ``(A, B) -> K`` closure.

    ``compute_dtype`` selects the Gram operand precision ("fp32" the
    exact default, "bf16": bf16 operands, f32 accumulation — the plain
    realization of ``EngineConfig.gram_dtype``).
    """
    _check_compute_dtype(compute_dtype)
    name = params.name
    if name == "linear":
        return partial(linear_gram, compute_dtype=compute_dtype)
    if name == "poly":
        return partial(poly_gram, gamma=params.gamma, degree=params.degree,
                       coef0=params.coef0, compute_dtype=compute_dtype)
    if name == "sigmoid":
        return partial(sigmoid_gram, gamma=params.gamma, coef0=params.coef0,
                       compute_dtype=compute_dtype)
    if name == "rbf":
        return partial(rbf_gram, gamma=params.gamma,
                       compute_dtype=compute_dtype)
    raise ValueError(f"unknown kernel {name!r}")


def resolve_gamma(params: KernelParams, x: torch.Tensor) -> KernelParams:
    """Resolve gamma<=0 to the sklearn-style 'scale' heuristic.

    The variance is the POPULATION variance (``correction=0``), as
    ``jnp.var`` computes it; torch's default ``correction=1`` would give
    another gamma and another model. Constant / near-constant features
    get ``gamma = 1.0`` (sklearn's fallback).
    """
    if params.gamma > 0:
        return params
    var = float(torch.var(x.to(torch.float32), correction=0))
    gamma = 1.0 / (x.shape[-1] * var) if var > 1e-12 else 1.0
    return dataclasses.replace(params, gamma=gamma)
