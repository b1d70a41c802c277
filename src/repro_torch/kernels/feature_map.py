"""Random-Fourier-feature map: plain PyTorch version and the CUDA launcher.

The CUDA kernel (``csrc/rff_features.cu``) replaces
``rff_features_pallas`` (``repro/kernels/feature_map.py``):
``Phi = scale * cos(X Omega + phase)``, the whole Gram stage of the RFF
low-rank tier, with the cosine epilogue fused before the single store.
Operands come at the compute precision (float32, or bfloat16 for the
mixed-precision path); accumulation and epilogue are float32.
``ops.rff_features`` is the checked entry point; the functions here
assume checked inputs. ``rff_plan`` picks the kernel's tile from the
shape and stages the feature axis as ``tile_f32`` lays it out.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.analysis.compile_guard import memoised
from repro_torch.kernels.tile_f32 import H100_SMS, current_stream, \
    feature_chunk, row_stride

COLS = 128          # columns of Phi a block computes (csrc/rff_features.cu)
ROWS = (64, 128)    # the row tiles the kernel is built for


class RffPlan(NamedTuple):
    rows: int        # rows of X (and of Phi) a block computes: 64 or 128
    chunk: int       # features a ring stage holds
    smem_bytes: int  # dynamic shared memory a block takes
    blocks: int      # grid size


@memoised
def rff_plan(n: int, k: int, d: int, sms: int = H100_SMS,
             rows: int | None = None) -> RffPlan:
    """Tile of ``rff_features`` for an (n, d) x (d, k) map: 128-row
    tiles, unless their grid would not give each of the card's ``sms``
    SMs a block (serving batches), then 64-row ones; or ``rows`` (64 or
    128: a feature's bits do not depend on the tile)."""
    cols = -(-k // COLS)
    if rows is None:
        rows = 128 if -(-n // 128) * cols >= sms else 64
    if rows not in ROWS:
        raise ValueError(f"rff_plan: rows must be one of {ROWS}, got {rows}")
    chunk = feature_chunk(d)
    stages = 1 if -(-d // 4) * 4 <= chunk else 2
    smem = stages * (rows * row_stride(chunk) + chunk * COLS) * 4
    return RffPlan(rows, chunk, smem, -(-n // rows) * cols)


def rff_features_plain(x: torch.Tensor, omega: torch.Tensor,
                       phase: torch.Tensor, *, scale: float) -> torch.Tensor:
    """(n, k) float32 ``scale * cos(x @ omega + phase)`` of x (n, d),
    omega (d, k) and phase (k,), with a float32 product and epilogue."""
    dot = x.to(torch.float32) @ omega.to(torch.float32)
    return scale * torch.cos(dot + phase)


def launch(lib, x, omega, phase, out, *, scale: float,
           plan: RffPlan) -> int:
    n, d = x.shape
    return lib.svm_rff_features(
        x.data_ptr(), omega.data_ptr(), phase.data_ptr(), out.data_ptr(), n,
        omega.shape[1], d, float(scale), int(x.dtype == torch.bfloat16),
        plan.rows, plan.chunk, plan.smem_bytes, current_stream())
