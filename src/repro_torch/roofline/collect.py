"""Roofline terms of a kernel call on the H100.

``roofline_terms`` converts a call's operation counts and HBM bytes into
the per-device time terms against the card's published peaks: the
counterpart of ``repro/roofline/collect.py``'s ``roofline_terms``, whose
constants are a TPU's. The reference's HLO parsing (``collective_bytes``,
``model_flops``) reads XLA programs and has no counterpart here yet.
"""
from __future__ import annotations

# NVIDIA H100 80GB HBM3 (SXM) at its 700 W limit, NVIDIA's data sheet
HBM_BW = 3.35e12               # B/s
PEAK_FLOPS_FP32 = 67e12        # FLOP/s, float32 FMAs on the CUDA cores
PEAK_FLOPS_TF32 = 495e12       # FLOP/s, dense TF32 on the tensor cores
PEAK_FLOPS_BF16 = 989e12       # FLOP/s, dense bf16 on the tensor cores


def roofline_terms(*, hbm_bytes: float, fp32_flops: float = 0.0,
                   tf32_flops: float = 0.0, bf16_flops: float = 0.0) -> dict:
    """Per-device seconds of each term. The tensor cores and the CUDA
    cores run side by side, so the compute term is the slowest of the
    three rates' shares (3xTF32 is three TF32 passes: pass 3x the
    product's operations as ``tf32_flops``)."""
    t_compute = max(fp32_flops / PEAK_FLOPS_FP32,
                    tf32_flops / PEAK_FLOPS_TF32,
                    bf16_flops / PEAK_FLOPS_BF16)
    t_memory = hbm_bytes / HBM_BW
    return {"t_compute_s": t_compute, "t_memory_s": t_memory,
            "dominant": "compute" if t_compute > t_memory else "memory",
            "t_total_est_s": max(t_compute, t_memory)}
