"""Staging layout of the redesigned Gram-shaped kernels, as
``csrc/tile_f32.cuh`` defines it, for the launch plans of
``feature_map.rff_plan`` and ``decision.decision_plan``. A plan's
``smem_bytes`` goes to the launch, and the kernel refuses one that
differs from what the C++ side computes, so the two stay in step.
Also the stream handle their launches take, and the check that keeps
their per-stream scratch out of a CUDA graph capture.
"""
from __future__ import annotations

import torch

RES_WIDTH = 128     # widest feature axis staged whole
CHUNK = 64          # features a ring stage holds past it
H100_SMS = 132      # SMs of the card the plans default to


def row_stride(width: int) -> int:
    """Floats between staged rows of ``width`` features: a multiple of 4
    (rows stay 16-byte aligned) whose quarter is odd (conflict-free
    float4 reads of 8 rows at one offset)."""
    w4 = -(-width // 4) * 4
    return w4 if (w4 // 4) % 2 else w4 + 4


def current_stream() -> int:
    """Handle of the current device's current CUDA stream, by torch's
    raw-stream call: building a ``torch.cuda.Stream`` object instead
    costs several microseconds, a real share of a one-row serving
    call."""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


def refuse_in_capture(what: str) -> None:
    """Raise if the current stream is capturing a CUDA graph: a stream's
    scratch made there would come from the graph's private pool, and its
    zeroing would be a graph node that no eager launch waits for. The
    capturing code makes the scratch on its stream first
    (``ops.block_scratch``). Without an initialized CUDA context
    nothing captures."""
    if torch.cuda.is_initialized() and \
            torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{what}: a stream's scratch would be made "
                           "inside a CUDA graph capture; make it on the "
                           "capture stream before the capture")


def feature_chunk(d: int) -> int:
    """Features a ring stage holds: d rounded up to 4 while that is at
    most RES_WIDTH (staged once), else CHUNK (a two-stage ring)."""
    d4 = -(-d // 4) * 4
    return d4 if d4 <= RES_WIDTH else CHUNK
