"""Roofline terms of a kernel call on the H100, and a rank's counts of a
sharded program.

``roofline_terms`` converts a call's operation counts and HBM bytes into
the per-device time terms against the card's published peaks: the
counterpart of ``repro/roofline/collect.py``'s ``roofline_terms``, whose
constants are a TPU's. The reference reads its per-device FLOPs and
collective bytes from a compiled XLA program (``cost_analysis``,
``collective_bytes`` over the post-SPMD HLO); here ``RankCounter`` counts
them as one rank runs the program on DTensors: the matrix products of the
local blocks (``torch.utils.flop_counter``'s formulas) and the result
bytes of each functional collective, by kind. ``model_flops`` is the
reference's 6·N·D / 2·N·D rule.
"""
from __future__ import annotations

import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

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


# the functional collectives DTensor issues (torch.ops._c10d_functional),
# by the reference's kinds
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")


def _in_shape_propagation() -> bool:
    """Whether DTensor is running an op on global-shape fake tensors to
    learn its output's shape (``ShardingPropagator._propagate_tensor_
    meta*``): that call is no rank's work."""
    frame = sys._getframe(2)
    while frame is not None:
        if frame.f_code.co_name.startswith("_propagate_tensor_meta"):
            return True
        frame = frame.f_back
    return False


def _bytes(out) -> int:
    outs = out if isinstance(out, (list, tuple)) else [out]
    return sum(t.numel() * t.element_size() for t in outs
               if isinstance(t, torch.Tensor))


class RankCounter(TorchDispatchMode):
    """What one rank runs inside the block: ``flops`` of its local matrix
    products (the ops ``torch.utils.flop_counter`` has formulas for; the
    elementwise ops count none, as XLA's ``flops`` reads only dots and
    convolutions closely), each functional collective's result bytes and
    count by kind (``collectives()``, the reference's
    ``collective_bytes`` layout), and ``peak_bytes``: the most bytes the
    block's own results held alive at once (each new storage counted from
    the op that made it until it is freed; tensors made before the block
    are not counted). An op on DTensors is handed back
    (``NotImplemented``), so the counts are of the local ops DTensor
    issues for this rank, never of the global products."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.per_kind_bytes = {k: 0 for k in KINDS}
        self.counts = {k: 0 for k in KINDS}
        self.live = self.peak_bytes = 0
        self._seen = WeakIdKeyDictionary()

    def _free(self, n: int) -> None:
        self.live -= n

    def _track(self, out) -> None:
        for t in (out if isinstance(out, (list, tuple)) else [out]):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = n
            weakref.finalize(st, self._free, n)
            self.live += n
            self.peak_bytes = max(self.peak_bytes, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _in_shape_propagation():
            return out
        self._track(out)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        elif func.namespace == "_c10d_functional":
            kind = COLLECTIVE_KINDS.get(packet.__name__)
            if kind is not None:
                self.per_kind_bytes[kind] += _bytes(out)
                self.counts[kind] += 1
        return out

    def collectives(self) -> dict:
        return {"per_kind_bytes": dict(self.per_kind_bytes),
                "counts": dict(self.counts),
                "total_bytes": sum(self.per_kind_bytes.values())}


def model_flops(_param_count: int, active_param_count: int, tokens: int,
                *, kind: str) -> float:
    """6·N·D for a train step, 2·N·D for an inference forward: N the
    active parameters (MoE: the routed experts a token takes), D the
    tokens. ``_param_count`` (every parameter) is informational, as in
    the reference."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * active_param_count * tokens
