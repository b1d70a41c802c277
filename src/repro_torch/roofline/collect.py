"""Roofline terms of a kernel call on the H100, and a rank's counts of a
sharded program.

``roofline_terms`` converts a call's operation counts, HBM bytes and
collective bytes into the per-device time terms against the card's
published peaks: the counterpart of ``repro/roofline/collect.py``'s
``roofline_terms``, whose constants are a TPU's. The reference reads its
per-device FLOPs, bytes accessed and collective bytes from a compiled XLA
program (``cost_analysis``, ``collective_bytes`` over the post-SPMD HLO);
here ``RankCounter`` counts them as one rank runs the program on
DTensors: the matrix products of the local blocks
(``torch.utils.flop_counter``'s formulas), the bytes each local op reads
and writes, and the result bytes of each functional collective, by kind
and with the model source line that issued it. ``model_flops`` is the
reference's 6·N·D / 2·N·D rule.
"""
from __future__ import annotations

import os
import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

# NVIDIA H100 80GB HBM3 (SXM) at its 700 W limit, NVIDIA's data sheet
HBM_BW = 3.35e12               # B/s
PEAK_FLOPS_FP32 = 67e12        # FLOP/s, float32 FMAs on the CUDA cores
PEAK_FLOPS_TF32 = 495e12       # FLOP/s, dense TF32 on the tensor cores
PEAK_FLOPS_BF16 = 989e12       # FLOP/s, dense bf16 on the tensor cores
# a card's links, per direction (NVIDIA H100 SXM data sheet): NVLink 4
# (900 GB/s both ways) joins the cards of one HGX node, at most 8; a mesh
# of more cards spans nodes, each card with its own 400 Gb/s NIC
NVLINK_BW = 450e9              # B/s per direction, within a node
NIC_BW = 50e9                  # B/s per direction, one 400 Gb/s NIC a card
NODE_CARDS = 8                 # cards one NVLink domain (HGX node) holds


def collective_bw(n_ranks: int) -> float:
    """A card's collective bandwidth in a mesh of ``n_ranks`` cards:
    NVLink within one node, else the NIC (a ring over cards of several
    nodes goes at the pace of its slowest link)."""
    return NVLINK_BW if n_ranks <= NODE_CARDS else NIC_BW


def roofline_terms(*, hbm_bytes: float, fp32_flops: float = 0.0,
                   tf32_flops: float = 0.0, bf16_flops: float = 0.0,
                   collective_bytes_total: float = 0.0,
                   n_ranks: int = 1) -> dict:
    """Per-device seconds of each term. The tensor cores and the CUDA
    cores run side by side, so the compute term is the slowest of the
    three rates' shares (3xTF32 is three TF32 passes: pass 3x the
    product's operations as ``tf32_flops``). The collective term divides
    the rank's collective result bytes by one card's link rate in a mesh
    of ``n_ranks`` (``collective_bw``): the reference's optimistic ring
    assumption, consistent across configurations, so that relative
    comparisons hold."""
    t_compute = max(fp32_flops / PEAK_FLOPS_FP32,
                    tf32_flops / PEAK_FLOPS_TF32,
                    bf16_flops / PEAK_FLOPS_BF16)
    t_memory = hbm_bytes / HBM_BW
    t_coll = collective_bytes_total / collective_bw(n_ranks)
    dom = max((t_compute, "compute"), (t_memory, "memory"),
              (t_coll, "collective"))
    return {"t_compute_s": t_compute, "t_memory_s": t_memory,
            "t_collective_s": t_coll, "dominant": dom[1],
            "t_total_est_s": dom[0]}


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


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _shape(out):
    if isinstance(out, (list, tuple)):
        return [list(t.shape) for t in out]
    return list(out.shape)


_MODELS = os.sep + os.path.join("repro_torch", "models") + os.sep


def _model_frame() -> str:
    """``models/<file>:<line> <function>`` of the innermost frame in the
    port's ``models/`` package (the counterpart of the reference's
    ``op_name`` metadata), ``?`` where none is on the stack."""
    frame = sys._getframe(2)
    while frame is not None:
        path = frame.f_code.co_filename
        at = path.rfind(_MODELS)
        if at >= 0:
            rel = path[at + len(os.sep + "repro_torch" + os.sep):]
            return (f"{rel.replace(os.sep, '/')}:{frame.f_lineno} "
                    f"{frame.f_code.co_name}")
        frame = frame.f_back
    return "?"


class RankCounter(TorchDispatchMode):
    """What one rank runs inside the block: ``flops`` of its local matrix
    products (the ops ``torch.utils.flop_counter`` has formulas for; the
    elementwise ops count none, as XLA's ``flops`` reads only dots and
    convolutions closely), ``bytes_accessed``: the bytes of every local
    op's input and output tensors (views count none; the counterpart of
    XLA's ``bytes accessed``, which is counted after fusion, whereas
    eager ops are unfused, so this is an unfused upper estimate of the
    HBM traffic), each functional collective's result bytes and count by
    kind (``collectives()``, the reference's ``collective_bytes``
    layout) and, in ``records``, each one's bytes, kind, result shape and
    the model source line that issued it (``inspect_hlo``), and
    ``peak_bytes``: the most bytes the block's own results held alive at
    once (each new storage counted from the op that made it until it is
    freed; tensors made before the block are not counted). An op on
    DTensors is handed back (``NotImplemented``), so the counts are of
    the local ops DTensor issues for this rank, never of the global
    products."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.per_kind_bytes = {k: 0 for k in KINDS}
        self.counts = {k: 0 for k in KINDS}
        self.records: list[dict] = []
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
        if func.namespace == "_c10d_functional":
            kind = COLLECTIVE_KINDS.get(packet.__name__)
            if kind is not None:
                n = _bytes(out)
                self.per_kind_bytes[kind] += n
                self.counts[kind] += 1
                self.records.append({"bytes": n, "kind": kind,
                                     "shape": _shape(out),
                                     "source": _model_frame()})
            return out
        if not func.is_view:
            self.bytes_accessed += _bytes((args, kwargs)) + _bytes(out)
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
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
