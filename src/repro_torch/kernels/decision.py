"""Fused decision values: plain versions and CUDA launchers.

The CUDA kernels (``csrc/decision.cu``) replace ``decision_pallas`` and
``multitask_decision_pallas`` (``repro/kernels/decision.py``): the
kernel block K(z, SV) is contracted with coef on the fly and never
stored. Operands come at the compute precision (float32 or bfloat16),
coef in float32; the bias is added by the caller. Under float32 compute
the multitask kernel also reads a quantized (float16 or bfloat16) bank
at its storage dtype, staging it 16-bit and widening it in registers,
with the float32 kernel's bits on the upcast bank; the plain version
upcasts it.
``ops.decision`` / ``ops.multitask_decision`` are the checked entry
points. ``decision_plan`` picks the kernel's tile and how many blocks
share a task's SV axis; ``scratch`` holds what split launches need.
The kernel folds a row's sum in an order fixed by the bank's width, so
a row's decision does not depend on the plan or on the batch it came in.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import NamedTuple

import torch

from repro_torch.analysis.compile_guard import memoised
from repro_torch.kernels.tile_f32 import H100_SMS, current_stream, \
    feature_chunk, refuse_in_capture, row_stride

SV_TILE = 64        # SVs a ring stage of csrc/decision.cu holds
MAX_SEGMENTS = 64   # partial sums a (task, row) a split launch keeps
# the bank dtypes the kernel reads, by csrc/decision.cu's BANK_* codes
BANK_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


class DecisionPlan(NamedTuple):
    rows: int        # test rows a block holds: 64 or 128
    splits: int      # blocks that share one task's SV axis
    seg: int         # SV tiles a segment (a function of the width alone)
    segments: int    # segments of the bank: partial sums a (task, row)
    chunk: int       # features a ring stage holds
    smem_bytes: int  # dynamic shared memory a block takes
    blocks: int      # grid size


def bank_bytes(bank: torch.dtype) -> int:
    """Bytes of a staged SV element: a 16-bit bank (float16, bfloat16)
    is staged as stored, a float32 one as float32."""
    if bank not in BANK_DTYPES:
        raise ValueError(f"no decision kernel for a {bank} bank")
    return 4 if bank == torch.float32 else 2


def segment_tiles(w: int) -> int:
    """SV tiles in one segment of a bank of w SVs: the fewest that keep
    the segments at most MAX_SEGMENTS. The kernel adds a row's tiles
    within a segment, then the segments, in order; splits take whole
    segments, so the order, and the bits, depend on w alone."""
    return max(1, -(-max(1, -(-w // SV_TILE)) // MAX_SEGMENTS))


def _split_cost(blocks: int, splits: int, segments: int, seg: int,
                sms: int) -> float:
    """Time of a split launch in SV-tile steps of one SM: blocks queue
    evenly over the SMs, a block walks ceil(segments / splits) segments
    of seg tiles plus about half a tile of its own (staging the test
    rows, the combine)."""
    return (math.ceil(blocks * splits / sms)
            * (math.ceil(segments / splits) * seg + 0.5))


@memoised
def decision_plan(nt: int, n_tasks: int, w: int, d: int,
                  sms: int = H100_SMS, rows: int | None = None,
                  splits: int | None = None,
                  bank: torch.dtype = torch.float32) -> DecisionPlan:
    """Tile and SV-axis split of the decision kernel for nt test rows
    against n_tasks banks of w SVs of d features (of dtype ``bank``,
    which sizes the SV stages) on a card of ``sms`` SMs. 128-row tiles
    for more than 64 rows once the grid, split to single SV tiles, could
    fill two blocks an SM; else 64. No split
    (splits = 1) when the (row tile x task) grid already gives every SM
    a block; else the count, at most one segment a split, that
    ``_split_cost`` puts first (the fewest splits among equals). A given
    ``rows`` or ``splits`` replaces that choice (``plan_with`` checks
    it)."""
    sv_tiles = max(1, -(-w // SV_TILE))
    seg = segment_tiles(w)
    segments = -(-sv_tiles // seg)
    if rows is None:
        rows = (128 if nt > 64
                and -(-nt // 128) * n_tasks * sv_tiles >= 2 * sms else 64)
    if splits is None:
        blocks = -(-nt // rows) * n_tasks
        splits = 1
        if blocks < sms:
            splits = min(range(1, segments + 1), key=lambda s: _split_cost(
                blocks, s, segments, seg, sms))
    return plan_with(nt, n_tasks, w, d, rows, splits, bank)


def plan_with(nt: int, n_tasks: int, w: int, d: int, rows: int,
              splits: int, bank: torch.dtype = torch.float32
              ) -> DecisionPlan:
    """The plan of a launch with a given row tile and split count (what
    ``decision_plan`` chose, or another for a sweep or a test), for a
    bank of dtype ``bank``."""
    seg = segment_tiles(w)
    segments = -(-max(1, -(-w // SV_TILE)) // seg)
    if rows not in (64, 128) or not 1 <= splits <= segments:
        raise ValueError(f"no plan of {rows} rows and {splits} splits for "
                         f"{segments} segments")
    chunk = feature_chunk(d)
    z_tiles = 1 if -(-d // 4) * 4 <= chunk else 2
    # the float32 test-row tile(s), the norms, 4 running sums a row, and
    # two SV stages at the bank's element size
    smem = ((z_tiles * rows * row_stride(chunk) + rows + SV_TILE
             + 4 * rows) * 4
            + 2 * SV_TILE * row_stride(chunk) * bank_bytes(bank))
    return DecisionPlan(rows, splits, seg, segments, chunk, smem,
                        -(-nt // rows) * n_tasks * splits)


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


_scratch: dict = {}   # (device, stream) -> (partial float32, tickets int32)
_scratch_lock = threading.Lock()


def scratch(plan: DecisionPlan, n_tasks: int, nt: int,
            device: torch.device, stream: int):
    """(partial, ticket) for a launch of ``plan``: room for (T,
    segments, nt) float2 partial sums and the ticket counters, both kept per
    stream and grown when a launch needs more; (None, None) without a
    split. Launches on one stream run in order and the kernel leaves its
    tickets at 0, so a stream's buffers serve every launch on it, and
    the tickets are zeroed only when they are made: an eager serving call
    allocates and launches nothing besides the kernel.

    A CUDA graph bakes in the pointers it was captured with, so a
    stream's buffers must not serve a capture: a later growth would free
    them under the graph, and two graphs sharing them would race on the
    tickets when replayed at once. A capturing ``serve.Predictor`` owns
    its scratch instead (``own_scratch``), made once at the most any plan
    of its banks takes and installed for the stream only while it
    captures (``installed``); growing a stream's buffers inside a
    capture raises (``refuse_in_capture``)."""
    if plan.splits == 1:
        return None, None
    need_p = 2 * n_tasks * plan.segments * nt
    need_t = n_tasks * -(-nt // plan.rows)
    key = (device, stream)
    with _scratch_lock:
        partial, ticket = _scratch.get(key, (None, None))
        if (partial is None or partial.numel() < need_p or ticket is None
                or ticket.numel() < need_t):
            refuse_in_capture("decision")
        if partial is None or partial.numel() < need_p:
            partial = torch.empty(max(need_p, 65536), dtype=torch.float32,
                                  device=device)
        if ticket is None or ticket.numel() < need_t:
            ticket = torch.zeros(max(need_t, 4096), dtype=torch.int32,
                                 device=device)
        _scratch[key] = (partial, ticket)
    return partial, ticket


def own_scratch(banks, rows: int, device: torch.device) -> tuple:
    """New (partial, ticket) buffers, shared with no stream, with room
    for a launch of any plan over any of ``banks`` ((n_tasks, w) pairs)
    at up to ``rows`` test rows: the bank's segments (a function of w
    alone) and 64-row tiles are the most any split and row tile ask
    for. The tickets are zeroed on the current stream."""
    need_p = need_t = 0
    for n_tasks, w in banks:
        segments = -(-max(1, -(-w // SV_TILE)) // segment_tiles(w))
        need_p = max(need_p, 2 * n_tasks * segments * rows)
        need_t = max(need_t, n_tasks * -(-rows // 64))
    return (torch.empty(need_p, dtype=torch.float32, device=device),
            torch.zeros(need_t, dtype=torch.int32, device=device))


@contextlib.contextmanager
def installed(buffers: tuple, stream: int):
    """Make ``buffers`` (``own_scratch``) the scratch of ``stream`` inside
    the block, and restore the stream's own buffers after it. The key is
    the buffers' own device (with its index, as a launch's operands
    give it)."""
    key = (buffers[0].device, stream)
    with _scratch_lock:
        prev = _scratch.get(key)
        _scratch[key] = buffers
    try:
        yield
    finally:
        with _scratch_lock:
            if prev is None:
                _scratch.pop(key, None)
            else:
                _scratch[key] = prev


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def launch_decision(lib, z, x, coef, out, *, gamma: float,
                    plan: DecisionPlan, partial=None, ticket=None,
                    stream: int | None = None) -> int:
    nt, d = z.shape
    return lib.svm_decision(z.data_ptr(), x.data_ptr(), coef.data_ptr(),
                            out.data_ptr(), nt, x.shape[0], d, float(gamma),
                            int(z.dtype == torch.bfloat16), plan.rows,
                            plan.chunk, plan.splits, plan.seg,
                            plan.smem_bytes, _ptr(partial), _ptr(ticket),
                            current_stream() if stream is None else stream)


def launch_multitask(lib, z, sv, coef, out, *, gamma: float, mode: str,
                     plan: DecisionPlan, partial=None, ticket=None,
                     stream: int | None = None) -> int:
    """The kernel over a (T, w, d) bank at its own dtype (``BANK_DTYPES``:
    float32, float16 or bfloat16 against float32 rows; bfloat16 against
    bfloat16 rows)."""
    nt, d = z.shape
    n_tasks, w, _ = sv.shape
    return lib.svm_multitask_decision(
        z.data_ptr(), sv.data_ptr(), coef.data_ptr(), out.data_ptr(), nt,
        n_tasks, w, d, float(gamma), int(mode == "rbf"),
        int(z.dtype == torch.bfloat16), BANK_DTYPES[sv.dtype], plan.rows,
        plan.chunk, plan.splits, plan.seg, plan.smem_bytes, _ptr(partial),
        _ptr(ticket), current_stream() if stream is None else stream)
