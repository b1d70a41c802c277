"""SSD intra-chunk term: plain PyTorch version and the CUDA launcher.

The CUDA kernel (``csrc/ssd_diag.cu``) replaces ``ssd_diag_pallas``
(``repro/kernels/ssd_diag.py``): per (chunk, head) the masked quadratic
form ``Y = ((C B^T) * L * dt_k) x`` of the Mamba-2 SSD scan, with the
decay ``L[q, k] = exp(cs_q - cs_k)`` for k <= q and 0 above the
diagonal, all in float32. A block computes its score rows once for a
group of heads, on the tensor cores (3xTF32); ``ssd_plan`` is the launch
plan, and the kernel refuses a plan whose shared memory differs from its
own count. Its gradient is ``csrc/ssd_diag_bwd.cu`` (launch plan
``bwd_plan``; no Pallas counterpart: the reference differentiates
``ssd_chunked`` by XLA's autodiff): 3xTF32 on the tensor cores, the
scores once a head group and dC / dB once a chunk, beside its plain
version ``ssd_diag_bwd_plain``. ``ops.ssd_diag`` is the checked entry
point; the functions here assume checked inputs.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels.tile_f32 import H100_SMS, current_stream

ROWS = 64             # query rows of a tile; keys of a chunk (csrc SD_ROWS)
WINDOW = 256          # keys of a score window (csrc SD_WIN)
STAGE_WORDS = 8704    # 32-bit words of a ring stage (csrc SD_STAGE)
STAGES = (2, 3)
SMEM_LIMIT = 232448   # shared memory a block may opt in to on the H100


class SsdPlan(NamedTuple):
    group: int        # heads a block walks (even; the last group may be short)
    stages: int       # ring stages (STAGES)
    q_tiles: int      # 64-row query tiles of a chunk
    groups: int       # head groups: ceil(H / group)
    smem_bytes: int   # dynamic shared memory a block takes
    grid: tuple       # (q_tiles x groups x BC,), heaviest tiles first


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


def ssd_diag_bwd_plain(cmat: torch.Tensor, bmat: torch.Tensor,
                       x: torch.Tensor, dt: torch.Tensor, cs: torch.Tensor,
                       dy: torch.Tensor):
    """The gradient (dC, dB, dx, ddt, dcs) of ``ssd_diag_plain`` at its
    operands given dY (BC, H, Q, P): the explicit formulas of the kernel
    (``csrc/ssd_diag_bwd.cu``), with S = C B^T, L the decay (0 above the
    diagonal), W = S L dt_k: dW = dY x^T masked, dx = W^T dY, G = dW W,
    dcs = rowsum(G) - colsum(G), ddt_k = sum_q dW S L, dS_h = dW L dt_k,
    dC = sum_h dS_h B, dB = sum_h dS_h^T C; in the operands' type."""
    scores = torch.einsum("cqn,ckn->cqk", cmat, bmat)
    seg = cs[:, :, :, None] - cs[:, :, None, :]
    q = cmat.shape[1]
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=cmat.device))
    l_mat = torch.where(causal, torch.exp(seg), 0.0)
    w = scores[:, None] * l_mat * dt[:, :, None, :]
    dw = torch.where(causal, torch.einsum("chqp,chkp->chqk", dy, x), 0.0)
    dx = torch.einsum("chqk,chqp->chkp", w, dy)
    g = dw * w
    dcs = g.sum(-1) - g.sum(-2)
    ddt = (dw * scores[:, None] * l_mat).sum(-2)
    ds = (dw * l_mat * dt[:, :, None, :]).sum(1)           # (BC, Q, Q)
    dc = torch.einsum("cqk,ckn->cqn", ds, bmat)
    db = torch.einsum("cqk,cqn->ckn", ds, cmat)
    return dc, db, dx, ddt, dcs


def smem_bytes(n: int, stages: int) -> int:
    """Shared memory of a launch (csrc sd_smem_bytes): 1024 bytes to align
    the tiles, 64 score rows of WINDOW + 8 floats, the C tile (rows of N
    floats in 128-byte swizzled boxes of 64 rows), the ring (a stage: a B
    chunk of up to 4 boxes, or two heads' x rows of 2 boxes each with
    their cs and dt), and the mbarriers."""
    boxes = -(-n // 32)
    return (1024 + 4 * (ROWS * (WINDOW + 8) + boxes * ROWS * 32)
            + 4 * stages * STAGE_WORDS + 8 * (2 * stages + 1))


def ssd_plan(bc: int, h: int, q: int, n: int, p: int, sms: int = H100_SMS,
             group: int | None = None) -> SsdPlan:
    """Launch plan for BC chunks of Q rows, H heads, state N, P columns
    of x: the even
    head group that minimises the cost model ``plan_cost`` (ties: one
    that divides H, then the smaller); a ring of 3 stages where it fits,
    else 2. A head's bits do not depend on the plan."""
    q_tiles = math.ceil(q / ROWS)
    if group is None:
        evens = range(2, 2 * math.ceil(h / 2) + 1, 2)
        group = min(evens, key=lambda g: (plan_cost(bc, h, q, n, p, g, sms),
                                          h % g != 0, g))
    if group < 1:
        raise ValueError("ssd_plan: group must be >= 1")
    stages = max([s for s in STAGES if smem_bytes(n, s) <= SMEM_LIMIT]
                 or [min(STAGES)])
    groups = math.ceil(h / group)
    return SsdPlan(group, stages, q_tiles, groups, smem_bytes(n, stages),
                   (q_tiles * groups * bc,))


def plan_cost(bc: int, h: int, q: int, n: int, p: int, group: int,
              sms: int = H100_SMS) -> float:
    """The time a head group gives, in ring stages of one block (each
    about one warp's 16 x 64 x 64 chunk of MMAs): a block of query tile t
    walks t + 1 key chunks, each a stage for every 128 words of N (the
    scores) and one for every pair of heads and 64 columns of P; the
    grid then takes the larger of its work over the SMs and its longest
    block."""
    tiles = math.ceil(q / ROWS)
    per_chunk = math.ceil(n / 128) + math.ceil(group / 2) * math.ceil(p / 64)
    total = bc * math.ceil(h / group) * per_chunk * tiles * (tiles + 1) / 2
    return max(total / sms, tiles * per_chunk)


def block_of(plan: SsdPlan, bc: int, i: int) -> tuple[int, int, int]:
    """(query tile, head group, chunk) of block i, as the kernel computes
    it: the last (heaviest) tile of every chunk and group first."""
    cells = plan.groups * bc
    return (plan.q_tiles - 1 - i // cells, i % cells % plan.groups,
            i % cells // plan.groups)


def launch(lib, cmat, bmat, x, dt, cs, out, *, plan: SsdPlan) -> int:
    bc, q, n = cmat.shape
    h, p = x.shape[1], x.shape[3]
    return lib.svm_ssd_diag(
        cmat.data_ptr(), bmat.data_ptr(), x.data_ptr(), dt.data_ptr(),
        cs.data_ptr(), out.data_ptr(), bc, h, q, n, p, plan.group,
        plan.stages, plan.smem_bytes,
        current_stream())


# ------------------------------------------------------------- backward
BWD_TILE = 64         # rows / keys of a tile (csrc SB_T)
BWD_RING = 2          # ring stages of the walk (csrc SB_RING)


class SsdBwdPlan(NamedTuple):
    group: int        # heads a block walks (the last group may be short)
    groups: int       # ceil(H / group): dS partials, summed in group order
    tiles: int        # 64-row tiles of a chunk
    pairs: int        # tile pairs (i >= j) of a chunk
    smem_bytes: int   # dynamic shared memory of a walk block
    smem_dcdb: int    # of a dC / dB block
    grid: tuple       # (BC x groups,): the walks, full groups first
    grid_dcdb: tuple  # (BC x tiles x 2,): dC, dB of a tile, a block each


def bwd_p_width(p: int) -> int:
    """Columns of x and dY a ring stage holds: P rounded up to 64 or 128."""
    return 64 if p <= 64 else 128


def bwd_smem_bytes(q: int, p: int, group: int) -> int:
    """Shared memory of a walk block (csrc sb_smem): the ring (a stage:
    x and dY tiles of 64 rows with a stride of width + 4 floats, or C's
    and B's 64-column chunks, and cs / dt runs), the group's dX
    accumulators (64 x width floats a head), the row sums of G over the
    chunk, the column sums of G and ddt of a key tile (64 a head) and the
    reduction scratch (4 x 64 floats for each of the three sums)."""
    t, pw = BWD_TILE, bwd_p_width(p)
    slot = 2 * t * (pw + 4) + 3 * t
    return 4 * (BWD_RING * slot + group * t * pw + group * math.ceil(q / t) * t
                + 2 * group * t + 12 * t)


def bwd_dcdb_smem_bytes(n: int) -> int:
    """A dC / dB block (csrc sb_dcdb_smem): a dS tile (64 x 72 floats) and
    a B or C tile of N rounded up to 64 columns (stride + 4)."""
    t = BWD_TILE
    return 4 * (t * 72 + t * (math.ceil(n / t) * t + 4))


def bwd_cost(bc: int, h: int, q: int, n: int, p: int, group: int,
             sms: int = H100_SMS) -> float:
    """The time a head group gives, in 64 x 64 x 64 products of one block
    (one block an SM: a walk block takes most of its shared memory): every
    tile pair takes ceil(N / 64) for S and, a head, ceil(P / 64) each for
    dW and dX; the blocks run in waves over the SMs."""
    tiles = math.ceil(q / BWD_TILE)
    pairs = tiles * (tiles + 1) // 2
    per_block = pairs * (math.ceil(n / 64)
                         + 2 * min(group, h) * math.ceil(p / 64))
    return math.ceil(bc * math.ceil(h / group) / sms) * per_block


def bwd_plan(bc: int, h: int, q: int, n: int, p: int, sms: int = H100_SMS,
             group: int | None = None) -> SsdBwdPlan:
    """Launch plan of the backward (csrc/ssd_diag_bwd.cu): the head group
    of least ``bwd_cost`` among those whose walk fits in shared memory
    (ties: fewer groups, whose dS partials are fewer). dX, ddt and dcs of
    a head do not depend on the plan; dC and dB sum the groups' partials,
    so their last bits follow the group."""
    fits = [g for g in range(1, h + 1)
            if bwd_smem_bytes(q, p, g) <= SMEM_LIMIT]
    if group is None:
        if not fits:
            raise ValueError(f"bwd_plan: Q {q}, P {p}: no head group fits "
                             "in shared memory")
        group = min(fits, key=lambda g: (bwd_cost(bc, h, q, n, p, g, sms),
                                         math.ceil(h / g), g))
    if not 1 <= group <= h or bwd_smem_bytes(q, p, group) > SMEM_LIMIT:
        raise ValueError(f"bwd_plan: group {group} of {h} heads does not "
                         f"fit in shared memory (Q {q}, P {p})")
    tiles = math.ceil(q / BWD_TILE)
    groups = math.ceil(h / group)
    return SsdBwdPlan(group, groups, tiles, tiles * (tiles + 1) // 2,
                      bwd_smem_bytes(q, p, group),
                      bwd_dcdb_smem_bytes(n), (bc * groups,),
                      (bc * tiles * 2,))


def bwd_block_of(bc: int, i: int) -> tuple[int, int]:
    """(chunk, head group) of walk block i of a plan's grid, as the kernel
    computes it: every chunk's full groups first, a short last group after
    them."""
    return i % bc, i // bc


def bwd_pairs(tiles: int) -> list[tuple[int, int]]:
    """The tile pairs (i, j), i >= j, in a walk's order (key tile j, then
    its query tiles): list index = the kernel's pair index (csrc
    sb_pair)."""
    return [(i, j) for j in range(tiles) for i in range(j, tiles)]


def launch_bwd(lib, cmat, bmat, x, dt, cs, dy, part, dc, db, dx, ddt, dcs,
               *, plan: SsdBwdPlan) -> int:
    bc, q, n = cmat.shape
    h, p = x.shape[1], x.shape[3]
    return lib.svm_ssd_diag_bwd(
        cmat.data_ptr(), bmat.data_ptr(), x.data_ptr(), dt.data_ptr(),
        cs.data_ptr(), dy.data_ptr(), part.data_ptr(), dc.data_ptr(),
        db.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dcs.data_ptr(), bc, h,
        q, n, p, plan.group, plan.smem_bytes, current_stream())
