"""Flash attention: plain PyTorch version and the CUDA launcher.

The CUDA kernel (``csrc/flash_attn.cu``) replaces
``flash_attention_pallas`` (``repro/kernels/flash_attn.py``), reached in
the reference through ``repro.kernels.ops.flash_attention``: softmax
attention over (B, S, H, D) tensors with grouped-query heads, computed
with an online softmax so the (S, S) scores never reach device memory.
Everything inside is float32; the output is rounded once to its type.
Both products run on the tensor cores (3xTF32 for float32 operands,
bf16 with P split in two for bfloat16 ones); ``flash_plan`` is the
launch plan, and the kernel refuses a plan whose shared memory differs
from its own count. The kernel can also write each row's log-sum-exp,
which the backward kernel (``csrc/flash_attn_bwd.cu``, launch plan
``bwd_plan``; no Pallas counterpart: the reference differentiates its
attention by XLA's autodiff) reads to recompute P. Its products run on
the tensor cores too: bf16 with P and dS split in two where the
operands and o are bfloat16 (``bwd_route``), else 3xTF32.
``flash_attention_bwd_plain`` is its plain version.
``ops.flash_attention`` is the checked entry point; the functions here
assume checked inputs.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels.tile_f32 import H100_SMS, current_stream

KEYS = 64             # keys of a key tile (csrc FA_KEYS)
ROWS = (64, 128)      # query rows of a block: one MMA warp per 16
STAGES = (2, 3)       # K / V stages in the ring: 3 where they fit
SMEM_LIMIT = 232448   # shared memory a block may opt in to on the H100
LOG2E = 1.4426950408889634


class FlashPlan(NamedTuple):
    route: str        # "tf32x3" (float32 operands) or "bf16"
    rows: int         # query rows a block owns (ROWS); rows // 16 + 1 warps
    stages: int       # K / V stages in the ring (STAGES)
    d_tiles: int      # 8-column tiles the staged rows hold: 4, 8 or 16
    smem_bytes: int   # dynamic shared memory a block takes
    grid: tuple       # (B x H, query tiles), heaviest tile first


def d_tiles(d: int) -> int:
    """8-element tiles a staged row holds: d rounded up to 32, 64 or 128
    (the kernel's instantiations; the words past d are zero)."""
    return 4 if d <= 32 else 8 if d <= 64 else 16


def smem_bytes(rows: int, stages: int, tiles: int, elem: int) -> int:
    """Shared memory of a launch (csrc fa_smem_bytes): 1024 bytes to align
    the tiles, the query tile and the ring of K and V tiles, each row
    ``tiles x 8`` elements in 128-byte swizzled boxes (at least one), and
    the mbarriers."""
    boxes = max(1, tiles * elem // 16)
    return (1024 + 128 * boxes * (rows + 2 * stages * KEYS)
            + 8 * (2 * stages + 1))


def flash_plan(b: int, sq: int, h: int, d: int,
               dtype: torch.dtype = torch.float32, sms: int = H100_SMS,
               rows: int | None = None) -> FlashPlan:
    """Launch plan for q (b, sq, h, d): 128-row query tiles
    where they give at least one block an SM, else 64; a ring of 3 K / V
    stages where it fits the shared memory, else 2. A row's bits do not
    depend on the plan."""
    elem = 2 if dtype == torch.bfloat16 else 4
    tiles = d_tiles(d)
    if rows is None:
        rows = 128 if b * h * math.ceil(sq / 128) >= sms else 64
    if rows not in ROWS:
        raise ValueError(f"flash_plan: rows must be one of {ROWS}")
    stages = max(s for s in STAGES
                 if smem_bytes(rows, s, tiles, elem) <= SMEM_LIMIT)
    return FlashPlan("bf16" if elem == 2 else "tf32x3", rows, stages, tiles,
                     smem_bytes(rows, stages, tiles, elem),
                     (b * h, math.ceil(sq / rows)))


def tile_order(q_tiles: int) -> list[int]:
    """The query tile that grid row y runs, y = 0, 1, ...: the last (the
    longest causal walk) first, as the kernel computes it."""
    return [q_tiles - 1 - y for y in range(q_tiles)]


def key_tiles(q0: int, rows: int, sq: int, sk: int, causal: bool) -> int:
    """Key tiles the block of query rows [q0, q0 + rows) walks: every
    tile of the sk keys, or under the causal mask those up to the tile's
    last row (the rest are fully masked)."""
    n = math.ceil(sk / KEYS)
    if causal:
        n = min(n, (min(q0 + rows, sq) - 1) // KEYS + 1)
    return n


def _wide(dtype: torch.dtype) -> torch.dtype:
    """The plain versions' arithmetic type: float32, or float64 for
    float64 operands (the tests' exact evaluations)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _heads_first(q, k, v):
    """q, k, v as (B, H, S, D) in the arithmetic type, kv heads repeated
    to H (query head h reads kv head h // (H / Hkv))."""
    h, hkv = q.shape[2], k.shape[2]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    wide = _wide(q.dtype)
    return (t.to(wide).transpose(1, 2) for t in (q, k, v))


def _scores(qf, kf, causal: bool):
    """Scaled scores (B, H, Sq, Sk), -inf where the causal mask (key >
    row, by global position) hides a key."""
    s = (qf @ kf.transpose(-1, -2)) * qf.shape[-1] ** -0.5
    if not causal:
        return s
    sq, sk = qf.shape[2], kf.shape[2]
    keep = (torch.arange(sk, device=qf.device)[None, :]
            <= torch.arange(sq, device=qf.device)[:, None])
    return torch.where(keep, s, -torch.inf)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool,
                          out_dtype: torch.dtype) -> torch.Tensor:
    """Softmax attention of q (B, Sq, H, D) over k, v (B, Sk, Hkv, D),
    kv heads repeated to H; (B, Sq, H, D) in ``out_dtype``. The whole
    score matrix in float32 (float64 for float64 operands), masked with
    -inf under ``causal`` (the reference's oracle,
    ``repro/kernels/ref.py::flash_attention``)."""
    qf, kf, vf = _heads_first(q, k, v)
    s = _scores(qf, kf, causal)
    out = torch.softmax(s, dim=-1) @ vf
    return out.transpose(1, 2).to(out_dtype)


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor, *,
                        causal: bool) -> torch.Tensor:
    """Each row's log-sum-exp of its scaled, masked scores, (B, H, Sq) in
    natural log, as the forward kernel writes it (+inf for a row that
    sees no key)."""
    qf, kf, _ = _heads_first(q, k, k)
    s = _scores(qf, kf, causal)
    lse = torch.logsumexp(s, dim=-1)
    return torch.where(lse == -torch.inf, torch.inf, lse)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor, *,
                              causal: bool):
    """The gradient (dq, dk, dv) of ``flash_attention_plain`` at q, k, v
    given its output o, each row's log-sum-exp ``lse`` (B, H, Sq) and the
    output's gradient do, in q's dtype; the explicit formulas of the
    kernel (``csrc/flash_attn_bwd.cu``) in float32 (float64 for float64
    operands): P = exp(scale Q K^T - lse) masked, D = rowsum(dO o O),
    dS = P o (dO V^T - D), dQ = scale dS K, dK = scale dS^T Q,
    dV = P^T dO, dK and dV summed over each kv head's H / Hkv query
    heads."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qf, kf, vf = _heads_first(q, k, v)
    wide = qf.dtype
    of, dof = (t.to(wide).transpose(1, 2) for t in (o, do))
    # masked scores are -inf, and so is their exponent (lse is finite, or
    # +inf for a row with no key): P is 0 there
    p = torch.exp(_scores(qf, kf, causal) - lse.to(wide)[..., None])
    delta = (dof * of).sum(-1, keepdim=True)
    ds = p * (dof @ vf.transpose(-1, -2) - delta)
    scale = d ** -0.5
    dq = scale * (ds @ kf)
    dk = (scale * (ds.transpose(-1, -2) @ qf)).reshape(
        b, hkv, h // hkv, sk, d).sum(2)
    dv = (p.transpose(-1, -2) @ dof).reshape(b, hkv, h // hkv, sk, d).sum(2)
    return tuple(t.transpose(1, 2).to(q.dtype) for t in (dq, dk, dv))


def launch(lib, q, k, v, out, *, causal: bool, plan: FlashPlan,
           lse: torch.Tensor | None = None) -> int:
    """The forward kernel; ``lse`` (B, H, Sq) float32, when given,
    receives each row's log-sum-exp for the backward."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    return lib.svm_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, sq, sk,
        h, hkv, d, sk, float(d ** -0.5 * LOG2E), int(causal),
        int(q.dtype == torch.bfloat16), int(out.dtype != q.dtype),
        plan.rows, plan.stages, plan.d_tiles, plan.smem_bytes,
        current_stream())


# ------------------------------------------------------------- backward
BWD_ROWS = 64         # query rows of a dQ block: 4 warps (csrc FB_ROWS)
BWD_KT = 64           # keys of a dQ block's key tile (csrc FB_KT)
BWD_RING = 2          # ring stages of each launch (csrc FB_RING)


class BwdPlan(NamedTuple):
    route: str        # "bf16" (q and o bfloat16) or "tf32x3"
    width: int        # staged row width: d rounded up to 32, 64 or 128
    q_tile: int       # query rows of a dK / dV ring stage
    kv_keys: int      # keys of a dK / dV block, 16 a warp
    smem_kv: int      # shared memory of the dK / dV launch
    smem_q: int       # of the dQ launch
    grid_kv: tuple    # (B x Hkv, key tiles), key tile 0 (heaviest) first
    grid_q: tuple     # (B x H, query tiles), the last (heaviest) first


def bwd_width(d: int) -> int:
    return 32 if d <= 32 else 64 if d <= 64 else 128


def bwd_q_tile(width: int) -> int:
    """Query rows of a dK / dV tile: 32 at width 128, so a warp's dK and
    dV rows stay in registers beside S^T and dP^T."""
    return 32 if width == 128 else 64


def bwd_kv_keys(elem: int) -> int:
    """Keys of a dK / dV block (csrc fb_kv_warps): 8 warps of 16 on the
    TF32 route (half the Q and dO tiles copied a key), 4 on the bf16 route
    (eight were slower there: two 4-warp blocks share an SM)."""
    return 128 if elem == 4 else 64


def bwd_row_words(width: int, elem: int) -> int:
    """32-bit words of a staged row: ``width`` elements of ``elem`` bytes
    and 4 words of padding (a stride of 4 mod 8 words: ldmatrix's eight
    rows hit 32 banks)."""
    return width * elem // 4 + 4


def bwd_smem_kv(width: int, elem: int) -> int:
    """The dK / dV launch (csrc fb_kv_smem): K and V tiles of
    ``bwd_kv_keys`` rows, then a ring of Q and dO tiles with their lse and
    D rows."""
    ls, qt = bwd_row_words(width, elem), bwd_q_tile(width)
    return 4 * (2 * bwd_kv_keys(elem) * ls
                + BWD_RING * (2 * qt * ls + 2 * qt))


def bwd_smem_q(width: int, elem: int) -> int:
    """The dQ launch (csrc fb_q_smem): Q and dO tiles of BWD_ROWS rows
    with their lse and D, then a ring of K and V tiles of BWD_KT."""
    ls = bwd_row_words(width, elem)
    return 4 * (2 * BWD_ROWS * (ls + 1) + BWD_RING * 2 * BWD_KT * ls)


def bwd_route(dtype: torch.dtype, o_dtype: torch.dtype | None = None) -> str:
    """bf16 products (P and dS split in two) when the operands and o are
    bfloat16; 3xTF32 otherwise (bf16 operands beside a float32 o are
    widened as they are staged)."""
    o_dtype = dtype if o_dtype is None else o_dtype
    return ("bf16" if dtype == torch.bfloat16 and o_dtype == torch.bfloat16
            else "tf32x3")


def bwd_plan(b: int, sq: int, sk: int, h: int, hkv: int, d: int,
             dtype: torch.dtype = torch.float32,
             o_dtype: torch.dtype | None = None) -> BwdPlan:
    """The backward's launches (csrc/flash_attn_bwd.cu) for operands of
    ``dtype`` and an output o of ``o_dtype``."""
    route = bwd_route(dtype, o_dtype)
    elem = 2 if route == "bf16" else 4
    w = bwd_width(d)
    keys = bwd_kv_keys(elem)
    return BwdPlan(route, w, bwd_q_tile(w), keys, bwd_smem_kv(w, elem),
                   bwd_smem_q(w, elem), (b * hkv, math.ceil(sk / keys)),
                   (b * h, math.ceil(sq / BWD_ROWS)))


def bwd_kv_walk(plan: BwdPlan, sq: int, key_tile: int, causal: bool,
                group: int) -> list[tuple[int, int]]:
    """(query head of the group, first query row) of every tile the dK /
    dV block of ``key_tile`` walks, in its order, as the kernel computes
    it: under the causal mask from the query tile holding the block's
    first key on."""
    first = key_tile * plan.kv_keys // plan.q_tile if causal else 0
    tiles = range(first, math.ceil(sq / plan.q_tile))
    return [(hh, i * plan.q_tile) for hh in range(group) for i in tiles]


def bwd_q_walk(sq: int, sk: int, block_y: int, causal: bool
               ) -> tuple[int, int]:
    """(first query row, key tiles walked) of the dQ block at grid row
    ``block_y``, as the kernel computes them: the last query tile first,
    the keys up to its diagonal (or its last row) under the causal
    mask."""
    q0 = (math.ceil(sq / BWD_ROWS) - 1 - block_y) * BWD_ROWS
    end = min(sk, sq, q0 + BWD_ROWS) if causal else sk
    return q0, math.ceil(end / BWD_KT)


def launch_bwd(lib, q, k, v, o, lse, do, dq, dk, dv, delta, *, causal: bool,
               plan: BwdPlan) -> int:
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    return lib.svm_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), b, sq, sk, h, hkv, d,
        float(d ** -0.5), float(d ** -0.5 * LOG2E), int(causal),
        int(q.dtype == torch.bfloat16), int(o.dtype == torch.bfloat16),
        plan.width, plan.q_tile, plan.smem_kv, plan.smem_q,
        current_stream())
