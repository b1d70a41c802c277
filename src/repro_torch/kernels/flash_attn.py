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
from its own count. ``ops.flash_attention`` is the checked entry point;
the functions here assume checked inputs.
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


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool,
                          out_dtype: torch.dtype) -> torch.Tensor:
    """Softmax attention of q (B, Sq, H, D) over k, v (B, Sk, Hkv, D),
    kv heads repeated to H; (B, Sq, H, D) in ``out_dtype``. The whole
    score matrix in float32, masked with -inf under ``causal`` (the
    reference's oracle, ``repro/kernels/ref.py::flash_attention``)."""
    h, d = q.shape[2], q.shape[3]
    hkv = k.shape[2]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    qf, kf, vf = (t.to(torch.float32).transpose(1, 2) for t in (q, k, v))
    s = (qf @ kf.transpose(-1, -2)) * d ** -0.5            # (B, H, Sq, Sk)
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        keep = (torch.arange(sk, device=q.device)[None, :]
                <= torch.arange(sq, device=q.device)[:, None])
        s = torch.where(keep, s, -torch.inf)
    out = torch.softmax(s, dim=-1) @ vf
    return out.transpose(1, 2).to(out_dtype)


def launch(lib, q, k, v, out, *, causal: bool, plan: FlashPlan) -> int:
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    return lib.svm_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, sk,
        h, hkv, d, sk, float(d ** -0.5 * LOG2E), int(causal),
        int(q.dtype == torch.bfloat16), int(out.dtype != q.dtype),
        plan.rows, plan.stages, plan.d_tiles, plan.smem_bytes,
        current_stream())
