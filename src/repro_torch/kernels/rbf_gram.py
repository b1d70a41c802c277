"""RBF / linear Gram: plain PyTorch versions and the CUDA launchers.

The CUDA kernels (``csrc/rbf_gram.cu``) replace ``rbf_gram_pallas``
(``repro/kernels/rbf_gram.py``); its note says what bounds them on the
H100 and how the design answers. Both modes take the operands already
at the compute precision (float32, or bfloat16 for the mixed-precision
path) and the squared row norms as float32 vectors computed from those
same rounded values; the epilogue is float32.

The block route has two entries over one tensor-core mainloop: the
Gram block, and the Gram matvec K(X, X) v, which never writes K
(``gram_matvec_plain`` is the composition the engines ran before it:
row blocks of the Gram times v); the float32 matvec with d <= 104 runs
on a wgmma route of its own (``route_of``). ``gram_plan`` is the launch
plan. The
row kernel also has a cached entry that folds in the SMO solver's LRU
row cache (``kernel_engine.RowCache``); ``lru_row_plain`` is that
lookup in plain PyTorch, the one the chunked engine runs.

The row entries and the matvec also take a row range ``(row0, count)``
over the full X: one rank of the data-parallel SMO computes only its
own block of rows (``kernel_engine.ShardedKernelEngine``). Output rows
past X's last are 0. A row's bits do not depend on the range, so the
plain versions compute a range as the slice of the full call it is.
A range whose first row is a multiple of ROW_CHUNK has its row chunks'
copies 16-byte aligned (one TMA bulk copy a chunk); others take
ordinary loads.

``ops.rbf_gram`` / ``ops.gram_matvec`` / ``ops.gram_row`` /
``ops.gram_row_cached`` are the checked entry points; the functions
here assume checked inputs.
"""
from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from repro_torch.analysis.compile_guard import memoised
from repro_torch.kernels.tile_f32 import H100_SMS, current_stream

MODES = ("rbf", "linear")
ENTRIES = ("block", "matvec")

# the block route's tiles (csrc/rbf_gram.cu GT_*)
COLS = 128          # columns of a column tile; fixes a matvec row's order
KSTEP = 8           # 32-bit words of depth an MMA step takes
MAX_CHUNK = 128     # widest depth, in words, staged whole
CHUNK = 64          # words a stage holds past it
ROWS = (32, 64, 128)  # row tiles: two warps per 32 rows, and a producer
ROW_CHUNK = 32      # rows a warp of the row entries owns (csrc CHUNK_ROWS)
STAGES = (2, 3)       # column-tile stages in the ring: 3 where they fit
SMEM_LIMIT = 232448   # shared memory a block may opt in to on the H100
# the float32 matvec's wgmma route (csrc WG_*): d <= 104, 128-row tiles,
# two stages of 64 columns (high and low parts, a landing, b2 and v)
WG_MAX_WORDS = 104
WG_SMEM = 2 * (2 * 2 * 13 * 64 * 16 + 64 * 108 * 4 + 2 * 64 * 4) + 8 * 3 * 2


def _epilogue(dot, a2, b2, gamma: float, mode: str):
    if mode == "linear":
        return dot
    d2 = a2 + b2 - 2.0 * dot
    return torch.exp(-gamma * torch.clamp_min(d2, 0.0))


def rbf_gram_plain(a: torch.Tensor, b: torch.Tensor, a2: torch.Tensor,
                   b2: torch.Tensor, *, gamma: float,
                   mode: str = "rbf") -> torch.Tensor:
    """(n, m) float32 Gram block of a (n, d) and b (m, d)."""
    dot = a.to(torch.float32) @ b.to(torch.float32).T
    return _epilogue(dot, a2[:, None], b2[None, :], gamma, mode)


def _pad_rows(t: torch.Tensor, count: int) -> torch.Tensor:
    """``t`` (.., k) zero-padded to (.., count)."""
    return torch.nn.functional.pad(t, (0, count - t.shape[-1]))


def gram_matvec_plain(x: torch.Tensor, x2: torch.Tensor, v: torch.Tensor,
                      *, gamma: float, mode: str = "rbf",
                      chunk: int = 2048, row0: int = 0,
                      count: int | None = None) -> torch.Tensor:
    """(n,) float32 K(X, X) v for x (n, d): ``chunk``-row blocks of
    ``rbf_gram_plain`` times v, concatenated (the pallas engine's matvec
    before the fused kernel, bit for bit). With the task axis — x
    (T, n, d), x2 and v (T, n) — the (T, n) products, each task's
    computed as a lone call computes it. A row range gives rows
    ``[row0, row0 + count)`` (0 past n) from the same blocks the whole
    call computes, so it is that call's slice bit for bit."""
    if x.ndim == 3:
        return torch.stack([gram_matvec_plain(xt, x2t, vt, gamma=gamma,
                                              mode=mode, chunk=chunk)
                            for xt, x2t, vt in zip(x, x2, v)])
    n = x.shape[0]
    count = n - row0 if count is None else count
    stop = min(row0 + count, n)
    if stop <= row0:
        return torch.zeros((count,), dtype=torch.float32, device=x.device)
    step = min(chunk, n)
    first = row0 // step * step
    rows = torch.cat([rbf_gram_plain(x[s:s + step], x, x2[s:s + step], x2,
                                     gamma=gamma, mode=mode) @ v
                      for s in range(first, stop, step)])
    return _pad_rows(rows[row0 - first:stop - first], count)


class GramPlan(NamedTuple):
    rows: int        # rows a block owns (ROWS); rows // 16 + 1 warps
    chunk: int       # 32-bit words of depth a stage holds
    chunks: int      # depth chunks (1: the row tile stays staged)
    stages: int      # column stages in the ring (STAGES)
    groups: int      # block entry: column groups of a row tile; matvec: 1
    smem_bytes: int  # dynamic shared memory a block takes
    grid: tuple      # (row tiles, groups or tasks)
    route: str = "mma"   # "wgmma": the float32 matvec's route


OUT_LD = 72         # row stride (words) of the block entry's output staging


def smem_bytes(rows: int, chunk: int, chunks: int, stages: int,
               entry: str = "block") -> int:
    """Shared memory of a block-route launch (csrc gt_smem_bytes): the
    row tile (resident, or in the ring with the depth chunks) and the
    ring of column tiles, rows ``chunk + 4`` words apart; each column
    stage's norms and v; the matvec's row sums of two warps, or the
    block entry's output staging (16 rows x 64 columns a warp); the
    mbarriers."""
    a_bufs = 1 if chunks == 1 else stages
    extra = 2 * max(ROWS) if entry == "matvec" else rows * OUT_LD
    return (4 * ((a_bufs * rows + stages * COLS) * (chunk + 4)
                 + stages * 2 * COLS + extra) + 16 * (stages + 1))


def depth(d: int, dtype: torch.dtype) -> tuple[int, int]:
    """(chunk, chunks): the 32-bit words of depth a stage holds (a
    multiple of the MMA step) and the chunks a row's d elements take:
    staged whole up to MAX_CHUNK words, in CHUNK-word chunks past that."""
    words = -(-d // (2 if dtype == torch.bfloat16 else 1))
    width = max(KSTEP, -(-words // KSTEP) * KSTEP)
    return ((width, 1) if width <= MAX_CHUNK
            else (CHUNK, -(-width // CHUNK)))


def copyable(x: torch.Tensor) -> bool:
    """True where the block route's TMA copies can take ``x``'s rows: a
    unit inner stride, rows (and tasks) at 16-byte multiples."""
    return (x.stride(-1) == 1 and x.stride(-2) >= x.shape[-1]
            and (x.stride(-2) * x.element_size()) % 16 == 0
            and x.data_ptr() % 16 == 0
            and (x.ndim == 2 or x.stride(0) == x.shape[1] * x.stride(1)))


def staged(x: torch.Tensor) -> torch.Tensor:
    """``x`` (.., n, d) laid out for the block route on the card: rows
    zero-padded to the stride a staged tile takes in shared memory (chunk
    + 4 words), so that a tile of rows is one TMA bulk copy (past
    MAX_CHUNK words, to the next 16 bytes: one copy a row and chunk).
    ``x`` itself where it already is (and on the CPU), else a view of a
    padded copy: the same values, a wider stride."""
    chunk, chunks = depth(x.shape[-1], x.dtype)
    per = 4 // x.element_size()                  # elements a 32-bit word
    ld = ((chunk + 4) * per if chunks == 1
          else -(-x.shape[-1] // (4 * per)) * 4 * per)
    if not x.is_cuda or (copyable(x) and x.stride(-2) == ld):
        return x
    return torch.nn.functional.pad(x, (0, ld - x.shape[-1]))[..., :x.shape[-1]]


def route_of(d: int, dtype: torch.dtype, entry: str) -> str:
    """The matvec of float32 rows of d <= WG_MAX_WORDS runs on wgmma,
    everything else on the mma.sync mainloop: a matvec's bits depend on
    the route, so it is chosen by (d, dtype) alone, never by n or T."""
    return ("wgmma" if entry == "matvec" and dtype == torch.float32
            and d <= WG_MAX_WORDS else "mma")


def route_rows(d: int, dtype: torch.dtype, entry: str) -> tuple:
    """The row tiles a plan may take for this shape."""
    return (128,) if route_of(d, dtype, entry) == "wgmma" else ROWS


@memoised
def gram_plan(n: int, m: int, d: int, dtype: torch.dtype = torch.float32,
              tasks: int = 1, entry: str = "block", sms: int = H100_SMS,
              rows: int | None = None) -> GramPlan:
    """Launch plan of the block route for an (n, d) x (m, d) Gram block
    (``entry="block"``) or a (T, n, d) matvec (``entry="matvec"``, m =
    n, T = ``tasks``). The depth in 32-bit words (float32 elements, or
    pairs of bfloat16) rounds up to the MMA step, is staged whole up to
    MAX_CHUNK words and in CHUNK-word chunks past that. Row tiles of 128
    (64 or 32 for short n, or ``rows``); a ring of 3 column stages where
    they fit the shared memory, else 2; the block entry splits each row
    tile's column tiles into groups so that one wave of blocks fills the
    card's ``sms`` SMs. The wgmma route (``route_of``) has one layout:
    128 rows, two stages of 64 columns. A matvec row's bits depend on
    none of this, only on the route, which (d, dtype) fix."""
    if entry not in ENTRIES:
        raise ValueError(f"unknown entry {entry!r}; expected one of "
                         f"{ENTRIES}")
    if entry == "matvec" and m != n:
        raise ValueError("gram_plan: a matvec is square (m == n)")
    chunk, chunks = depth(d, dtype)
    if route_of(d, dtype, entry) == "wgmma":
        if rows not in (None, 128):
            raise ValueError("gram_plan: the wgmma route takes 128 rows")
        return GramPlan(128, chunk, 1, 2, 1, WG_SMEM, (-(-n // 128), tasks),
                        "wgmma")

    def fits(r):
        return smem_bytes(r, chunk, chunks, min(STAGES), entry) <= SMEM_LIMIT

    if rows is None:   # 128 rows, fewer for short n or where they do not fit
        rows = max(r for r in ROWS
                   if (r == min(ROWS) or r < 2 * n) and fits(r))
    if rows not in ROWS or not fits(rows):
        raise ValueError(f"gram_plan: rows must be one of {ROWS} and fit "
                         "the shared memory")
    stages = max(s for s in STAGES
                 if smem_bytes(rows, chunk, chunks, s, entry) <= SMEM_LIMIT)
    smem = smem_bytes(rows, chunk, chunks, stages, entry)
    row_tiles = -(-n // rows)
    if entry == "matvec":
        return GramPlan(rows, chunk, chunks, stages, 1, smem,
                        (row_tiles, tasks))
    tiles = -(-m // COLS)
    groups = max(1, min(tiles, sms // max(row_tiles, 1), 65535))
    groups = -(-tiles // -(-tiles // groups))   # no empty group
    return GramPlan(rows, chunk, chunks, stages, groups, smem,
                    (row_tiles, groups))


def gram_row_plain(x: torch.Tensor, x2: torch.Tensor, i: torch.Tensor, *,
                   gamma: float, mode: str = "rbf", row0: int = 0,
                   count: int | None = None) -> torch.Tensor:
    """(n,) float32 row K(X, x_i); ``i`` is a 0-d int64 tensor. With the
    task axis — x (T, n, d), x2 (T, n), i (T,) — the (T, n) rows, each
    task's row computed as a lone call computes it. A row range gives
    entries ``[row0, row0 + count)`` (0 past n): the whole row's slice
    (a GEMV's bits on the CPU may depend on its row count)."""
    if x.ndim == 3:
        return torch.stack([gram_row_plain(xt, x2t, it, gamma=gamma,
                                           mode=mode, row0=row0, count=count)
                            for xt, x2t, it in zip(x, x2, i)])
    xf = x.to(torch.float32)
    z = xf.index_select(0, i.reshape(1))[0]
    row = _epilogue(xf @ z, x2, x2.index_select(0, i.reshape(1))[0],
                    gamma, mode)
    if row0 == 0 and count is None:
        return row
    count = x.shape[0] - row0 if count is None else count
    return _pad_rows(row[row0:row0 + count], count)


def lru_row_plain(keys, stamp, rows, clock, hits, misses, i, compute):
    """Row ``i`` through an LRU row cache, its state updated in place:
    the first slot whose key is ``i`` is a hit, else the first slot with
    the least stamp is the victim and receives ``compute(i)``; the slot
    takes key ``i`` and stamp ``clock + 1``, the clock ticks, and the hit
    or miss is counted. The row is computed either way and selected on
    the device, so the host never learns hit or miss. Returns a copy of
    the slot's row."""
    hit_vec = keys == i
    hit = hit_vec.any()
    slot = torch.where(hit, torch.argmax(hit_vec.to(torch.int32)),
                       torch.argmin(stamp))
    slot1 = slot.reshape(1)
    cur = rows.index_select(0, slot1)[0]
    rows.index_copy_(0, slot1, torch.where(hit, cur, compute(i))[None])
    tick = clock + 1
    keys.index_copy_(0, slot1, i.reshape(1).to(torch.int64))
    stamp.index_copy_(0, slot1, tick.reshape(1))
    clock.copy_(tick)
    hits.add_(hit.to(torch.int64))
    misses.add_((~hit).to(torch.int64))
    return rows.index_select(0, slot1)[0]


_tickets: dict = {}   # (device, stream) -> one int32, 0 between launches
_tickets_lock = threading.Lock()


def ticket(device: torch.device, stream: int) -> torch.Tensor:
    """The cached entry's ticket counter of a stream: zeroed once when it
    is made; each launch leaves it at 0 (launches on one stream run in
    order), so a row call allocates nothing besides its output."""
    key = (device, stream)
    with _tickets_lock:
        if key not in _tickets:
            _tickets[key] = torch.zeros(1, dtype=torch.int32, device=device)
        return _tickets[key]


def launch_block(lib, a, b, a2, b2, out, *, gamma: float, mode: str,
                 plan: GramPlan) -> int:
    """a (n, d), b (m, d), both ``staged``."""
    n, d = a.shape
    m = b.shape[0]
    return lib.svm_rbf_gram_block(
        a.data_ptr(), b.data_ptr(), a2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), n, m, d, a.stride(0), b.stride(0), float(gamma),
        int(mode == "rbf"), int(a.dtype == torch.bfloat16), plan.rows,
        plan.chunk, plan.chunks, plan.stages, plan.groups, plan.smem_bytes,
        current_stream())


def launch_matvec(lib, x, x2, v, out, *, gamma: float, mode: str,
                  plan: GramPlan, row0: int = 0) -> int:
    """x (n, d), or (T, n, d) with the task axis, ``staged``; ``out``
    (count,) takes rows [row0, row0 + count) (one task), the plan made
    for count rows."""
    n, d = x.shape[-2:]
    n_tasks = x.shape[0] if x.ndim == 3 else 1
    return lib.svm_rbf_gram_matvec(
        x.data_ptr(), x2.data_ptr(), v.data_ptr(), out.data_ptr(), n_tasks,
        n, row0, out.shape[-1], d, x.stride(-2), float(gamma),
        int(mode == "rbf"),
        int(x.dtype == torch.bfloat16), plan.rows, plan.chunk, plan.chunks,
        plan.stages, plan.smem_bytes, int(plan.route == "wgmma"),
        current_stream())


def launch_row(lib, x, x2, i, out, *, gamma: float, mode: str,
               row0: int = 0) -> int:
    """x (n, d), or (T, n, d) with the task axis; ``out`` (.., count)
    takes entries [row0, row0 + count) of each row."""
    n, d = x.shape[-2:]
    n_tasks = x.shape[0] if x.ndim == 3 else 1
    return lib.svm_rbf_gram_row(
        x.data_ptr(), x2.data_ptr(), i.data_ptr(), out.data_ptr(), n_tasks,
        n, row0, out.shape[-1], d, float(gamma), int(mode == "rbf"),
        int(x.dtype == torch.bfloat16), current_stream())


def launch_row_cached(lib, x, x2, i, out, keys, stamp, rows, clock, hits,
                      misses, *, gamma: float, mode: str,
                      row0: int = 0) -> int:
    """x (n, d); the LRU state as ``lru_row_plain`` takes it; ``out``
    and the cached rows hold entries [row0, row0 + count)."""
    n, d = x.shape
    stream = current_stream()
    tk = ticket(x.device, stream)
    return lib.svm_rbf_gram_row_cached(
        x.data_ptr(), x2.data_ptr(), i.data_ptr(), out.data_ptr(),
        keys.data_ptr(), stamp.data_ptr(), rows.data_ptr(), clock.data_ptr(),
        hits.data_ptr(), misses.data_ptr(), keys.shape[0], tk.data_ptr(), n,
        row0, out.shape[0], d, float(gamma), int(mode == "rbf"), int(x.dtype == torch.bfloat16),
        stream)
