"""Checked entry points of the port's kernels.

Each wrapper checks device, dtype, shape and contiguity, then:

* for tensors on the CPU, runs the kernel's plain PyTorch version (the
  only reason it does is that the tensors lie on the CPU);
* for tensors on the card, launches the hand-written CUDA kernel on
  the current stream — built at first use by ``kernels._build`` — and
  raises if the launch reports an error. There is no fallback.

Every wrapper adds one to its entry of ``launches`` where it launches
its kernel, and nowhere else, so a run can show that its main path went
through the kernels (``reset_launches`` zeroes the counts).

Unlike ``repro/kernels/ops.py`` nothing is padded to tile multiples:
the kernels mask their ragged edges themselves.

``flash_attention`` and ``ssd_diag`` are differentiable
(``FlashAttention``, ``SsdDiag``): their backward is the hand-written
``flash_attention_bwd`` / ``ssd_diag_bwd`` on the card (counted apart),
the plain backward formulas on CPU tensors. The reference's Pallas
kernels have no gradient; its train step differentiates the XLA
functions, whose gradient these compute.

The five tunable wrappers (``rbf_gram``, ``kkt_select``, ``decision``,
``multitask_decision``, ``rff_features``) take their launch plan's knob
(``rows=``, ``blocks=``, ``splits=``) as an optional argument, as
``repro/kernels/ops.py`` takes block sizes: an explicit knob wins, else
the tuned entry of the shape's bucket (``kernels.autotune``), else the
analytic plan. The plain versions take no plan, so on the CPU the knobs
change nothing.
"""
from __future__ import annotations

import threading

import torch
from torch.distributed.tensor import DTensor

from repro_torch.core.kernels import COMPUTE_DTYPES, sqnorms
from repro_torch.kernels import _build
from repro_torch.kernels import autotune
from repro_torch.kernels import dcd as _dcd
from repro_torch.kernels import decision as _decision
from repro_torch.kernels import feature_map as _fmap
from repro_torch.kernels import flash_attn as _flash
from repro_torch.kernels import kkt_select as _kkt
from repro_torch.kernels import rbf_gram as _gram
from repro_torch.kernels import ssd_diag as _ssd
from repro_torch.kernels.tile_f32 import current_stream

# one count per kernel entry point: rbf_gram.cu has a block, a matvec, a
# row and a cached-row one, the last three also over a row range (one
# rank's rows of the data-parallel SMO: "*_range", counted apart from
# whole calls); a launch with the task axis (a multiclass bucket, the
# tasks of a multiclass low-rank fit) counts once, whatever T; a
# multitask_decision launch over a quantized (fp16 / bf16) bank under
# float32 compute counts apart, under "*_bank"
KERNELS = ("rbf_gram", "rbf_gram_matvec", "rbf_gram_row",
           "rbf_gram_row_cached", "rbf_gram_matvec_range",
           "rbf_gram_row_range", "rbf_gram_row_cached_range", "kkt_select",
           "decision", "multitask_decision", "multitask_decision_fp16_bank",
           "multitask_decision_bf16_bank", "rff_features", "dcd_epoch",
           "flash_attention", "ssd_diag", "flash_attention_bwd",
           "ssd_diag_bwd")

# the largest rank dcd_epoch takes: w must fit the 232,448 bytes of
# shared memory a block may opt in to (csrc/dcd_epoch.cu, MAX_RANK)
DCD_MAX_RANK = (232448 - 64) // 4
launches = {k: 0 for k in KERNELS}
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        for k in KERNELS:
            launches[k] = 0


def _count(name: str) -> None:
    with _count_lock:
        launches[name] += 1


def take_launches(before: dict) -> dict:
    """The launches counted since ``before`` (a copy of ``launches``),
    taken back out of the counts: what a CUDA graph capture issued
    without running it. Each replay of the graph adds them
    (``add_launches``), so a replayed block counts as its eager run."""
    with _count_lock:
        delta = {k: launches[k] - before.get(k, 0) for k in KERNELS}
        for k in KERNELS:
            launches[k] -= delta[k]
    return {k: v for k, v in delta.items() if v}


def add_launches(counts: dict) -> None:
    with _count_lock:
        for k, v in counts.items():
            launches[k] += v


def block_scratch(device: torch.device, *, n: int, tasks: int) -> tuple:
    """Make, on the current stream, the per-stream scratch that an SMO
    block's kernels take at n samples and ``tasks`` tasks: ``kkt_select``'s
    keys and tickets and the cached row entry's ticket, zeroed as they are
    made. A CUDA graph captured on that stream afterwards finds them made
    (a capture refuses to make them: ``tile_f32.refuse_in_capture``) and
    keeps the returned tensors alive while it replays."""
    stream = current_stream()
    return (*_kkt.scratch(autotune.resolve_kkt(n, device), tasks, device,
                          stream),
            _gram.ticket(device, stream))


def _on_card(name: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; anything else, or a
    mix of devices, raises. A DTensor raises too: the kernels read raw
    device pointers, which a DTensor does not have (a sharded caller
    enters a kernel through a ``local_map`` region on local blocks)."""
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{name}: a DTensor operand; call the kernel on "
                        "local tensors (torch.distributed.tensor."
                        "experimental.local_map)")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: operands on several devices "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type == "cuda"


def _check_contiguous(name: str, **tensors: torch.Tensor) -> None:
    bad = [k for k, t in tensors.items() if not t.is_contiguous()]
    if bad:
        raise ValueError(f"{name}: non-contiguous operand(s) {bad}")


def _raise_on_error(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError "
                           f"{code}")


_sms: dict = {}


def _sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a card (the kernels' plans size their
    grids by it)."""
    if device not in _sms:
        _sms[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sms[device]


def tile_dtype(compute_dtype: str) -> torch.dtype:
    """Operand dtype the kernels load for an ``EngineConfig.gram_dtype``."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}; "
                         f"expected one of {COMPUTE_DTYPES}")
    return torch.bfloat16 if compute_dtype == "bf16" else torch.float32


def _check_mode(mode: str) -> None:
    if mode not in _gram.MODES:
        raise ValueError(f"unknown kernel mode {mode!r}; expected one of "
                         f"{_gram.MODES}")


# --------------------------------------------------------------- rbf_gram
def rbf_gram(a: torch.Tensor, b: torch.Tensor, *, gamma: float = 1.0,
             mode: str = "rbf", compute_dtype: str = "fp32",
             a2: torch.Tensor | None = None,
             b2: torch.Tensor | None = None,
             rows: int | None = None) -> torch.Tensor:
    """K(a, b): (n, m) float32 Gram block (rbf or linear). The operands
    are rounded to ``compute_dtype``; the squared norms are computed
    from the rounded values unless the caller passes them (a resident
    engine keeps the training set's norms). ``rows``: the launch's row
    tile (``rbf_gram.ROWS``)."""
    _check_mode(mode)
    dt = tile_dtype(compute_dtype)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"rbf_gram: need (n, d) and (m, d) operands, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    a, b = a.to(dt), b.to(dt)
    a2 = sqnorms(a) if a2 is None else a2
    b2 = sqnorms(b) if b2 is None else b2
    if a2.shape != (a.shape[0],) or b2.shape != (b.shape[0],):
        raise ValueError("rbf_gram: norm vectors do not match the operands")
    if not _on_card("rbf_gram", a, b, a2, b2):
        return _gram.rbf_gram_plain(a, b, a2, b2, gamma=gamma, mode=mode)
    _check_contiguous("rbf_gram", a2=a2, b2=b2)
    if a2.dtype != torch.float32 or b2.dtype != torch.float32:
        raise ValueError("rbf_gram: norms must be float32")
    out = torch.empty((a.shape[0], b.shape[0]), dtype=torch.float32,
                      device=a.device)
    if out.numel() == 0:
        return out
    a, b = (t if _gram.copyable(t) else _gram.staged(t) for t in (a, b))
    plan = autotune.resolve_gram(a.shape[0], b.shape[0], a.shape[1],
                                 a.dtype, a.device, _sm_count(a.device),
                                 rows)
    lib = _build.library()
    _count("rbf_gram")
    _raise_on_error("rbf_gram", _gram.launch_block(
        lib, a, b, a2, b2, out, gamma=gamma, mode=mode, plan=plan))
    return out


def _row_range(name: str, n: int, row0: int, count: int | None) -> int:
    """The range's row count, checked: ``row0 >= 0``, ``count >= 0``
    (None: the rows from ``row0`` to n)."""
    count = n - row0 if count is None else count
    if row0 < 0 or count < 0:
        raise ValueError(f"{name}: bad row range row0={row0}, "
                         f"count={count}")
    return count


def gram_matvec(x: torch.Tensor, x2: torch.Tensor, v: torch.Tensor, *,
                gamma: float = 1.0, mode: str = "rbf",
                chunk: int = 2048, row0: int = 0,
                count: int | None = None) -> torch.Tensor:
    """K(X, X) v without forming K: (n,) float32 for x (n, d) and x2, v
    (n,). ``x`` is already at the compute precision (float32 or
    bfloat16) and ``x2`` its float32 squared norms, as ``gram_row``
    takes them.

    Row range (one task): rows ``[row0, row0 + count)`` of the product
    over all n columns, (count,) with rows past n zero, each row the
    bits of the whole call's (one rank of the data-parallel SMO).

    Task axis (one launch for a multiclass bucket): x (T, n, d), x2 and
    v (T, n) give the (T, n) products, each the bits of its own one-task
    call. On the card ``x`` goes as ``rbf_gram.staged`` lays it out (the
    pallas engines pass it so; other layouts are copied into it). On the
    CPU, the plain version in ``chunk``-row blocks."""
    _check_mode(mode)
    if x.ndim not in (2, 3) or x.dtype not in (torch.float32,
                                               torch.bfloat16):
        raise ValueError(f"gram_matvec: x must be (n, d) or (T, n, d) "
                         f"float32/bfloat16, got {tuple(x.shape)} {x.dtype}")
    for name, t in (("x2", x2), ("v", v)):
        if t.shape != x.shape[:-1] or t.dtype != torch.float32:
            raise ValueError(f"gram_matvec: {name} must be "
                             f"{tuple(x.shape[:-1])} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if chunk < 1:
        raise ValueError(f"gram_matvec: chunk must be >= 1, got {chunk}")
    n, d = x.shape[-2:]
    if (row0 or count is not None) and x.ndim != 2:
        raise ValueError("gram_matvec: a row range is a one-task call")
    rows = _row_range("gram_matvec", n, row0, count)
    if not _on_card("gram_matvec", x, x2, v):
        return _gram.gram_matvec_plain(x, x2, v, gamma=gamma, mode=mode,
                                       chunk=chunk, row0=row0, count=count)
    _check_contiguous("gram_matvec", x2=x2, v=v)
    count = rows
    out = torch.empty((*x.shape[:-2], count), dtype=torch.float32,
                      device=x.device)
    # rows past n (a range's padding) are zero; the kernel takes the rest
    valid = max(0, min(count, n - row0))
    if valid < count:
        out[valid:].zero_()
    if valid == 0 or out.numel() == 0:
        return out
    x = x if _gram.copyable(x) else _gram.staged(x)
    plan = _gram.gram_plan(valid, valid, d, x.dtype,
                           tasks=x.shape[0] if x.ndim == 3 else 1,
                           entry="matvec", sms=_sm_count(x.device))
    lib = _build.library()
    _count("rbf_gram_matvec_range" if row0 or count != n
           else "rbf_gram_matvec")
    _raise_on_error("rbf_gram_matvec", _gram.launch_matvec(
        lib, x, x2, v, out[..., :valid], gamma=gamma, mode=mode, plan=plan,
        row0=row0))
    return out


def _row_operands(name: str, x, x2, i):
    if x.ndim not in (2, 3) or x.dtype not in (torch.float32,
                                               torch.bfloat16):
        raise ValueError(f"{name}: x must be (n, d) or (T, n, d) "
                         f"float32/bfloat16, got {tuple(x.shape)} {x.dtype}")
    lead = x.shape[:-2]
    if i.shape != lead or i.dtype != torch.int64:
        raise ValueError(f"{name}: i must be int64 of shape {tuple(lead)}"
                         f" (one index per task), got {tuple(i.shape)} "
                         f"{i.dtype}")
    if x2.shape != x.shape[:-1] or x2.dtype != torch.float32:
        raise ValueError(f"{name}: x2 must be {tuple(x.shape[:-1])} "
                         "float32")


def gram_row(x: torch.Tensor, x2: torch.Tensor, i: torch.Tensor, *,
             gamma: float = 1.0, mode: str = "rbf", row0: int = 0,
             count: int | None = None) -> torch.Tensor:
    """The Gram row K(X, x_i), (n,) float32, for the SMO f-cache update.

    ``x`` is already at the compute precision (float32 or bfloat16) and
    ``x2`` its float32 squared norms; ``i`` is a 0-d int64 tensor on the
    same device, so the solver never reads it on the host.

    Row range: entries ``[row0, row0 + count)`` of the row, (count,)
    with entries past n zero, for a global ``i`` (one rank of the
    data-parallel SMO); each the bits of the whole row's.

    Task axis (one launch for a multiclass bucket): x (T, n, d), x2
    (T, n) and i (T,) give the (T, n) rows K(X_t, x_t[i_t]), each the
    bits of the same row from a one-task call."""
    _check_mode(mode)
    _row_operands("gram_row", x, x2, i)
    rows = _row_range("gram_row", x.shape[-2], row0, count)
    if not _on_card("gram_row", x, x2, i):
        return _gram.gram_row_plain(x, x2, i, gamma=gamma, mode=mode,
                                    row0=row0, count=count)
    _check_contiguous("gram_row", x=x, x2=x2, i=i)
    count = rows
    out = torch.empty((*x.shape[:-2], count), dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    _count("rbf_gram_row_range" if row0 or count != x.shape[-2]
           else "rbf_gram_row")
    _raise_on_error("rbf_gram_row", _gram.launch_row(
        lib, x, x2, i, out, gamma=gamma, mode=mode, row0=row0))
    return out


def gram_row_cached(x: torch.Tensor, x2: torch.Tensor, i: torch.Tensor,
                    keys: torch.Tensor, stamp: torch.Tensor,
                    rows: torch.Tensor, clock: torch.Tensor,
                    hits: torch.Tensor, misses: torch.Tensor, *,
                    gamma: float = 1.0, mode: str = "rbf",
                    row0: int = 0, count: int | None = None) -> torch.Tensor:
    """``gram_row`` through the solver's LRU row cache (the fields of
    ``kernel_engine.RowCache``: keys / stamp (slots,) int64, rows
    (slots, count) float32, clock / hits / misses 0-d int64), in one
    launch on the card: the lookup, the row on a miss (written into its
    slot), the state's update in place, and a (count,) copy of the row.
    The slots hold entries ``[row0, row0 + count)`` of each row (count
    defaults to n - row0; past n, zeros), as ``gram_row``'s range gives
    them. The state after any sequence of calls is the one
    ``rbf_gram.lru_row_plain`` leaves, bit for bit; the row is the
    uncached entry's."""
    _check_mode(mode)
    _row_operands("gram_row_cached", x, x2, i)
    if x.ndim != 2:
        raise ValueError("gram_row_cached: the row cache is a one-task "
                         f"feature; x must be (n, d), got {tuple(x.shape)}")
    slots = keys.shape[0] if keys.ndim == 1 else 0
    n = _row_range("gram_row_cached", x.shape[0], row0, count)
    state = dict(keys=keys, stamp=stamp, rows=rows, clock=clock, hits=hits,
                 misses=misses)
    want = dict(keys=((slots,), torch.int64), stamp=((slots,), torch.int64),
                rows=((slots, n), torch.float32), clock=((), torch.int64),
                hits=((), torch.int64), misses=((), torch.int64))
    if not slots or any((tuple(t.shape), t.dtype) != want[k]
                        for k, t in state.items()):
        raise ValueError(f"gram_row_cached: the row cache's (shape, dtype) "
                         f"must be {want} with slots >= 1")
    if not _on_card("gram_row_cached", x, x2, i, *state.values()):
        return _gram.lru_row_plain(
            keys, stamp, rows, clock, hits, misses, i,
            lambda j: _gram.gram_row_plain(x, x2, j, gamma=gamma, mode=mode,
                                           row0=row0, count=n))
    _check_contiguous("gram_row_cached", x=x, x2=x2, i=i, **state)
    out = torch.empty((n,), dtype=torch.float32, device=x.device)
    lib = _build.library()
    _count("rbf_gram_row_cached_range" if row0 or n != x.shape[0]
           else "rbf_gram_row_cached")
    _raise_on_error("rbf_gram_row_cached", _gram.launch_row_cached(
        lib, x, x2, i, out, keys, stamp, rows, clock, hits, misses,
        gamma=gamma, mode=mode, row0=row0))
    return out


# ------------------------------------------------------------- kkt_select
def kkt_select(f: torch.Tensor, alpha: torch.Tensor, y: torch.Tensor,
               mask: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, *,
               blocks: int | None = None):
    """Fused masked KKT selection: (b_up, i_up, b_low, i_low) on the
    operands' device (float32 values, int64 indices) — 0-d tensors for
    (n,) inputs; with the task axis, (T, n) inputs give four (T,)
    tensors from one launch, each task selected on its own. ``blocks``:
    the launch's blocks a task (1 .. ``kkt_select.MAX_BLOCKS``)."""
    shape = f.shape
    if f.ndim not in (1, 2) or shape[-1] == 0:
        raise ValueError(f"kkt_select: need non-empty (n,) or (T, n) "
                         f"inputs, got {tuple(shape)}")
    for name, t in (("f", f), ("alpha", alpha), ("y", y), ("lo", lo),
                    ("hi", hi)):
        if t.shape != shape or t.dtype != torch.float32:
            raise ValueError(f"kkt_select: {name} must be {tuple(shape)} "
                             f"float32, got {tuple(t.shape)} {t.dtype}")
    if mask.shape != shape or mask.dtype != torch.bool:
        raise ValueError(f"kkt_select: mask must be {tuple(shape)} bool")
    if not _on_card("kkt_select", f, alpha, y, mask, lo, hi):
        return _kkt.kkt_select_plain(f, alpha, y, mask, lo, hi)
    _check_contiguous("kkt_select", f=f, alpha=alpha, y=y, mask=mask, lo=lo,
                      hi=hi)
    dev = f.device
    n_tasks = shape[0] if f.ndim == 2 else 1
    # one allocation: (i_up, i_low) of each task, then the (b_up, b_low)
    # float32 pairs in the last n_tasks int64 words
    out = torch.empty(3 * n_tasks, dtype=torch.int64, device=dev)
    idx = out[:2 * n_tasks].view((2,) + shape[:-1])
    vals = out[2 * n_tasks:].view(torch.float32).view((2,) + shape[:-1])
    blocks = autotune.resolve_kkt(shape[-1], dev, blocks)
    lib = _build.library()
    _count("kkt_select")
    _raise_on_error("kkt_select", _kkt.launch(lib, f, alpha, y, mask, lo, hi,
                                              vals, idx, blocks=blocks))
    return vals[0], idx[0], vals[1], idx[1]


# --------------------------------------------------------------- decision
def _decision_operands(name, z, sv, coef, compute_dtype, *,
                       keep_half_bank: bool = False):
    """Test rows and bank at the compute dtype, coef in float32; with
    ``keep_half_bank``, a float16 or bfloat16 bank under float32 compute
    stays at its storage dtype (the kernel widens it as it stages it)."""
    dt = tile_dtype(compute_dtype)
    if z.ndim != 2 or z.shape[1] != sv.shape[-1]:
        raise ValueError(f"{name}: need (nt, d) test rows matching the "
                         f"bank's d, got {tuple(z.shape)} and "
                         f"{tuple(sv.shape)}")
    if coef.shape != sv.shape[:-1]:
        raise ValueError(f"{name}: coef shape {tuple(coef.shape)} != bank "
                         f"shape {tuple(sv.shape[:-1])}")
    half = sv.dtype in (torch.float16, torch.bfloat16)
    bank_dt = sv.dtype if keep_half_bank and half and dt == torch.float32 \
        else dt
    return z.to(dt), sv.to(bank_dt), coef.to(torch.float32)


def decision(z: torch.Tensor, x: torch.Tensor, coef: torch.Tensor,
             b: torch.Tensor | float = 0.0, *, gamma: float = 1.0,
             compute_dtype: str = "fp32", rows: int | None = None,
             splits: int | None = None) -> torch.Tensor:
    """f(z) = K(z, X) @ coef + b (RBF) for a batch of test rows.
    ``rows`` / ``splits``: the launch's row tile (64 or 128) and SV-axis
    split count (``decision.plan_with``)."""
    z, x, coef = _decision_operands("decision", z, x, coef, compute_dtype)
    if x.ndim != 2:
        raise ValueError("decision: x must be (n, d)")
    if not _on_card("decision", z, x, coef):
        return _decision.decision_plain(z, x, coef, gamma=gamma) + b
    _check_contiguous("decision", z=z, x=x, coef=coef)
    if z.shape[0] == 0 or x.shape[0] == 0:
        return torch.zeros((z.shape[0],), dtype=torch.float32,
                           device=z.device) + b
    out = torch.empty((z.shape[0],), dtype=torch.float32, device=z.device)
    plan = autotune.resolve_decision(
        "decision", z.shape[0], 1, x.shape[0], z.shape[1], z.dtype,
        z.device, _sm_count(z.device), rows, splits, x.dtype)
    stream = current_stream()
    partial, ticket = _decision.scratch(plan, 1, z.shape[0], z.device,
                                        stream)
    lib = _build.library()
    _count("decision")
    _raise_on_error("decision", _decision.launch_decision(
        lib, z, x, coef, out, gamma=gamma, plan=plan, partial=partial,
        ticket=ticket, stream=stream))
    return out + b


def multitask_decision(z: torch.Tensor, sv: torch.Tensor,
                       coef: torch.Tensor, b: torch.Tensor | None = None, *,
                       gamma: float = 1.0, mode: str = "rbf",
                       compute_dtype: str = "fp32", rows: int | None = None,
                       splits: int | None = None) -> torch.Tensor:
    """f_t(z) = K(z, SV_t) @ coef_t + b_t for a stacked (T, w, d) bank:
    (T, nt) float32. Under float32 compute a float16 or bfloat16 bank (a
    quantized pack's) is read at that dtype, not copied: its launches
    count under ``multitask_decision_fp16_bank`` / ``_bf16_bank``. A
    width-0 bank (no support vectors anywhere) short-circuits to the
    broadcast bias. ``rows`` / ``splits`` as ``decision`` takes them."""
    _check_mode(mode)
    if sv.ndim != 3:
        raise ValueError("multitask_decision: sv must be (T, w, d)")
    z, sv, coef = _decision_operands("multitask_decision", z, sv, coef,
                                     compute_dtype, keep_half_bank=True)
    n_tasks, w, _ = sv.shape
    bias = (None if b is None
            else b.to(torch.float32).reshape(n_tasks, 1))
    if w == 0 or z.shape[0] == 0:
        out = torch.zeros((n_tasks, z.shape[0]), dtype=torch.float32,
                          device=z.device)
        return out if bias is None else out + bias
    if not _on_card("multitask_decision", z, sv, coef):
        out = _decision.multitask_decision_plain(z, sv, coef, gamma=gamma,
                                                 mode=mode)
        return out if bias is None else out + bias
    _check_contiguous("multitask_decision", z=z, sv=sv, coef=coef)
    out = torch.empty((n_tasks, z.shape[0]), dtype=torch.float32,
                      device=z.device)
    plan = autotune.resolve_decision(
        "multitask_decision", z.shape[0], n_tasks, w, z.shape[1], z.dtype,
        z.device, _sm_count(z.device), rows, splits, sv.dtype)
    stream = current_stream()
    partial, ticket = _decision.scratch(plan, n_tasks, z.shape[0], z.device,
                                        stream)
    lib = _build.library()
    _count(_BANK_COUNTS[(z.dtype, sv.dtype)])
    _raise_on_error("multitask_decision", _decision.launch_multitask(
        lib, z, sv, coef, out, gamma=gamma, mode=mode, plan=plan,
        partial=partial, ticket=ticket, stream=stream))
    return out if bias is None else out + bias


# the launch count of a multitask_decision call, by (rows, bank) dtype
_BANK_COUNTS = {(torch.float32, torch.float32): "multitask_decision",
                (torch.bfloat16, torch.bfloat16): "multitask_decision",
                (torch.float32, torch.float16): "multitask_decision_fp16_bank",
                (torch.float32, torch.bfloat16):
                    "multitask_decision_bf16_bank"}


# ----------------------------------------------------------- rff_features
def rff_features(x: torch.Tensor, omega: torch.Tensor, phase: torch.Tensor,
                 *, scale: float, compute_dtype: str = "fp32",
                 rows: int | None = None) -> torch.Tensor:
    """``scale * cos(x @ omega + phase)``: (n, k) float32 random Fourier
    features of x (n, d), with omega (d, k) and phase (k,). x and omega
    are rounded to ``compute_dtype``; accumulation and the epilogue are
    float32. ``rows``: the launch's row tile (64 or 128)."""
    dt = tile_dtype(compute_dtype)
    if (x.ndim != 2 or omega.ndim != 2 or x.shape[1] != omega.shape[0]
            or phase.shape != (omega.shape[1],)):
        raise ValueError(f"rff_features: need x (n, d), omega (d, k) and "
                         f"phase (k,), got {tuple(x.shape)}, "
                         f"{tuple(omega.shape)} and {tuple(phase.shape)}")
    x, omega = x.to(dt), omega.to(dt)
    phase = phase.to(torch.float32)
    if not _on_card("rff_features", x, omega, phase):
        return _fmap.rff_features_plain(x, omega, phase, scale=scale)
    _check_contiguous("rff_features", x=x, omega=omega, phase=phase)
    out = torch.empty((x.shape[0], omega.shape[1]), dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out
    plan = autotune.resolve_rff(x.shape[0], omega.shape[1], x.shape[1],
                                x.dtype, x.device, _sm_count(x.device), rows)
    lib = _build.library()
    _count("rff_features")
    _raise_on_error("rff_features", _fmap.launch(lib, x, omega, phase, out,
                                                 scale=scale, plan=plan))
    return out


# -------------------------------------------------------------- dcd_epoch
def dcd_epoch(phi: torch.Tensor, y: torch.Tensor, p: torch.Tensor,
              lo: torch.Tensor, hi: torch.Tensor, q_diag: torch.Tensor,
              live: torch.Tensor, perm: torch.Tensor, beta: torch.Tensor,
              w: torch.Tensor, wb: torch.Tensor, *,
              bias: float) -> torch.Tensor:
    """One epoch of dual coordinate descent over Phi (n, k), visiting the
    coordinates in the order ``perm`` (n,) int64. Updates ``beta`` (n,),
    ``w`` (k,) and ``wb`` (1,) in place and returns the epoch's max
    projected gradient over ``live`` coordinates, a 0-d float32 tensor
    on the operands' device (the caller decides when to read it)."""
    if phi.ndim != 2 or phi.dtype != torch.float32:
        raise ValueError(f"dcd_epoch: phi must be (n, k) float32, got "
                         f"{tuple(phi.shape)} {phi.dtype}")
    n, k = phi.shape
    for name, t, shape in (("y", y, (n,)), ("p", p, (n,)), ("lo", lo, (n,)),
                           ("hi", hi, (n,)), ("q_diag", q_diag, (n,)),
                           ("beta", beta, (n,)), ("w", w, (k,)),
                           ("wb", wb, (1,))):
        if t.shape != shape or t.dtype != torch.float32:
            raise ValueError(f"dcd_epoch: {name} must be {shape} float32, "
                             f"got {tuple(t.shape)} {t.dtype}")
    if live.shape != (n,) or live.dtype != torch.bool:
        raise ValueError(f"dcd_epoch: live must be ({n},) bool")
    if perm.shape != (n,) or perm.dtype != torch.int64:
        raise ValueError(f"dcd_epoch: perm must be ({n},) int64")
    tensors = dict(phi=phi, y=y, p=p, lo=lo, hi=hi, q_diag=q_diag, live=live,
                   perm=perm, beta=beta, w=w, wb=wb)
    if not _on_card("dcd_epoch", *tensors.values()):
        return _dcd.dcd_epoch_plain(phi, y, p, lo, hi, q_diag, live, perm,
                                    beta, w, wb, bias=bias)
    _check_contiguous("dcd_epoch", **tensors)
    _check_rank("dcd_epoch", k)
    viol = torch.empty((1,), dtype=torch.float32, device=phi.device)
    lib = _build.library()
    _count("dcd_epoch")
    _raise_on_error("dcd_epoch", _dcd.launch(
        lib, phi, y, p, lo, hi, q_diag, live, perm, beta, w, wb, viol,
        bias=bias, plan=_dcd.dcd_plan(k)))
    return viol[0]


def _check_rank(name: str, k: int) -> None:
    if not 1 <= k <= DCD_MAX_RANK:
        raise ValueError(f"{name}: rank {k} outside [1, {DCD_MAX_RANK}]"
                         ": w lives in one block's shared memory")


def dcd_epoch_tasks(phi: torch.Tensor, rows: torch.Tensor,
                    offsets: torch.Tensor, y: torch.Tensor, p: torch.Tensor,
                    lo: torch.Tensor, hi: torch.Tensor, q_diag: torch.Tensor,
                    live: torch.Tensor, perm: torch.Tensor,
                    beta: torch.Tensor, w: torch.Tensor, wb: torch.Tensor,
                    tasks: torch.Tensor, *, bias: float) -> torch.Tensor:
    """One epoch of T dual coordinate descents over one shared Phi (N, k)
    in one launch, for the tasks listed in ``tasks`` (B,) int64. Task t
    owns the coordinates ``[offsets[t], offsets[t+1])`` (``offsets``
    (T+1,) int64, from 0) of the concatenated (m,) vectors ``y``, ``p``,
    ``lo``, ``hi``, ``q_diag``, ``live``, ``beta``, ``rows`` (int64, the
    row of Phi of each coordinate) and ``perm`` (int64, each segment a
    visiting order of its local indices 0 .. n_t - 1), row t of ``w``
    (T, k) and ``wb[t]`` (T,). Each listed task gets exactly what a
    one-task launch on its gathered rows gives it; the others are left
    as they are. Returns the (B,) max projected gradients in the order
    of ``tasks``. The offsets, rows and permutations are not read on
    the host: the caller vouches for them."""
    if phi.ndim != 2 or phi.dtype != torch.float32:
        raise ValueError(f"dcd_epoch_tasks: phi must be (N, k) float32, got "
                         f"{tuple(phi.shape)} {phi.dtype}")
    k = phi.shape[1]
    if offsets.ndim != 1 or offsets.shape[0] < 2 \
            or offsets.dtype != torch.int64:
        raise ValueError("dcd_epoch_tasks: offsets must be (T+1,) int64, "
                         "T >= 1")
    n_tasks = offsets.shape[0] - 1
    m = y.shape[0] if y.ndim == 1 else -1
    for name, t, shape in (("y", y, (m,)), ("p", p, (m,)), ("lo", lo, (m,)),
                           ("hi", hi, (m,)), ("q_diag", q_diag, (m,)),
                           ("beta", beta, (m,)), ("w", w, (n_tasks, k)),
                           ("wb", wb, (n_tasks,))):
        if t.shape != shape or t.dtype != torch.float32:
            raise ValueError(f"dcd_epoch_tasks: {name} must be {shape} "
                             f"float32, got {tuple(t.shape)} {t.dtype}")
    if live.shape != (m,) or live.dtype != torch.bool:
        raise ValueError(f"dcd_epoch_tasks: live must be ({m},) bool")
    for name, t, shape in (("rows", rows, (m,)), ("perm", perm, (m,))):
        if t.shape != shape or t.dtype != torch.int64:
            raise ValueError(f"dcd_epoch_tasks: {name} must be {shape} "
                             "int64")
    if tasks.ndim != 1 or tasks.dtype != torch.int64:
        raise ValueError("dcd_epoch_tasks: tasks must be (B,) int64")
    tensors = dict(phi=phi, rows=rows, offsets=offsets, y=y, p=p, lo=lo,
                   hi=hi, q_diag=q_diag, live=live, perm=perm, beta=beta,
                   w=w, wb=wb, tasks=tasks)
    if not _on_card("dcd_epoch_tasks", *tensors.values()):
        return _dcd.dcd_epoch_tasks_plain(
            phi, rows, offsets, tasks, y, p, lo, hi, q_diag, live, perm,
            beta, w, wb, bias=bias)
    _check_contiguous("dcd_epoch_tasks", **tensors)
    _check_rank("dcd_epoch_tasks", k)
    viol = torch.empty((tasks.shape[0],), dtype=torch.float32,
                       device=phi.device)
    if tasks.shape[0] == 0:
        return viol
    lib = _build.library()
    _count("dcd_epoch")
    _raise_on_error("dcd_epoch_tasks", _dcd.launch(
        lib, phi, y, p, lo, hi, q_diag, live, perm, beta, w, wb, viol,
        bias=bias, plan=_dcd.dcd_plan(k), rows=rows, offsets=offsets,
        tasks=tasks))
    return viol


# -------------------------------------------------------- flash_attention
FLASH_MAX_D = 128   # csrc/flash_attn.cu: outputs held in registers
_ATTN_DTYPES = (torch.float32, torch.bfloat16)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Softmax attention over (B, S, H, D) tensors with grouped-query
    heads (k, v (B, Sk, Hkv, D), H a multiple of Hkv), scale D^-0.5, the
    causal mask by global position. The result is (B, Sq, H, D) in
    q's dtype, or float32 if ``out_dtype`` asks for it, computed in
    float32 from operands of q's dtype (float32 or bfloat16). Nothing is
    padded: the kernel masks its ragged edges.

    Differentiable (``FlashAttention``): where a gradient is wanted, the
    forward also keeps each row's log-sum-exp and the backward is
    ``flash_attention_bwd``."""
    out_dtype = _check_flash(q, k, v, out_dtype)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    return FlashAttention.apply(q, k, v, bool(causal), out_dtype, grad)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        out_dtype: torch.dtype | None = None):
    """``flash_attention``'s output and each row's log-sum-exp (B, H, Sq)
    float32 in natural log (+inf for a row that sees no key), as the
    backward reads it; no gradient is tracked. The output's bits are
    ``flash_attention``'s."""
    out_dtype = _check_flash(q, k, v, out_dtype)
    return _flash_forward(q.detach(), k.detach(), v.detach(), bool(causal),
                          out_dtype, True)


def _check_flash(q, k, v, out_dtype):
    """The checks of ``flash_attention``; returns the output dtype."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: need q (B, S, H, D) and k, v "
                         f"(B, Sk, Hkv, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    b, _, h, d = q.shape
    if (k.shape[0] != b or k.shape[3] != d or k.shape[1] == 0
            or h % k.shape[2]):
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"fit q {tuple(q.shape)} (same B and D, H a "
                         "multiple of Hkv, Sk >= 1)")
    if q.dtype not in _ATTN_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must share a dtype of "
                         f"{_ATTN_DTYPES}, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    out_dtype = q.dtype if out_dtype is None else out_dtype
    if out_dtype not in (q.dtype, torch.float32):
        raise ValueError(f"flash_attention: out_dtype must be q's dtype "
                         f"{q.dtype} or torch.float32, got {out_dtype}")
    if _on_card("flash_attention", q, k, v):
        _check_contiguous("flash_attention", q=q, k=k, v=v)
        if d > FLASH_MAX_D:
            raise ValueError(f"flash_attention: head dim {d} > "
                             f"{FLASH_MAX_D}, which the kernel holds in "
                             "registers")
    return out_dtype


def _flash_forward(q, k, v, causal: bool, out_dtype, with_lse: bool):
    """(out, lse or None): the kernel, or on CPU tensors the plain
    version (its log-sum-exp only ``with_lse``)."""
    if not q.is_cuda:
        out = _flash.flash_attention_plain(q, k, v, causal=causal,
                                           out_dtype=out_dtype)
        lse = (_flash.attention_lse_plain(q, k, causal=causal)
               if with_lse else None)
        return out, lse
    b, sq, h, d = q.shape
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    plan = _flash.flash_plan(b, sq, h, d, q.dtype, sms=_sm_count(q.device))
    lib = _build.library()
    _count("flash_attention")
    _raise_on_error("flash_attention", _flash.launch(
        lib, q, k, v, out, causal=causal, plan=plan, lse=lse))
    return out, lse


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its gradient: on the card the forward
    kernel (keeping each row's log-sum-exp when a gradient is wanted) and
    the backward kernel; on CPU tensors their plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, out_dtype, grad):
        out, lse = _flash_forward(q, k, v, causal, out_dtype, grad)
        if grad:
            ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do,
                                         causal=ctx.causal)
        return dq, dk, dv, None, None, None


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True):
    """(dq, dk, dv) of ``flash_attention`` at q, k, v (float32 or
    bfloat16), given its output o and the output's gradient do (both of
    o's dtype: q's or float32) and each row's log-sum-exp lse (B, H, Sq)
    float32; gradients in q's dtype. On the card the hand-written kernel
    (``csrc/flash_attn_bwd.cu``), on CPU tensors its plain version."""
    do = do.to(o.dtype).contiguous()
    if q.shape != o.shape or do.shape != o.shape:
        raise ValueError(f"flash_attention_bwd: o and do must be q's shape "
                         f"{tuple(q.shape)}, got {tuple(o.shape)} and "
                         f"{tuple(do.shape)}")
    b, sq, h, d = q.shape
    if lse.shape != (b, h, sq):
        raise ValueError(f"flash_attention_bwd: lse must be {(b, h, sq)}, "
                         f"got {tuple(lse.shape)}")
    if not _on_card("flash_attention_bwd", q, k, v, o, lse, do):
        return _flash.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                causal=causal)
    if q.dtype not in _ATTN_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: q, k, v must share a dtype "
                         f"of {_ATTN_DTYPES}, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if lse.dtype != torch.float32 or o.dtype not in (q.dtype,
                                                     torch.float32):
        raise ValueError(f"flash_attention_bwd: lse must be float32 and o "
                         f"of q's dtype or float32, got {lse.dtype} and "
                         f"{o.dtype}")
    if k.ndim != 4 or v.shape != k.shape or k.shape[0] != b \
            or k.shape[3] != d or k.shape[2] < 1 or h % k.shape[2]:
        raise ValueError(f"flash_attention_bwd: k and v must be (B, Sk, "
                         f"Hkv, D) with H {h} a multiple of Hkv, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if d > FLASH_MAX_D:
        raise ValueError(f"flash_attention_bwd: head dim {d} > "
                         f"{FLASH_MAX_D}, which the kernel holds in "
                         "registers")
    _check_contiguous("flash_attention_bwd", q=q, k=k, v=v, o=o, lse=lse,
                      do=do)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    plan = _flash.bwd_plan(b, sq, k.shape[1], h, k.shape[2], d, q.dtype,
                           o.dtype)
    lib = _build.library()
    _count("flash_attention_bwd")
    _raise_on_error("flash_attention_bwd", _flash.launch_bwd(
        lib, q, k, v, o, lse, do, dq, dk, dv, delta, causal=causal,
        plan=plan))
    return dq, dk, dv


# --------------------------------------------------------------- ssd_diag
SSD_MAX_N = 256     # csrc/ssd_diag.cu: the C tile stays in shared memory
SSD_BWD_MAX_P = 128  # csrc/ssd_diag_bwd.cu: x and dY tiles of a ring stage


def ssd_diag(cmat: torch.Tensor, bmat: torch.Tensor, x: torch.Tensor,
             dt: torch.Tensor, cs: torch.Tensor) -> torch.Tensor:
    """Intra-chunk SSD term (BC, H, Q, P) float32 of C, B (BC, Q, N),
    x (BC, H, Q, P), dt and cs (BC, H, Q): per (chunk, head)
    ``Y = ((C B^T) * L * dt_k) x`` with ``L[q, k] = exp(cs_q - cs_k)``
    for k <= q, else 0. Operands are taken as float32, as the
    reference's kernel casts them.

    Differentiable (``SsdDiag``): the backward is ``ssd_diag_bwd``."""
    cmat, bmat, x, dt, cs = (t.to(torch.float32)
                             for t in (cmat, bmat, x, dt, cs))
    if cmat.ndim != 3 or bmat.shape != cmat.shape or x.ndim != 4:
        raise ValueError(f"ssd_diag: need C, B (BC, Q, N) and x "
                         f"(BC, H, Q, P), got {tuple(cmat.shape)}, "
                         f"{tuple(bmat.shape)} and {tuple(x.shape)}")
    bc, q, n = cmat.shape
    if x.shape[0] != bc or x.shape[2] != q:
        raise ValueError(f"ssd_diag: x {tuple(x.shape)} does not fit C "
                         f"{tuple(cmat.shape)}")
    for name, t in (("dt", dt), ("cs", cs)):
        if t.shape != x.shape[:3]:
            raise ValueError(f"ssd_diag: {name} must be "
                             f"{tuple(x.shape[:3])}, got {tuple(t.shape)}")
    if _on_card("ssd_diag", cmat, bmat, x, dt, cs):
        _check_contiguous("ssd_diag", cmat=cmat, bmat=bmat, x=x, dt=dt,
                          cs=cs)
        if n > SSD_MAX_N:
            raise ValueError(f"ssd_diag: state dim {n} > {SSD_MAX_N}, which "
                             "the kernel's shared memory holds")
    return SsdDiag.apply(cmat, bmat, x, dt, cs)


class SsdDiag(torch.autograd.Function):
    """``ssd_diag`` with its gradient: on the card the forward and
    backward kernels, on CPU tensors their plain versions."""

    @staticmethod
    def forward(ctx, cmat, bmat, x, dt, cs):
        ctx.save_for_backward(cmat, bmat, x, dt, cs)
        if not x.is_cuda:
            return _ssd.ssd_diag_plain(cmat, bmat, x, dt, cs)
        out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        if out.numel() == 0:
            return out
        bc, q, n = cmat.shape
        plan = _ssd.ssd_plan(bc, x.shape[1], q, n, x.shape[3],
                             sms=_sm_count(x.device))
        lib = _build.library()
        _count("ssd_diag")
        _raise_on_error("ssd_diag", _ssd.launch(lib, cmat, bmat, x, dt, cs,
                                                out, plan=plan))
        return out

    @staticmethod
    def backward(ctx, dy):
        return ssd_diag_bwd(*ctx.saved_tensors, dy)


def ssd_diag_bwd(cmat: torch.Tensor, bmat: torch.Tensor, x: torch.Tensor,
                 dt: torch.Tensor, cs: torch.Tensor, dy: torch.Tensor):
    """(dC, dB, dx, ddt, dcs) of ``ssd_diag`` at its float32 operands,
    given dY (BC, H, Q, P), all float32. On the card the hand-written
    kernel (``csrc/ssd_diag_bwd.cu``), on CPU tensors its plain
    version."""
    dy = dy.to(x.dtype).contiguous()
    if dy.shape != x.shape:
        raise ValueError(f"ssd_diag_bwd: dy must be x's shape "
                         f"{tuple(x.shape)}, got {tuple(dy.shape)}")
    if not _on_card("ssd_diag_bwd", cmat, bmat, x, dt, cs, dy):
        return _ssd.ssd_diag_bwd_plain(cmat, bmat, x, dt, cs, dy)
    bad = [k for k, t in (("cmat", cmat), ("bmat", bmat), ("x", x),
                          ("dt", dt), ("cs", cs)) if t.dtype != torch.float32]
    if bad:
        raise ValueError(f"ssd_diag_bwd: operands must be float32, not "
                         f"{bad}")
    if cmat.ndim != 3 or bmat.shape != cmat.shape or x.ndim != 4 \
            or x.shape[0] != cmat.shape[0] or x.shape[2] != cmat.shape[1] \
            or dt.shape != x.shape[:3] or cs.shape != x.shape[:3]:
        raise ValueError(f"ssd_diag_bwd: need C, B (BC, Q, N), x (BC, H, Q, "
                         f"P), dt and cs (BC, H, Q), got {tuple(cmat.shape)}, "
                         f"{tuple(bmat.shape)}, {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(cs.shape)}")
    _check_contiguous("ssd_diag_bwd", cmat=cmat, bmat=bmat, x=x, dt=dt,
                      cs=cs, dy=dy)
    bc, q, n = cmat.shape
    h, p = x.shape[1], x.shape[3]
    if n > SSD_MAX_N or p > SSD_BWD_MAX_P:
        raise ValueError(f"ssd_diag_bwd: N {n} (<= {SSD_MAX_N}) and P {p} "
                         f"(<= {SSD_BWD_MAX_P}) are more than the kernel's "
                         "tiles hold")
    dc, db = torch.empty_like(cmat), torch.empty_like(bmat)
    dx = torch.empty_like(x)
    ddt, dcs = torch.empty_like(dt), torch.empty_like(cs)
    if dx.numel() == 0 or dc.numel() == 0:
        return dc.zero_(), db.zero_(), dx.zero_(), ddt.zero_(), dcs.zero_()
    plan = _ssd.bwd_plan(bc, h, q, n, p, sms=_sm_count(x.device))
    part = torch.empty((plan.groups, bc, plan.pairs, _ssd.BWD_TILE ** 2),
                       dtype=torch.float32, device=x.device)
    lib = _build.library()
    _count("ssd_diag_bwd")
    _raise_on_error("ssd_diag_bwd", _ssd.launch_bwd(
        lib, cmat, bmat, x, dt, cs, dy, part, dc, db, dx, ddt, dcs,
        plan=plan))
    return dc, db, dx, ddt, dcs
