"""Parallel binary SMO — the paper's CUDA solver, in PyTorch on the card.

Mirrors the unsharded half of ``repro/core/smo.py``: first-order
working-set selection SMO (Keerthi modification 2) over the general
box-constrained dual QP

    min_a 1/2 a'Qa + p'a   s.t. sum_i y_i a_i = 0,  lo <= a <= hi

with Q_ij = y_i y_j K(x_i, x_j), working on the optimality vector
f_i = y_i ((Q a)_i + p_i); ``binary_smo`` is the classification
instance (p = -1, box [0, C]), ``svr_smo`` the epsilon-SVR one over
the doubled variables [alpha; alpha*] (p = [eps - y; eps + y], per-
sample signs [+1; -1]).

The reference runs the whole solve on the device (``lax.while_loop``
around ``fori_loop``). Here the loop does not wait for the host on any
iteration: the working pair, every scalar of the pair update and the
``step_live`` flag stay 0-d tensors on the device, the kernel-row cache
decides hit or miss on the device, and the host reads one pair of
numbers (converged?, n_iter) per block of ``check_every`` iterations —
the paper's "convergence checks on the host for every set of iterations
on the device". The solve's state lives in buffers allocated once and
written in place, so on the card a block is a device program of its
own: the first block runs eagerly, the second is captured as a CUDA
graph, and that block and every later one is one replay of it
(``_Block``; ``CUDA_GRAPHS`` switches the capture off). As in the
reference, a block always runs all its iterations (a step after
convergence is a no-op), ``n_iter`` counts only live steps, and
``max_iter`` is tested per block. Without shrinking, a check whose gap
says converged also recomputes f once and stops only if the float64
``kkt_violation`` of that f is <= tol (the reference stops on its
float32 gap alone, which ~60k float32 f updates can leave past tol); a
certified state is returned as the cached f gives it, bit for bit the
reference's. On the card, selection is the ``kkt_select`` kernel and the
two kernel rows per iteration come from the ``rbf_gram`` cached row kernel
(``engine="pallas"``: one launch a row, the LRU lookup included).

``solve_qp_tasks`` / ``binary_smo_tasks`` solve the T problems of a
multiclass bucket at once (x (T, w, d)): the same iteration over (T, w)
state, one launch of each task-axis kernel per step for the whole
bucket, each task frozen once its own gap closes — so each ends where
it would alone, as under the reference's vmap.

``sharded_solve_qp`` / ``sharded_binary_smo`` / ``sharded_svr_smo``
are the paper's MPI-CUDA solver: ONE QP data-parallel over the ranks of
a ``launch.mesh.Mesh``. Each rank owns a contiguous block of the
samples (n zero-padded to P equal blocks, the padding masked) and its
row block of the Gram matrix (``ShardedKernelEngine``:
the ``rbf_gram`` row-range entries); selection is a per-rank
``kkt_select`` followed by one all_reduce (the MPI_Allreduce), the pair's
scalars come in one more, and the f update runs over each rank's own
samples. It is a collective call (SPMD: every rank calls it with the
same arguments and gets the same full result), and its result is the
unsharded ``solve_qp``'s with ``engine="pallas"``, bit for bit (RBF and
linear kernels; poly and sigmoid reach its optimum within tol).

``kkt_violation`` is the solver-independent optimality certificate,
computed in float64.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.analysis import compile_guard
from repro_torch.core import kernel_engine as KE
from repro_torch.core import kernels as K
from repro_torch.kernels import ops

# On the card, solve_qp and solve_qp_tasks run each check block after the
# first as one replay of a CUDA graph captured once per solve (``_Block``);
# False runs every block eagerly. The two give the same bits: tests and
# chip_smoke.py set it to compare them. The CPU never captures.
CUDA_GRAPHS = True


@dataclasses.dataclass(frozen=True)
class SMOConfig:
    """Solver hyper-parameters (box constraint + stopping rule). The
    reference's legacy ``precompute_gram`` / ``use_pallas`` shims are
    not carried over: pass ``engine=`` instead."""

    C: float = 1.0
    tol: float = 1e-3
    max_iter: int = 100_000       # hard cap on SMO pair updates
    check_every: int = 32         # device iterations per convergence check
    selection: str = "first"      # first (paper) | second (WSS2)
    shrink_every: int = 0         # convergence checks between adaptive-
                                  # shrinking passes; 0 disables shrinking
    shrink_slack: float = 1.0     # freeze corridor slack, in units of tol


class SMOResult(NamedTuple):
    alpha: torch.Tensor      # (n,) Lagrange multipliers
    b: torch.Tensor          # () bias, decision = sum a_i y_i K(x_i, .) + b
    n_iter: torch.Tensor     # () pair updates actually applied
    converged: torch.Tensor  # () bool
    gap: torch.Tensor        # () final b_low - b_up
    n_active: torch.Tensor   # () samples still active at exit


@dataclasses.dataclass
class _State:
    alpha: torch.Tensor
    f: torch.Tensor
    n_iter: torch.Tensor
    b_up: torch.Tensor
    b_low: torch.Tensor
    active: torch.Tensor     # (n,) bool adaptive-shrinking active set
    cache: Optional[KE.RowCache]


def _selection(f, alpha, y, mask, lo, hi):
    """Working-set selection: (b_up, i_up, b_low, i_low), 0-d tensors
    ((T,) tensors for a bucket of T tasks).

    The reduction stage — the CUDA block-reduce of the paper. On the
    card it is one ``kkt_select`` kernel launch, for a whole bucket too;
    membership epsilon is relative to the box width, 1e-6 (hi - lo)
    (see the reference)."""
    return ops.kkt_select(f, alpha, y, mask, lo, hi)


def _gather(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``t[..., i]`` on the device: one entry of a (n,) vector for a 0-d
    index, or of each row of a (T, n) bucket for (T,) indices."""
    return t.gather(-1, i.unsqueeze(-1)).squeeze(-1)


def _pair_update(a_i, a_j, y_i, y_j, f_i, f_j, k_ii, k_jj, k_ij,
                 lo_i, hi_i, lo_j, hi_j):
    """Scalar two-multiplier update for the working pair (i, j): the
    Newton step on a_j clipped to the segment the equality constraint
    cuts out of the box, with exact-bound snapping (reference
    ``_pair_update``, expression for expression)."""
    eta = torch.clamp_min(k_ii + k_jj - 2.0 * k_ij, 1e-12)
    a_j_new = a_j + y_j * (f_i - f_j) / eta
    same = y_i == y_j
    # same sign: a_i + a_j is conserved; opposite: a_j - a_i is conserved
    lo_seg = torch.where(same, torch.maximum(lo_j, a_i + a_j - hi_i),
                         torch.maximum(lo_j, lo_i + a_j - a_i))
    hi_seg = torch.where(same, torch.minimum(hi_j, a_i + a_j - lo_i),
                         torch.minimum(hi_j, hi_i + a_j - a_i))
    a_j_new = torch.minimum(torch.maximum(a_j_new, lo_seg), hi_seg)
    a_i_new = a_i + y_i * y_j * (a_j - a_j_new)

    snap_i = 1e-6 * (hi_i - lo_i)
    snap_j = 1e-6 * (hi_j - lo_j)
    a_j_new = torch.where(a_j_new < lo_j + snap_j, lo_j,
                          torch.where(a_j_new > hi_j - snap_j, hi_j, a_j_new))
    a_i_new = torch.where(a_i_new < lo_i + snap_i, lo_i,
                          torch.where(a_i_new > hi_i - snap_i, hi_i, a_i_new))
    return a_i_new, a_j_new


def _membership(alpha, y, lo, hi, eps):
    pos, neg = y > 0, y <= 0
    not_upper = alpha < hi - eps    # can increase
    not_lower = alpha > lo + eps    # can decrease
    in_up = (pos & not_upper) | (neg & not_lower)
    in_low = (pos & not_lower) | (neg & not_upper)
    return in_up, in_low, not_upper & not_lower


def _shrink_active(f, alpha, y, mask, b_up, b_low, lo, hi, cfg: SMOConfig):
    """Samples that may still join a violating pair (LIBSVM-style): a
    bound-pinned sample is frozen once its f lies beyond the current
    [b_up, b_low] corridor on its non-violating side (slack in units of
    tol); free samples are never frozen."""
    slack = cfg.shrink_slack * cfg.tol
    in_up, in_low, free = _membership(alpha, y, lo, hi, 1e-6 * (hi - lo))
    keep_up = in_up & (f <= b_low + slack)
    keep_low = in_low & (f >= b_up - slack)
    return mask & (free | keep_up | keep_low)


def _kkt_bounds(alpha, y, f, lo, hi, tol: float = 0.0, mask=None):
    """(b_up, b_low) of ``kkt_violation``: float64 0-d tensors on
    ``alpha``'s device, +inf / -inf for empty sets."""
    f64 = torch.float64  # repro: noqa[R002] -- kkt_violation's bounds: the float64 certificate itself
    dev = alpha.device if isinstance(alpha, torch.Tensor) else "cpu"

    def cast(v, dtype=f64):  # tensors move; anything else is copied in
        if isinstance(v, torch.Tensor):
            return v.to(device=dev, dtype=dtype)
        return torch.tensor(v, dtype=dtype, device=dev)

    alpha, f, y = cast(alpha), cast(f), cast(y)
    lo = cast(lo).broadcast_to(alpha.shape)
    hi = cast(hi).broadcast_to(alpha.shape)
    mask = (torch.ones(alpha.shape, dtype=torch.bool, device=dev)
            if mask is None else cast(mask, torch.bool))
    in_up, in_low, _ = _membership(alpha, y, lo, hi,
                                   max(1e-6, tol) * (hi - lo))
    return (torch.min(torch.where(mask & in_up, f, torch.inf)),
            torch.max(torch.where(mask & in_low, f, -torch.inf)))


def kkt_violation(alpha, y, f, lo, hi, tol: float = 0.0, mask=None,
                  r=None) -> torch.Tensor:
    """Max per-sample KKT violation of the box QP at ``alpha``, in
    float64 — the solver-independent optimality certificate.

    ``f`` is the optimality vector y_i ((Q alpha)_i + p_i); recompute it
    from scratch to certify a solver rather than trust its bookkeeping.
    Returns min_r max_i [(r - f_i)_+ on I_up, (f_i - r)_+ on I_low]
    == max(0, (b_low - b_up) / 2), or with ``r`` given the violation at
    that pinned multiplier. ``tol`` loosens the bound-membership epsilon
    (as a fraction of the box width); 0 keeps the solver's 1e-6 rule.
    A 0-d float64 tensor on ``alpha``'s device."""
    b_up, b_low = _kkt_bounds(alpha, y, f, lo, hi, tol, mask)
    zero = torch.zeros((), dtype=torch.float64, device=b_up.device)
    if r is None:
        return torch.maximum(zero, (b_low - b_up) / 2.0)
    return torch.maximum(zero, torch.maximum(r - b_up, b_low - r))


def _smo_iteration(st: _State, *, y, mask, lo, hi, engine, cfg: SMOConfig,
                   diag=None, shrink: bool = False, live=None) -> None:
    """One working-set pair update + f-cache refresh, in place on ``st``:
    every field is written into its buffer and never rebound, so that a
    CUDA graph of a block of iterations replays on the solve's state.

    selection="first": maximal violating pair (the paper's GPU solver).
    selection="second" (WSS2, Fan et al. 2005): i = argmin_{I_up} f,
    then j maximizes the guaranteed gain (f_j - f_i)^2 / (2 eta_ij) over
    I_low.

    The same code steps one problem ((n,) state, 0-d pair) or a bucket
    of T problems ((T, n) state, (T,) pairs, ``engine`` a
    ``TaskKernelEngine``): every stage is elementwise or gathers along
    the last axis, so each task steps exactly as it would alone.
    ``live`` (T,) freezes finished tasks, as a vmapped while loop keeps
    a finished lane.
    """
    alpha, f = st.alpha, st.f
    sel_mask = (mask & st.active) if shrink else mask
    b_up, i_up, b_low, i_low = _selection(f, alpha, y, sel_mask, lo, hi)
    step_live = b_low > b_up + 2.0 * cfg.tol  # not yet converged
    if live is not None:
        step_live = step_live & live

    j = i_up
    row_j, cache = engine.row(j, st.cache)
    if cache is not st.cache:
        raise TypeError(f"{type(engine).__name__}.row returned a new row "
                        "cache: an engine updates its cache in place")
    k_jj = _gather(row_j, j)

    if cfg.selection == "second":
        _, in_low, _ = _membership(alpha, y, lo, hi, 1e-6 * (hi - lo))
        eta_all = torch.clamp_min(diag + k_jj.unsqueeze(-1) - 2.0 * row_j,
                                  1e-12)
        df = f - b_up.unsqueeze(-1)
        gain = torch.where(sel_mask & in_low & (df > 0.0), df * df / eta_all,
                           -torch.inf)
        i = torch.argmax(gain, dim=-1)
    else:
        i = i_low

    ij = torch.stack([i, j], dim=-1)
    y_i, y_j = y.gather(-1, ij).unbind(-1)
    a_i, a_j = alpha.gather(-1, ij).unbind(-1)
    f_i, f_j = f.gather(-1, ij).unbind(-1)
    lo_i, lo_j = lo.gather(-1, ij).unbind(-1)
    hi_i, hi_j = hi.gather(-1, ij).unbind(-1)

    row_i, _ = engine.row(i, cache)
    k_ii = _gather(row_i, i)
    k_ij = _gather(row_i, j)
    a_i_new, a_j_new = _pair_update(a_i, a_j, y_i, y_j, f_i, f_j,
                                    k_ii, k_jj, k_ij, lo_i, hi_i, lo_j, hi_j)

    d_i = torch.where(step_live, a_i_new - a_i, 0.0)
    d_j = torch.where(step_live, a_j_new - a_j, 0.0)

    alpha.scatter_add_(-1, i.unsqueeze(-1), d_i.unsqueeze(-1))
    alpha.scatter_add_(-1, j.unsqueeze(-1), d_j.unsqueeze(-1))
    # the "one thread per sample" stage. The float association
    # (f + d_i y_i row_i) + d_j y_j row_j, left to right, is the
    # reference's and is load-bearing (see its NOTE): keep it. XLA
    # compiles its multiply-adds into FMAs — fma(c_j, row_j, fma(c_i,
    # row_i, f)), and for the shrinking update fma(c_i, row_i, c_j row_j)
    # — and addcmul is the same fused multiply-add, so the two packages
    # round alike and follow the same SMO trajectory. Each result is
    # written into f's buffer by ``out=`` (the kernel's own store: the
    # bits of the out-of-place call).
    c_i, c_j = (d_i * y_i).unsqueeze(-1), (d_j * y_j).unsqueeze(-1)
    if shrink:
        upd = torch.addcmul(c_j * row_j, row_i, c_i)
        torch.where(st.active, f + upd, f, out=f)
    else:
        torch.addcmul(torch.addcmul(f, row_i, c_i), row_j, c_j, out=f)
    st.n_iter.add_(step_live.to(torch.int64))
    st.b_up.copy_(b_up)
    st.b_low.copy_(b_low)


def _certified(eng, alpha, y, p, lo, hi, mask, tol: float):
    """(certified, f) at a converged check of an unshrunk solve: f
    recomputed by one matvec, and whether its float64 KKT violation is
    <= tol. The float32 f cache drifts from the exact gradient over many
    updates, so the solver stops only on a certified state, and then on
    its cached f (a state that certifies at once is the reference's bit
    for bit); else it goes on from the recomputed f. A state whose f was
    just recomputed and took no step since stops as it is."""
    f = eng.matvec(alpha * y) + y * p
    return float(kkt_violation(alpha, y, f, lo, hi, mask=mask)) <= tol, f


# what the solves' CUDA graphs cost, summed over the process: captures,
# seconds issuing and instantiating them, replays (a caller reads the
# difference of two copies)
graph_stats = {"captures": 0, "capture_s": 0.0, "instantiate_s": 0.0,
               "replays": 0}
_stats_lock = threading.Lock()


class _Block:
    """One check block of a solve: ``iters`` calls of ``step``, a closure
    over the solve's state buffers that steps them in place.

    On the CPU, or with ``CUDA_GRAPHS`` off, every call issues the block
    eagerly. On the card the first call is eager too: it resolves the
    launch plans and builds the kernel library, and a solve that stops
    after it captures nothing (the cascade makes many such solves). The
    second call captures one block as a CUDA graph, and it and every
    later call replays it: one launch a block where the eager block
    issues ~80 kernels an iteration. A graph is exactly one block, since
    ``max_iter`` and ``shrink_every`` count checks; the host still reads
    one pair of numbers a block, and the certificate and the shrink /
    un-shrink passes run eagerly between replays.

    The capture goes through ``torch.cuda.CUDAGraph`` on a side stream of
    its own, not through ``torch.cuda.graph``, whose context synchronizes
    the card, runs the garbage collector and empties the allocator's
    cache at every capture; the graph's temporaries come from its private
    pool, freed with the graph when the solve returns. The kernels'
    per-stream scratch (``kkt_select``'s keys and tickets, the cached row
    entry's ticket) is made and zeroed on the capture stream before the
    capture, and the graph keeps it alive. A capture, instantiation or
    replay that fails raises; nothing falls back to the eager loop.
    ``ops.launches`` counts each replay as the launches of the captured
    block, so a graphed solve counts what the eager one does."""

    def __init__(self, step: Callable[[], None], iters: int,
                 device: torch.device, solver: str, *, n: int, tasks: int):
        self.step, self.iters, self.device = step, iters, device
        self.solver, self.n, self.tasks = solver, n, tasks
        self.graphed = device.type == "cuda" and CUDA_GRAPHS
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.calls = 0
        self.launches: dict = {}
        self._keep: tuple = ()

    def __call__(self) -> None:
        self.calls += 1
        if not self.graphed or self.calls == 1:
            for _ in range(self.iters):
                self.step()
            return
        if self.graph is None:
            self._capture()
        self.graph.replay()
        ops.add_launches(self.launches)
        with _stats_lock:
            graph_stats["replays"] += 1

    def _capture(self) -> None:
        dev = self.device
        side, caller = ops.capture_stream(dev), torch.cuda.current_stream(dev)
        side.wait_stream(caller)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side), ops.captured_launches() as launches:
            self._keep = ops.block_scratch(dev, n=self.n, tasks=self.tasks)
            t0 = time.perf_counter()
            with compile_guard.capture_label(self.solver):
                graph.capture_begin(capture_error_mode="global")
            try:
                for _ in range(self.iters):
                    self.step()
            except BaseException:
                # end the broken capture, then raise what broke it
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()
                raise
            t1 = time.perf_counter()
            graph.capture_end()    # instantiates the graph
            t2 = time.perf_counter()
        caller.wait_stream(side)
        self.launches = launches
        self.graph = graph
        with _stats_lock:
            graph_stats["captures"] += 1
            graph_stats["capture_s"] += t1 - t0
            graph_stats["instantiate_s"] += t2 - t1


def _start(alpha0, lo, hi, mask) -> torch.Tensor:
    """A warm start clipped to the box, entries within the solver's
    bound band (1e-6 of the box width, the band a pair update snaps its
    variables from) moved onto the bound, masked entries zeroed. Selection
    (float32) counts an entry at float32(hi - 1e-6 (hi - lo)) as at the
    bound, while the float64 ``kkt_violation`` counts it as free; a
    start left there would never move and never certify (the cascade's
    equality repair, draining a merged start's largest entries by a
    rounding-scale residue, lands on it)."""
    a = torch.minimum(torch.maximum(alpha0, lo), hi)
    band = 1e-6 * (hi - lo)
    a = torch.where(a <= lo + band, lo, torch.where(a >= hi - band, hi, a))
    return a * mask


def _resolve_engine(x, kernel, engine) -> KE.KernelEngine:
    if isinstance(engine, KE.KernelEngine):
        return engine
    return KE.make_engine(x, kernel, "dense" if engine is None else engine)


def _vec(v, n: int, dev) -> torch.Tensor:
    return (torch.as_tensor(v, dtype=torch.float32, device=dev)
            .broadcast_to((n,)).contiguous())


def solve_qp(x: torch.Tensor,
             y: torch.Tensor,
             p: torch.Tensor,
             lo: torch.Tensor | float,
             hi: torch.Tensor | float,
             mask: Optional[torch.Tensor] = None,
             *,
             cfg: SMOConfig = SMOConfig(),
             kernel: K.KernelParams = K.KernelParams(),
             engine: Optional[KE.KernelEngine | KE.EngineConfig | str] = None,
             alpha0: Optional[torch.Tensor] = None) -> SMOResult:
    """Solve the general box-constrained dual QP with parallel SMO on
    ``x``'s device (see the module docstring).

    Args:
      x: (n, d) float training samples.
      y: (n,) sign vector in {+1, -1} (0 marks padding).
      p: (n,) linear term of the QP.
      lo / hi: box bounds, scalar or (n,); 0 must lie inside the box.
      mask: (n,) bool validity mask — masked entries are never selected
        and keep alpha = 0.
      engine: a bound ``KernelEngine``, an ``EngineConfig``, or a backend
        name; None is the dense backend (the reference's default).
      alpha0: (n,) warm-start multipliers, clipped to the box, snapped
        onto a bound within 1e-6 of the box width of it (``_start``) and
        zeroed on masked entries; the f-cache is rebuilt with one
        matvec. The caller keeps ``sum_i y_i alpha0_i`` ~ 0.
    """
    if cfg.selection not in ("first", "second"):
        raise ValueError(f"unknown selection {cfg.selection!r}; expected "
                         "'first' or 'second'")
    dev = x.device
    n = x.shape[0]
    x = x.to(torch.float32)
    y = y.to(device=dev, dtype=torch.float32).contiguous()
    p = _vec(p, n, dev)
    lo = _vec(lo, n, dev)
    hi = _vec(hi, n, dev)
    # the solver starts at alpha = 0, which must be inside the box
    if bool(torch.any((lo > 0.0) | (hi < 0.0))):
        raise ValueError(
            "solve_qp initializes alpha = 0, which must be feasible: "
            "need lo <= 0 <= hi elementwise (shift the variables to "
            "move the box)")
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=dev)
    mask = (mask.to(dev) & (torch.abs(y) > 0.5)).contiguous()

    eng = _resolve_engine(x, kernel, engine)
    shrink = cfg.shrink_every > 0

    if alpha0 is None:
        a0 = torch.zeros((n,), dtype=torch.float32, device=dev)
        f0 = y * p  # alpha = 0  =>  f_i = y_i p_i (classification: -y_i)
    else:
        a0 = _start(torch.as_tensor(alpha0, dtype=torch.float32,
                                    device=dev), lo, hi, mask)
        f0 = eng.matvec(a0 * y) + y * p
    # the state's buffers, each allocated here once and written in place
    # from now on (the captured block replays on them)
    st = _State(alpha=a0.contiguous(), f=f0.contiguous(),
                n_iter=torch.zeros((), dtype=torch.int64, device=dev),
                b_up=torch.tensor(-1.0, device=dev),
                b_low=torch.tensor(1.0, device=dev),
                active=mask.clone(), cache=eng.init_cache())
    diag = eng.diag() if cfg.selection == "second" else None
    two_tol = 2.0 * cfg.tol

    def step():
        _smo_iteration(st, y=y, mask=mask, lo=lo, hi=hi, engine=eng,
                       cfg=cfg, diag=diag, shrink=shrink)

    # paper Fig. 3: `check_every` device iterations between checks
    block = _Block(step, cfg.check_every, dev, "solve_qp", n=n, tasks=1)
    done, n_iter, checks = False, 0, 0
    exact_at = -1   # n_iter at which st.f was last recomputed
    while not done and n_iter < cfg.max_iter:
        block()
        conv_active = st.b_low <= st.b_up + two_tol
        conv, n_iter = torch.stack([conv_active.to(torch.int64),
                                    st.n_iter]).tolist()  # repro: noqa[R001] -- the one read a check block
        if not shrink:
            if conv and n_iter != exact_at:
                ok, f_exact = _certified(eng, st.alpha, y, p, lo, hi, mask,
                                         cfg.tol)
                if not ok:
                    st.f.copy_(f_exact)
                    exact_at, conv = n_iter, False
            done = bool(conv)
            continue
        checks += 1
        if conv:
            # exact gradient for ALL samples, then the un-shrunk KKT
            # re-check; resume on the full set if it does not survive
            st.f.copy_(eng.matvec(st.alpha * y) + y * p)
            b_up, _, b_low, _ = _selection(st.f, st.alpha, y, mask, lo, hi)
            st.b_up.copy_(b_up)
            st.b_low.copy_(b_low)
            st.active.copy_(mask)
            done = bool(st.b_low <= st.b_up + two_tol)  # repro: noqa[R001] -- once a converged check: the un-shrunk gap decides the stop
        elif checks % cfg.shrink_every == 0:
            st.active &= _shrink_active(st.f, st.alpha, y, mask, st.b_up,
                                        st.b_low, lo, hi, cfg)

    # final selection for the reported gap / bias, on the UN-shrunk set
    f_final = eng.matvec(st.alpha * y) + y * p if shrink else st.f
    b_up, _, b_low, _ = _selection(f_final, st.alpha, y, mask, lo, hi)
    return SMOResult(alpha=st.alpha * mask, b=-(b_up + b_low) / 2.0,
                     n_iter=st.n_iter,
                     converged=b_low <= b_up + two_tol, gap=b_low - b_up,
                     n_active=torch.sum(st.active & mask))


def _classification_spec(y: torch.Tensor, c: float):
    """(p, lo, hi) of the soft-margin classification dual: p = -1 over
    the box [0, C]."""
    n, dev = y.shape[0], y.device
    return (torch.full((n,), -1.0, device=dev),
            torch.zeros((n,), device=dev),
            torch.full((n,), float(c), device=dev))


def binary_smo(x: torch.Tensor,
               y: torch.Tensor,
               mask: Optional[torch.Tensor] = None,
               *,
               cfg: SMOConfig = SMOConfig(),
               kernel: K.KernelParams = K.KernelParams(),
               engine: Optional[KE.KernelEngine | KE.EngineConfig | str] = None,
               alpha0: Optional[torch.Tensor] = None) -> SMOResult:
    """Solve one binary soft-margin SVM dual with parallel SMO — the
    classification instance of ``solve_qp``, on ``x``'s device.
    ``y`` holds labels in {+1, -1}."""
    y = y.to(device=x.device, dtype=torch.float32)
    p, lo, hi = _classification_spec(y, cfg.C)
    return solve_qp(x, y, p, lo, hi, mask, cfg=cfg, kernel=kernel,
                    engine=engine, alpha0=alpha0)


def solve_qp_tasks(x: torch.Tensor,
                   y: torch.Tensor,
                   p: torch.Tensor | float,
                   lo: torch.Tensor | float,
                   hi: torch.Tensor | float,
                   mask: Optional[torch.Tensor] = None,
                   *,
                   cfg: SMOConfig = SMOConfig(),
                   kernel: K.KernelParams = K.KernelParams(),
                   engine: Optional[KE.TaskKernelEngine | KE.EngineConfig
                                    | str] = None,
                   alpha0: Optional[torch.Tensor] = None) -> SMOResult:
    """Solve the T box QPs of one multiclass bucket together: one
    batched SMO, where the reference vmaps ``solve_qp`` over the bucket
    (``repro/core/dist.py``).

    ``x`` is (T, w, d); ``y``, ``p``, ``lo``, ``hi``, ``mask`` and
    ``alpha0`` are (T, w) (or broadcast to it). Every iteration is one
    selection launch and two row launches for the whole bucket (the
    task-axis ``kkt_select`` and ``rbf_gram`` row kernels under
    ``engine="pallas"``), and the host reads one flag per block of
    ``check_every`` iterations. Each task freezes once its own gap
    closes (and a recomputed f certifies it, as in ``solve_qp``) or its
    ``n_iter`` reaches ``max_iter`` at a check, as a vmapped while loop
    keeps a finished lane, so its alphas, b and n_iter are those of the
    same task solved alone by ``solve_qp``.
    Shrinking is forced off (the reference forces it off under vmap).
    Returns an ``SMOResult`` of (T, w) / (T,) tensors.
    """
    if cfg.selection not in ("first", "second"):
        raise ValueError(f"unknown selection {cfg.selection!r}; expected "
                         "'first' or 'second'")
    if x.ndim != 3:
        raise ValueError(f"solve_qp_tasks: x must be (T, w, d), got "
                         f"{tuple(x.shape)}")
    cfg = dataclasses.replace(cfg, shrink_every=0)
    dev = x.device
    shape = x.shape[:2]
    x = x.to(torch.float32)

    def vec(v):
        return (torch.as_tensor(v, dtype=torch.float32, device=dev)
                .broadcast_to(shape).contiguous())

    y, p, lo, hi = vec(y), vec(p), vec(lo), vec(hi)
    if bool(torch.any((lo > 0.0) | (hi < 0.0))):
        raise ValueError(
            "solve_qp_tasks initializes alpha = 0, which must be feasible: "
            "need lo <= 0 <= hi elementwise")
    if mask is None:
        mask = torch.ones(shape, dtype=torch.bool, device=dev)
    mask = (mask.to(dev) & (torch.abs(y) > 0.5)).contiguous()
    eng = (engine if isinstance(engine, KE.TaskKernelEngine)
           else KE.TaskKernelEngine(x, kernel,
                                    "dense" if engine is None else engine))

    if alpha0 is None:
        a0 = torch.zeros(shape, dtype=torch.float32, device=dev)
        f0 = y * p
    else:
        a0 = _start(vec(alpha0), lo, hi, mask)
        f0 = eng.matvec(a0 * y) + y * p
    n_tasks = shape[0]
    # the state's buffers, allocated once and written in place (as
    # solve_qp's); no shrinking, so ``active`` stays the mask
    st = _State(alpha=a0.contiguous(), f=f0.contiguous(),
                n_iter=torch.zeros((n_tasks,), dtype=torch.int64, device=dev),
                b_up=torch.full((n_tasks,), -1.0, device=dev),
                b_low=torch.full((n_tasks,), 1.0, device=dev),
                active=mask, cache=None)
    diag = eng.diag() if cfg.selection == "second" else None
    two_tol = 2.0 * cfg.tol

    frozen = st.n_iter >= cfg.max_iter
    live = ~frozen
    exact_at = torch.full((n_tasks,), -1, dtype=torch.int64, device=dev)

    def step():
        _smo_iteration(st, y=y, mask=mask, lo=lo, hi=hi, engine=eng,
                       cfg=cfg, diag=diag, live=live)

    block = _Block(step, cfg.check_every, dev, "solve_qp_tasks",
                   n=shape[1], tasks=n_tasks)
    all_frozen = bool(frozen.all())
    while not all_frozen:
        torch.logical_not(frozen, out=live)
        block()
        # as solve_qp: a task whose gap closes is certified on a
        # recomputed f before it freezes, else goes on from that f
        conv = live & (st.b_low <= st.b_up + two_tol)
        check = conv & (st.n_iter != exact_at)
        frozen |= conv | (st.n_iter >= cfg.max_iter)
        flags = torch.cat([check, frozen.all().reshape(1)]).tolist()  # repro: noqa[R001] -- the one read a check block
        all_frozen = bool(flags[-1])
        failed = []
        for t in (t for t, c in enumerate(flags[:-1]) if c):
            ok, f_t = _certified(eng.tasks[t], st.alpha[t], y[t], p[t],
                                 lo[t], hi[t], mask[t], cfg.tol)
            if not ok:
                st.f[t] = f_t
                failed.append(t)
        if failed:
            ids = torch.tensor(failed, device=dev)
            exact_at[ids] = st.n_iter[ids]
            frozen[ids] = st.n_iter[ids] >= cfg.max_iter
            all_frozen = bool(frozen.all())  # repro: noqa[R001] -- once a block whose certificate failed: the refrozen tasks decide the stop

    b_up, _, b_low, _ = _selection(st.f, st.alpha, y, mask, lo, hi)
    return SMOResult(alpha=st.alpha * mask, b=-(b_up + b_low) / 2.0,
                     n_iter=st.n_iter,
                     converged=b_low <= b_up + two_tol, gap=b_low - b_up,
                     n_active=torch.sum(mask, dim=-1))


def binary_smo_tasks(x: torch.Tensor,
                     y: torch.Tensor,
                     mask: Optional[torch.Tensor] = None,
                     *,
                     cfg: SMOConfig = SMOConfig(),
                     kernel: K.KernelParams = K.KernelParams(),
                     engine: Optional[KE.TaskKernelEngine | KE.EngineConfig
                                      | str] = None,
                     alpha0: Optional[torch.Tensor] = None) -> SMOResult:
    """T binary soft-margin duals (x (T, w, d), labels y (T, w) in
    {+1, -1}, 0 on padding) solved together by ``solve_qp_tasks``:
    p = -1 over the box [0, C]."""
    y = y.to(device=x.device, dtype=torch.float32)
    return solve_qp_tasks(x, y, -1.0, 0.0, float(cfg.C), mask, cfg=cfg,
                          kernel=kernel, engine=engine, alpha0=alpha0)


def _svr_spec(y: torch.Tensor, epsilon: float, c: float):
    """Doubled-variable epsilon-SVR spec over [x; x]: beta = [alpha;
    alpha*], signs s = [+1; -1], p = [eps - y; eps + y], box [0, C].
    The combined regression coefficient is alpha - alpha*."""
    n, dev = y.shape[0], y.device
    s = torch.cat([torch.ones((n,), device=dev),
                   -torch.ones((n,), device=dev)])
    p = torch.cat([epsilon - y, epsilon + y])
    return (s, p, torch.zeros((2 * n,), device=dev),
            torch.full((2 * n,), float(c), device=dev))


class SVRResult(NamedTuple):
    beta: torch.Tensor       # (n,) alpha - alpha*: K(x_i, .) coefficients
    b: torch.Tensor          # () bias, prediction = sum beta_i K(x_i,.) + b
    alpha: torch.Tensor      # (2n,) raw doubled multipliers [alpha; alpha*]
    n_iter: torch.Tensor
    converged: torch.Tensor
    gap: torch.Tensor
    n_active: torch.Tensor


def _svr_result(r: SMOResult, n: int) -> SVRResult:
    return SVRResult(beta=r.alpha[:n] - r.alpha[n:], b=r.b, alpha=r.alpha,
                     n_iter=r.n_iter, converged=r.converged, gap=r.gap,
                     n_active=r.n_active)


def svr_smo(x: torch.Tensor,
            y: torch.Tensor,
            mask: Optional[torch.Tensor] = None,
            *,
            epsilon: float = 0.1,
            cfg: SMOConfig = SMOConfig(),
            kernel: K.KernelParams = K.KernelParams(),
            engine: Optional[KE.EngineConfig | str] = None,
            alpha0: Optional[torch.Tensor] = None) -> SVRResult:
    """Solve one epsilon-SVR dual with SMO on ``x``'s device: the
    doubled-variable instance of ``solve_qp`` over [x; x].

    Args:
      x: (n, d) float training samples.
      y: (n,) real-valued targets.
      mask: (n,) bool validity mask, doubled internally.
      epsilon: half-width of the insensitive tube.
      engine: an ``EngineConfig`` or backend name; the engine is built on
        the DOUBLED (2n, d) sample matrix, so a pre-bound (n-row)
        ``KernelEngine`` is rejected.
      alpha0: (2n,) raw doubled warm-start multipliers [alpha; alpha*]
        (the layout of ``SVRResult.alpha``).
    """
    if isinstance(engine, KE.KernelEngine):
        raise ValueError(
            "svr_smo solves the doubled 2n-variable QP and must build its "
            "engine on [x; x]; pass an EngineConfig or backend name, not "
            f"a bound engine ({type(engine).__name__})")
    n = x.shape[0]
    x = x.to(torch.float32)
    y = torch.as_tensor(y, dtype=torch.float32, device=x.device)
    s, p, lo, hi = _svr_spec(y, epsilon, cfg.C)
    m2 = None if mask is None else torch.cat([mask, mask])
    r = solve_qp(torch.cat([x, x], dim=0), s, p, lo, hi, m2, cfg=cfg,
                 kernel=kernel, engine=engine, alpha0=alpha0)
    return _svr_result(r, n)


# --------------------------------------------------------------------------
# Sharded single-problem SMO: data-parallel over the SAMPLE axis, after
# repro/core/smo.py's shard_map solver, as an SPMD program over a mesh:
#
#   per-rank block-reduce   ->  kkt_select on the rank's own samples
#   MPI_Allreduce           ->  one all_reduce SUM of a zero-filled (P, 4)
#                               float64 buffer, each rank writing its
#                               (value, GLOBAL index) pairs, then the same
#                               combine_selection on every rank
#   Gram row block          ->  ShardedKernelEngine.row (the rbf_gram
#                               row-range entries over the full X)
#   scalar pair state       ->  one all_reduce SUM of owner-masked picks
#
# The combine keeps FIRST-OCCURRENCE argmin / argmax semantics (blocks
# are contiguous, in rank order), every rank's row entries are the bits
# of the whole row, and the f update keeps its addcmul association, so
# the trajectory is the unsharded solve_qp's bit for bit.
# --------------------------------------------------------------------------
def combine_selection(b_up_shards, i_up_shards, b_low_shards, i_low_shards):
    """Cross-rank working-set reduction: per-rank extrema with GLOBAL
    indices, in rank order, -> the global (b_up, i_up, b_low, i_low).

    ``argmin`` over the per-rank minima picks the FIRST rank attaining
    the global minimum, and that rank's local argmin its first attainer,
    so the index is the first global attainer — the unsharded
    selection's tie-break (and symmetrically on the max side); an
    all-masked input gives (+inf, 0, -inf, 0), as ``kkt_select`` does.
    0-d tensors, on the device (no host read)."""
    s = torch.argmin(b_up_shards)
    t = torch.argmax(b_low_shards)
    return (KE.take(b_up_shards, s), KE.take(i_up_shards, s),
            KE.take(b_low_shards, t), KE.take(i_low_shards, t))


def _sharded_selection(f, alpha, y, mask, lo, hi, eng: KE.ShardedKernelEngine):
    """Globally exact working-set selection from this rank's (n_local,)
    block: the local ``kkt_select``, ONE all_reduce of the packed
    (value, global index) pairs (float64 holds both exactly) and the
    replicated ``combine_selection``; returns GLOBAL indices."""
    b_up, i_up, b_low, i_low = _selection(f, alpha, y, mask, lo, hi)
    f64 = torch.float64  # repro: noqa[R002] -- exact carrier of float32 values and int indices through one all_reduce
    buf = torch.zeros((eng.n_shards, 4), dtype=f64, device=f.device)
    buf[eng.mesh.rank] = torch.stack([
        b_up.to(f64), (i_up + eng.row0).to(f64),
        b_low.to(f64), (i_low + eng.row0).to(f64)])
    vu, iu, vl, il = eng.mesh.all_reduce(buf).unbind(1)
    b_up, i_up, b_low, i_low = combine_selection(vu, iu, vl, il)
    return (b_up.to(torch.float32), i_up.to(torch.int64),
            b_low.to(torch.float32), i_low.to(torch.int64))


def _owned(g: torch.Tensor, eng: KE.ShardedKernelEngine):
    """(local index, owned?) of GLOBAL indices ``g``: the index clamped
    into this rank's block, and whether the rank owns it."""
    local = g - eng.row0
    return (torch.clamp(local, 0, eng.n - 1),
            (local >= 0) & (local < eng.n))


def _pick_sum(vals: torch.Tensor, own: torch.Tensor,
              eng: KE.ShardedKernelEngine) -> torch.Tensor:
    """Owner-masked picks summed over the ranks (ONE all_reduce): each
    entry comes from the rank that owns it, every other adds 0."""
    return eng.mesh.all_reduce(torch.where(own, vals, 0.0))


# the picks of a pair (i, j): f, alpha, y, lo, hi at (i, j), row_i at
# (i, j) and, first-order, row_j at j
_PAIR = torch.tensor([0, 1] * 6 + [1])


def _sharded_iteration(st: _State, *, y, mask, lo, hi,
                       engine: KE.ShardedKernelEngine, cfg: SMOConfig,
                       diag=None, shrink: bool = False) -> None:
    """``_smo_iteration`` on this rank's block, in place on ``st``. Its
    collectives: the selection, the pair's 12 scalars and K(x_j, x_j) in
    one all_reduce, and with ``selection="second"`` K(x_j, x_j) before the
    gain and the gain's combine (two more)."""
    eng = engine
    alpha, f = st.alpha, st.f
    sel_mask = (mask & st.active) if shrink else mask
    b_up, i_up, b_low, i_low = _sharded_selection(f, alpha, y, sel_mask,
                                                  lo, hi, eng)
    step_live = b_low > b_up + 2.0 * cfg.tol

    j = i_up  # global
    row_j, cache = eng.row(j, st.cache)
    lj, own_j = _owned(j.reshape(1), eng)
    if cfg.selection == "second":
        k_jj = _pick_sum(row_j.gather(0, lj), own_j, eng)[0]
        _, in_low, _ = _membership(alpha, y, lo, hi, 1e-6 * (hi - lo))
        eta_all = torch.clamp_min(diag + k_jj.unsqueeze(-1) - 2.0 * row_j,
                                  1e-12)
        df = f - b_up.unsqueeze(-1)
        gain = torch.where(sel_mask & in_low & (df > 0.0), df * df / eta_all,
                           -torch.inf)
        li = torch.argmax(gain)
        f64 = torch.float64  # repro: noqa[R002] -- exact carrier of a float32 gain and an int index through one all_reduce
        buf = torch.zeros((eng.n_shards, 2), dtype=f64, device=f.device)
        buf[eng.mesh.rank] = torch.stack([KE.take(gain, li).to(f64),
                                          (li + eng.row0).to(f64)])
        gv, gi = eng.mesh.all_reduce(buf).unbind(1)
        i = KE.take(gi, torch.argmax(gv)).to(torch.int64)
    else:
        i = i_low

    row_i, cache = eng.row(i, cache)
    ij = torch.stack([i, j])
    lij, own = _owned(ij, eng)
    vals = [v.gather(0, lij) for v in (f, alpha, y, lo, hi, row_i)]
    pair = _PAIR.to(f.device)
    if cfg.selection == "second":
        pair = pair[:-1]
    else:
        vals.append(row_j.gather(0, lj))
    picks = _pick_sum(torch.cat(vals), own.index_select(0, pair), eng)
    f_i, f_j, a_i, a_j, y_i, y_j, lo_i, lo_j, hi_i, hi_j, k_ii, k_ij = \
        picks[:12].unbind(0)
    if cfg.selection != "second":
        k_jj = picks[12]
    a_i_new, a_j_new = _pair_update(a_i, a_j, y_i, y_j, f_i, f_j,
                                    k_ii, k_jj, k_ij, lo_i, hi_i, lo_j, hi_j)

    d_i = torch.where(step_live, a_i_new - a_i, 0.0)
    d_j = torch.where(step_live, a_j_new - a_j, 0.0)
    # the owner adds the step; every other rank adds 0 at some entry
    dij = torch.where(own, torch.stack([d_i, d_j]), 0.0)
    alpha.scatter_add_(0, lij[:1], dij[:1])
    alpha.scatter_add_(0, lij[1:], dij[1:])
    # the f update on this rank's samples, associated as _smo_iteration's
    c_i, c_j = (d_i * y_i).unsqueeze(-1), (d_j * y_j).unsqueeze(-1)
    if shrink:
        upd = torch.addcmul(c_j * row_j, row_i, c_i)
        st.f = torch.where(st.active, f + upd, f)
    else:
        st.f = torch.addcmul(torch.addcmul(f, row_i, c_i), row_j, c_j)
    st.n_iter = st.n_iter + step_live.to(torch.int64)
    st.b_up, st.b_low, st.cache = b_up, b_low, cache


def _sharded_certified(eng: KE.ShardedKernelEngine, alpha, y, p, lo, hi,
                       mask, tol: float):
    """``_certified`` over the mesh: f recomputed by one sharded matvec,
    the float64 ``kkt_violation`` from each rank's (b_up, b_low) under one
    all_reduce MIN of (b_up, -b_low) — the unsharded value exactly."""
    f = eng.matvec(alpha * y) + y * p
    b_up, b_low = _kkt_bounds(alpha, y, f, lo, hi, mask=mask)
    bounds = eng.mesh.all_reduce(torch.stack([b_up, -b_low]), "min")
    viol = torch.clamp_min((-bounds[1] - bounds[0]) / 2.0, 0.0)
    return float(viol) <= tol, f


def _resolve_sharded_cfg(engine, axis: str) -> KE.EngineConfig:
    """The sharded engine's config: the caller's knobs (cache_slots,
    chunk, gram_dtype) with the backend set to "sharded" over ``axis``."""
    if engine is None:
        return KE.EngineConfig(backend="sharded", shard_axis=axis)
    if isinstance(engine, str):
        engine = KE.EngineConfig(backend=engine)
    if isinstance(engine, KE.EngineConfig):
        return dataclasses.replace(engine, backend="sharded",
                                   shard_axis=axis)
    raise ValueError(
        "sharded_binary_smo builds its engine on every rank; pass an "
        "EngineConfig or backend name, not a bound engine "
        f"({type(engine).__name__})")


def sharded_solve_qp(x, y, p, lo, hi, mask=None, *,
                     mesh,
                     axis: str = "shards",
                     cfg: SMOConfig = SMOConfig(),
                     kernel: K.KernelParams = K.KernelParams(),
                     engine: Optional[KE.EngineConfig | str] = None
                     ) -> SMOResult:
    """Solve ONE box-constrained dual QP (``solve_qp``'s problem) with
    the sample axis sharded over the ``mesh.shape[axis]`` ranks — the
    paper's data-parallel MPI-CUDA solver. A collective call: every rank
    passes the same full inputs (numpy or tensors), computes on
    ``mesh.device`` and returns the same full ``SMOResult`` (alpha of
    length n, b, n_iter, converged, gap, n_active).

    n is zero-padded to P equal blocks (of whole 32-row chunks: see
    ``ShardedKernelEngine``); padded samples are masked and their alphas
    are 0. ``engine`` keeps its knobs
    (``cache_slots``, ``chunk``, ``gram_dtype``) and runs as the
    ``sharded`` backend. With an RBF or linear kernel the result equals
    ``solve_qp(..., engine=EngineConfig(backend="pallas", <same knobs>))``
    on the same device bit for bit: shrinking, ``selection="second"`` and
    the unshrunk solve's float64 certificate as there; a poly or sigmoid
    kernel's rows are computed over each rank's block by the plain Gram
    function, and its solve reaches the same optimum within tol. Host
    reads: one pair of numbers a ``check_every`` block on every rank
    (replicated values, so every rank takes the same branch).

    Every block runs eagerly: unlike ``solve_qp``'s, it is never captured
    as a CUDA graph. Its collectives cannot be: gloo stages each
    all_reduce through host memory, and NCCL, whose collectives a graph
    could hold, runs one rank where there is a single card."""
    if cfg.selection not in ("first", "second"):
        raise ValueError(f"unknown selection {cfg.selection!r}; expected "
                         "'first' or 'second'")
    if axis not in mesh.shape:
        raise ValueError(f"axis {axis!r} is not an axis of the mesh (mesh "
                         f"axes: {tuple(mesh.shape)})")
    ecfg = _resolve_sharded_cfg(engine, axis)
    dev = mesh.device
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    n = x.shape[0]
    y = _vec(y, n, dev)
    p, lo, hi = _vec(p, n, dev), _vec(lo, n, dev), _vec(hi, n, dev)
    if bool(torch.any((lo > 0.0) | (hi < 0.0))):  # see solve_qp
        raise ValueError(
            "sharded_solve_qp initializes alpha = 0, which must be "
            "feasible: need lo <= 0 <= hi elementwise")
    mask = (torch.ones((n,), dtype=torch.bool, device=dev) if mask is None
            else torch.as_tensor(mask, device=dev).to(torch.bool))
    mask = mask & (torch.abs(y) > 0.5)
    eng = KE.ShardedKernelEngine(x, kernel, ecfg, mesh=mesh)

    def local(v):   # this rank's block of the zero-padded vector
        pad = eng.n_shards * eng.n - n
        return torch.nn.functional.pad(v, (0, pad))[
            eng.row0:eng.row0 + eng.n].contiguous()

    y, p, lo, hi = local(y), local(p), local(lo), local(hi)
    mask = local(mask)
    shrink = cfg.shrink_every > 0
    st = _State(alpha=torch.zeros((eng.n,), dtype=torch.float32, device=dev),
                f=y * p,
                n_iter=torch.zeros((), dtype=torch.int64, device=dev),
                b_up=torch.tensor(-1.0, device=dev),
                b_low=torch.tensor(1.0, device=dev),
                active=mask, cache=eng.init_cache())
    diag = eng.diag() if cfg.selection == "second" else None
    two_tol = 2.0 * cfg.tol

    done, n_iter, checks = False, 0, 0
    exact_at = -1   # n_iter at which st.f was last recomputed
    while not done and n_iter < cfg.max_iter:
        for _ in range(cfg.check_every):
            _sharded_iteration(st, y=y, mask=mask, lo=lo, hi=hi, engine=eng,
                               cfg=cfg, diag=diag, shrink=shrink)
        conv_active = st.b_low <= st.b_up + two_tol
        conv, n_iter = torch.stack([conv_active.to(torch.int64),
                                    st.n_iter]).tolist()  # repro: noqa[R001] -- the one read a check block
        if not shrink:
            if conv and n_iter != exact_at:
                ok, f_exact = _sharded_certified(eng, st.alpha, y, p, lo, hi,
                                                 mask, cfg.tol)
                if not ok:
                    st.f, exact_at, conv = f_exact, n_iter, False
            done = bool(conv)
            continue
        checks += 1
        if conv:
            st.f = eng.matvec(st.alpha * y) + y * p
            st.b_up, _, st.b_low, _ = _sharded_selection(
                st.f, st.alpha, y, mask, lo, hi, eng)
            st.active = mask
            done = bool(st.b_low <= st.b_up + two_tol)  # repro: noqa[R001] -- once a converged check: the un-shrunk gap decides the stop
        elif checks % cfg.shrink_every == 0:
            st.active = _shrink_active(st.f, st.alpha, y, mask, st.b_up,
                                       st.b_low, lo, hi, cfg) & st.active

    f_final = eng.matvec(st.alpha * y) + y * p if shrink else st.f
    b_up, _, b_low, _ = _sharded_selection(f_final, st.alpha, y, mask, lo,
                                           hi, eng)
    n_active = eng.mesh.all_reduce(
        torch.sum(st.active & mask).reshape(1))[0]
    return SMOResult(alpha=eng.gather(st.alpha * mask), b=-(b_up + b_low) / 2.0,
                     n_iter=st.n_iter,
                     converged=b_low <= b_up + two_tol, gap=b_low - b_up,
                     n_active=n_active)


def sharded_binary_smo(x, y, mask=None, *,
                       mesh,
                       axis: str = "shards",
                       cfg: SMOConfig = SMOConfig(),
                       kernel: K.KernelParams = K.KernelParams(),
                       engine: Optional[KE.EngineConfig | str] = None
                       ) -> SMOResult:
    """Solve ONE binary SVM dual data-parallel over the mesh: the
    classification instance of ``sharded_solve_qp`` (a collective call;
    see there for the layout and the bit-for-bit guarantee)."""
    y = torch.as_tensor(y, dtype=torch.float32, device=mesh.device)
    p, lo, hi = _classification_spec(y, cfg.C)
    return sharded_solve_qp(x, y, p, lo, hi, mask, mesh=mesh, axis=axis,
                            cfg=cfg, kernel=kernel, engine=engine)


def sharded_svr_smo(x, y, mask=None, *,
                    epsilon: float = 0.1,
                    mesh,
                    axis: str = "shards",
                    cfg: SMOConfig = SMOConfig(),
                    kernel: K.KernelParams = K.KernelParams(),
                    engine: Optional[KE.EngineConfig | str] = None
                    ) -> SVRResult:
    """Solve ONE epsilon-SVR dual data-parallel over the mesh: the doubled
    2n-variable QP of ``svr_smo`` through ``sharded_solve_qp`` (the
    doubled axis is what gets sharded, so a sample's alpha and alpha* may
    lie on different ranks; the selection stays globally exact)."""
    dev = mesh.device
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    y = torch.as_tensor(y, dtype=torch.float32, device=dev)
    n = x.shape[0]
    s, p, lo, hi = _svr_spec(y, epsilon, cfg.C)
    m2 = None
    if mask is not None:
        mask = torch.as_tensor(mask, device=dev).to(torch.bool)
        m2 = torch.cat([mask, mask])
    r = sharded_solve_qp(torch.cat([x, x], dim=0), s, p, lo, hi, m2,
                         mesh=mesh, axis=axis, cfg=cfg, kernel=kernel,
                         engine=engine)
    return _svr_result(r, n)


def decision_function(x_train, y_train, alpha, b, x_test, *,
                      kernel: K.KernelParams = K.KernelParams(),
                      engine: Optional[KE.KernelEngine | KE.EngineConfig
                                       | str] = None) -> torch.Tensor:
    """f(z) = sum_i alpha_i y_i K(x_i, z) + b for each test row z: through
    ``engine.decide`` when an engine is given (the ``decision`` kernel
    for ``engine="pallas"``), else the full cross-Gram."""
    coef = alpha * y_train.to(torch.float32)
    if engine is not None:
        if not isinstance(engine, KE.KernelEngine):
            engine = KE.make_engine(x_train, kernel, engine)
        return engine.decide(x_test, coef, b)
    gram_fn = K.make_gram_fn(kernel)
    return gram_fn(x_test.to(torch.float32),
                   x_train.to(torch.float32)) @ coef + b


def dual_objective(y, alpha, gram) -> torch.Tensor:
    """W(alpha) = 1'a - 1/2 a' (yy' * K) a — maximized by the dual SVM."""
    ay = alpha * y
    return torch.sum(alpha) - 0.5 * ay @ (gram @ ay)


def qp_objective(alpha, y, p, gram) -> torch.Tensor:
    """W(a) = -(1/2 (ya)'K(ya) + p'a) — the maximized dual objective of
    the general box QP (``dual_objective`` is the p = -1 instance)."""
    ay = alpha * y
    return -(0.5 * ay @ (gram @ ay) + p @ alpha)
