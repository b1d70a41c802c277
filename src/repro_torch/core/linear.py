"""Linear-path dual coordinate descent — the O(n k) solver behind the
low-rank tier.

Mirrors ``repro/core/linear.py``. Once a kernel problem has an explicit
feature map ``Phi (n, k)`` (``repro_torch.core.approx``), the kernel QP
is a LINEAR SVM in feature space, solved by the LIBLINEAR dual
coordinate descent of Hsieh et al. (2008): sweep the dual variables in
a random order, and for each coordinate apply the box-clipped Newton
step

    beta_i <- clip(beta_i - g_i / Q_ii, lo_i, hi_i),
    g_i = y_i (phibar_i . w) + p_i,   w = PhiBar^T (y * beta)

keeping the primal image ``w`` up to date incrementally (O(k) per
coordinate). The bias is the augmented constant feature
``phibar_i = [phi_i, bias]``, which drops the equality constraint from
the dual: the no-offset box QP that ``smo.kkt_violation`` certifies
with the multiplier pinned at ``r = 0``.

Each epoch starts from an exact ``w = Phi^T (y beta)`` (a plain matmul:
it bounds the float32 drift of the incremental updates to one epoch),
draws its permutation from a ``torch.Generator`` seeded 0 on the
solve's device (so a refit is bit-identical on one card; the draws
cannot match ``jax.random``'s), and runs the whole sweep as one
``ops.dcd_epoch`` launch on the card — the reference compiles it into a
device loop, and a Python loop would issue launches per coordinate.
The host reads the epoch's max projected gradient once per epoch. That
maximum is taken coordinate by coordinate, each before the later
coordinates of the sweep moved, so ``viol <= tol / 2`` does not by
itself bound the returned state (on the H100, 2 of 36 Pavia OvO tasks
stopped by it at a certificate of 1.17e-3 > tol): once an epoch reaches
it, the solve also certifies the state it would return —
``smo.kkt_violation(..., r=0)`` of the exact gradient, in float64 — and
sweeps on unless that is <= tol. It stops there or after
``max_epochs``. The reference stops at the epoch rule alone; where its
state certifies (the common case) the two stop at the same epoch.

``dcd_qp_tasks`` / ``linear_svc_tasks`` solve T such problems over rows
of one shared Phi together (the tasks of a multiclass low-rank fit):
each epoch is one task-axis launch (``ops.dcd_epoch_tasks``) for the
tasks still sweeping, and each task keeps its own generator, exact w,
certificate and stopping epoch, so it ends exactly where its lone solve
does. ``dcd_qp`` is its one task over the whole Phi, which launches
``ops.dcd_epoch`` and gathers no rows.

``linear_svc`` is the hinge-loss dual (p = -1, box [0, C]);
``linear_svr`` solves the epsilon-insensitive dual as the doubled QP
over ``[Phi; Phi]`` with signs [+1; -1], as the kernel path does.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.core import smo
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class DCDConfig:
    """DCD solver config (same fields and defaults as the reference).

    C:          box constraint (upper bound of every dual variable).
    tol:        certificate tolerance: the solve stops once the max
                projected gradient over an epoch is <= tol / 2 and the
                returned state certifies ``kkt_violation(..., r=0) <=
                tol`` on an exact gradient.
    max_epochs: full passes over the n dual coordinates.
    bias:       augmented constant-feature value (the bias enters the
                model as ``bias * w_bias``); 0 disables the intercept.
    """

    C: float = 1.0
    tol: float = 1e-3
    max_epochs: int = 1000
    bias: float = 1.0


class DCDResult(NamedTuple):
    alpha: torch.Tensor      # (n,) dual variables at the box optimum
    w: torch.Tensor          # (k,) primal weights  Phi^T (y * alpha)
    b: torch.Tensor          # ()   intercept  bias * w_bias
    n_iter: torch.Tensor     # ()   epochs run
    converged: torch.Tensor  # ()   bool: viol <= tol/2 before max_epochs
    gap: torch.Tensor        # ()   last epoch's max projected gradient


def _vec(v, n: int, dev) -> torch.Tensor:
    return (torch.as_tensor(v, dtype=torch.float32, device=dev)
            .broadcast_to((n,)).contiguous())


class _Coords(NamedTuple):
    """One problem's per-coordinate vectors, on the solve's device."""
    y: torch.Tensor
    p: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    live: torch.Tensor
    q_diag: torch.Tensor   # Qbar_ii
    ys: torch.Tensor       # y, 0 on masked coordinates
    beta: torch.Tensor     # the starting point


def _coords(phi: torch.Tensor, y, p, lo, hi, mask, alpha0,
            bias: float) -> _Coords:
    dev = phi.device
    n = phi.shape[0]
    y = _vec(y, n, dev)
    p, lo, hi = _vec(p, n, dev), _vec(lo, n, dev), _vec(hi, n, dev)
    live = (torch.ones((n,), dtype=torch.bool, device=dev) if mask is None
            else torch.as_tensor(mask, device=dev).to(torch.bool)
            .contiguous())
    # per-coordinate curvature Qbar_ii (y_i^2 = 1); the floor guards an
    # all-zero feature row from a 0/0 Newton step
    q_diag = torch.clamp_min(torch.sum(phi * phi, dim=1) + bias * bias,
                             1e-12).contiguous()
    ys = torch.where(live, y, 0.0)
    if alpha0 is None:
        beta = torch.zeros((n,), dtype=torch.float32, device=dev)
    else:
        a0 = torch.as_tensor(alpha0, dtype=torch.float32, device=dev)
        beta = (torch.minimum(torch.maximum(a0, lo), hi) * live).contiguous()
    return _Coords(y, p, lo, hi, live, q_diag, ys, beta)


def _exact_w(phi: torch.Tensor, c: _Coords, beta: torch.Tensor):
    coef = c.ys * beta
    return phi.T @ coef, torch.sum(coef)


def _certified(phi, c: _Coords, beta, w, wsum, bias: float,
               tol: float) -> bool:
    f = phi @ w + bias * wsum + c.y * c.p    # y_i (Qbar beta + p)_i
    return float(smo.kkt_violation(beta, c.y, f, c.lo, c.hi, mask=c.live,
                                   r=0.0)) <= tol


def _perm(n: int, gen: torch.Generator, dev) -> torch.Tensor:
    # deterministic per-epoch shuffles (cyclic order couples badly with
    # the correlated columns of a low-rank Phi); a fixed seed keeps
    # refits bit-identical
    return torch.randperm(n, generator=gen, device=dev)


def _generator(dev) -> torch.Generator:
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    return gen


def dcd_qp(phi: torch.Tensor, y: torch.Tensor, p, lo, hi,
           mask: Optional[torch.Tensor] = None, *,
           cfg: DCDConfig = DCDConfig(),
           alpha0: Optional[torch.Tensor] = None) -> DCDResult:
    """Minimize ``1/2 beta^T Qbar beta + p^T beta`` over the box
    ``lo <= beta <= hi``, ``Qbar_ij = y_i y_j (phi_i . phi_j + bias^2)``,
    on ``phi``'s device. ``mask=False`` coordinates stay at their initial
    value (0) and are left out of the stopping rule. ``alpha0`` warm
    starts the sweep (clipped to the box, zeroed on masked
    coordinates); the augmented-bias dual has no equality constraint,
    so any box-feasible start is admissible. The one task of
    ``dcd_qp_tasks`` over every row of ``phi``."""
    return dcd_qp_tasks(phi, None, [y], p, lo, hi, [mask], cfg=cfg,
                        alpha0=[alpha0])[0]


def dcd_qp_tasks(phi: torch.Tensor, rows: Optional[Sequence],
                 y: Sequence, p, lo, hi, masks: Optional[Sequence] = None,
                 *, cfg: DCDConfig = DCDConfig(),
                 alpha0: Optional[Sequence] = None) -> list[DCDResult]:
    """T problems of ``dcd_qp`` over rows of one shared Phi, solved
    together: task t is ``dcd_qp(phi[rows[t]], y[t], p, lo, hi,
    masks[t], alpha0=alpha0[t])``, and each task's result is that
    solve's, bit for bit, whatever the other tasks. ``p``, ``lo`` and
    ``hi`` are values shared by every task, or vectors of a task's
    length when there is one. Each epoch is one ``ops.dcd_epoch_tasks``
    launch for the tasks still sweeping, a block each, reading Phi
    through the tasks' row indices; each task keeps its own generator
    (seeded 0, so it draws its lone solve's permutations), computes its
    exact w from its gathered rows as the lone solve does, and is
    certified and frozen at its own stopping epoch. The host reads the
    launched tasks' viols once an epoch. ``rows=None`` is one task over
    every row of ``phi``, swept by ``ops.dcd_epoch`` with no gather."""
    dev = phi.device
    phi = phi.to(torch.float32).contiguous()
    n, k = phi.shape
    whole = rows is None
    rows = ([None] if whole else
            [torch.as_tensor(r, device=dev).to(torch.int64) for r in rows])
    n_tasks = len(rows)
    bias = float(cfg.bias)
    stop = 0.5 * cfg.tol
    masks = [None] * n_tasks if masks is None else list(masks)
    alpha0 = [None] * n_tasks if alpha0 is None else list(alpha0)

    def task_phi(t):
        return phi if whole else phi.index_select(0, rows[t])

    coords = [_coords(task_phi(t), y[t], p, lo, hi, masks[t], alpha0[t],
                      bias) for t in range(n_tasks)]
    bounds = [0]
    for c in coords:
        bounds.append(bounds[-1] + c.y.shape[0])
    segs = [slice(bounds[t], bounds[t + 1]) for t in range(n_tasks)]

    def cat(field):
        return torch.cat([getattr(c, field) for c in coords]).contiguous()

    cy, cp, clo, chi, clive, cq, beta = (
        cat(f) for f in ("y", "p", "lo", "hi", "live", "q_diag", "beta"))
    if not whole:
        all_rows = torch.cat(rows).contiguous()
        offsets = torch.tensor(bounds, dtype=torch.int64, device=dev)
    perm = torch.empty((bounds[-1],), dtype=torch.int64, device=dev)
    w_all = torch.zeros((n_tasks, k), dtype=torch.float32, device=dev)
    wb_all = torch.zeros((n_tasks,), dtype=torch.float32, device=dev)
    gens = [_generator(dev) for _ in range(n_tasks)]
    n_ep = [0] * n_tasks
    viol = [float("inf")] * n_tasks
    done = [False] * n_tasks
    sweeping = list(range(n_tasks))
    while sweeping:
        launch = []
        for t in sweeping:
            if n_ep[t] >= cfg.max_epochs:
                continue
            phi_t, b_t = task_phi(t), beta[segs[t]]
            w, wsum = _exact_w(phi_t, coords[t], b_t)
            if viol[t] <= stop:
                done[t] = _certified(phi_t, coords[t], b_t, w, wsum, bias,
                                     cfg.tol)
                if done[t]:
                    continue
            w_all[t].copy_(w)
            wb_all[t].copy_(wsum)
            perm[segs[t]].copy_(_perm(coords[t].y.shape[0], gens[t], dev))
            launch.append(t)
        if not launch:
            got = []
        elif whole:
            got = [float(ops.dcd_epoch(phi, cy, cp, clo, chi, cq, clive,
                                       perm, beta, w_all[0], wb_all,
                                       bias=bias))]   # the one read
        else:
            got = ops.dcd_epoch_tasks(
                phi, all_rows, offsets, cy, cp, clo, chi, cq, clive, perm,
                beta, w_all, wb_all,
                tasks=torch.tensor(launch, dtype=torch.int64, device=dev),
                bias=bias).tolist()   # the one read
        for t, v in zip(launch, got):
            viol[t] = v
            n_ep[t] += 1
        sweeping = launch
    out = []
    for t in range(n_tasks):
        phi_t, b_t = task_phi(t), beta[segs[t]]
        b_t = b_t if whole else b_t.clone()
        w, wsum = _exact_w(phi_t, coords[t], b_t)
        if not done[t] and viol[t] <= stop:   # max_epochs ran out
            done[t] = _certified(phi_t, coords[t], b_t, w, wsum, bias,
                                 cfg.tol)
        out.append(DCDResult(alpha=b_t, w=w, b=bias * wsum,
                             n_iter=torch.tensor(n_ep[t]),
                             converged=torch.tensor(done[t]),
                             gap=torch.tensor(viol[t], dtype=torch.float32)))
    return out


def linear_svc(phi: torch.Tensor, y: torch.Tensor, *,
               cfg: DCDConfig = DCDConfig(),
               mask: Optional[torch.Tensor] = None,
               alpha0: Optional[torch.Tensor] = None) -> DCDResult:
    """Hinge-loss dual on explicit features: p = -1, box [0, C]. ``y``
    in {-1, +1}; decision f(z) = phi(z) . w + b."""
    n, dev = phi.shape[0], phi.device
    return dcd_qp(phi, y, torch.full((n,), -1.0, device=dev),
                  torch.zeros((n,), device=dev),
                  torch.full((n,), float(cfg.C), device=dev), mask, cfg=cfg,
                  alpha0=alpha0)


def linear_svc_tasks(phi: torch.Tensor, rows: Sequence, y: Sequence, *,
                     cfg: DCDConfig = DCDConfig(),
                     masks: Optional[Sequence] = None,
                     alpha0: Optional[Sequence] = None) -> list[DCDResult]:
    """``linear_svc`` of T tasks over rows of one shared Phi
    (``dcd_qp_tasks``): task t is ``linear_svc(phi[rows[t]], y[t])``,
    bit for bit."""
    return dcd_qp_tasks(phi, rows, y, -1.0, 0.0, float(cfg.C), masks,
                        cfg=cfg, alpha0=alpha0)


class LinearSVRResult(NamedTuple):
    beta: torch.Tensor       # (n,) alpha - alpha*
    w: torch.Tensor          # (k,) Phi^T beta
    b: torch.Tensor          # ()
    alpha: torch.Tensor      # (2n,) raw doubled variables [alpha; alpha*]
    n_iter: torch.Tensor
    converged: torch.Tensor
    gap: torch.Tensor


def linear_svr(phi: torch.Tensor, y: torch.Tensor, *, epsilon: float,
               cfg: DCDConfig = DCDConfig(),
               mask: Optional[torch.Tensor] = None,
               alpha0: Optional[torch.Tensor] = None) -> LinearSVRResult:
    """epsilon-insensitive dual as the doubled QP over [Phi; Phi] with
    signs s = [+1; -1] and p = [eps - y; eps + y]. ``mask`` and
    ``alpha0`` are per SAMPLE (length n): the mask doubles with the
    variables; ``alpha0`` is a beta = alpha - alpha* warm start, split
    into ``[max(beta, 0); max(-beta, 0)]``."""
    n, dev = phi.shape[0], phi.device
    y = torch.as_tensor(y, dtype=torch.float32, device=dev)
    phi2 = torch.cat([phi, phi], dim=0)
    s = torch.cat([torch.ones((n,), device=dev),
                   -torch.ones((n,), device=dev)])
    p = torch.cat([epsilon - y, epsilon + y])
    m2 = None
    if mask is not None:
        mask = torch.as_tensor(mask, device=dev)
        m2 = torch.cat([mask, mask])
    a2 = None
    if alpha0 is not None:
        beta0 = torch.as_tensor(alpha0, dtype=torch.float32, device=dev)
        a2 = torch.cat([torch.clamp_min(beta0, 0.0),
                        torch.clamp_min(-beta0, 0.0)])
    r = dcd_qp(phi2, s, p, torch.zeros((2 * n,), device=dev),
               torch.full((2 * n,), float(cfg.C), device=dev), m2, cfg=cfg,
               alpha0=a2)
    return LinearSVRResult(beta=r.alpha[:n] - r.alpha[n:], w=r.w, b=r.b,
                           alpha=r.alpha, n_iter=r.n_iter,
                           converged=r.converged, gap=r.gap)
