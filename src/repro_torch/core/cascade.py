"""Cascade SVM — hierarchical shard-solve-reduce training with a
certified global KKT exit (Graf et al., *Parallel Support Vector
Machines: The Cascade SVM*, NIPS 2004; the hierarchical tier the source
paper's MPI layer stops short of).

Mirrors ``repro/core/cascade.py``. The training set is partitioned
into S shards (round-robin: shard s owns rows ``s::S``), each shard's
sub-SVM is solved independently, and the solutions combine by
support-vector union up a binary reduction tree; after the root solve
a float64 KKT certificate is recomputed over the FULL dataset, and
while it fails the surviving global SV set is fed back into every shard
for another round, each node warm-started from the previous solution.
A round declares convergence only when ``smo.kkt_violation`` of a
recomputed gradient is <= tol.

The round loop is host numpy, as in the reference: it reads the device
once a level (the nodes' results) and once a round (the certificate).
How the nodes run on the port:

* ``cascade_binary`` / ``cascade_svr`` (exact kernels): a level of
  several nodes is one ``dist.fit_taskset`` with per-task ``alpha0``
  warm starts (the task-axis row and ``kkt_select`` kernels under
  ``engine="pallas"``); a single-node level — every root, and the
  S = 1 cascade — is ``smo.binary_smo`` / ``smo.svr_smo`` with the
  engine config ``SVC.fit`` / ``SVR.fit`` use, so a one-shard cascade
  is the unsharded fit bit for bit. Merged warm starts are projected
  back onto ``sum_i y_i a_i = 0`` (``_repair_equality``, host float64).
  The certificate's Gram blocks (``CERT_CHUNK`` rows against the SVs)
  come from the ``rbf_gram`` block kernel under ``engine="pallas"``
  (RBF / linear), else from the plain Gram, and are accumulated in
  float64 on the device.
* ``cascade_dcd`` / ``cascade_dcd_svr`` (low rank, over an already
  transformed Phi shared by the whole dataset): a level's nodes are
  solved together over their rows of Phi by ``linear.linear_svc_tasks``
  / ``linear.linear_svr_tasks`` (one task-axis ``dcd_epoch`` launch an
  epoch), each node bit for bit its lone ``linear_svc`` /
  ``linear_svr``, which a single-node level calls. No equality repair
  (the augmented-bias dual has none); the certificate is a float64
  ``PhiBar^T (alpha y)`` and ``PhiBar wbar`` on the device, with the
  multiplier pinned at r = 0.

With a ``mesh`` (``launch.mesh``) the exact cascades are collective
calls: every rank runs the round loop, and a level of several nodes is
one ``dist.fit_taskset`` over the mesh (``shard="task"``: each rank
solves the nodes the LPT layout gave it, one all_reduce a bucket), each
node the bits of its lone solve; single-node levels run on every rank.
So a cascade on a mesh equals the cascade without one, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import dist
from repro_torch.core import kernel_engine as KE
from repro_torch.core import kernels as K
from repro_torch.core import linear
from repro_torch.core import multiclass as MC
from repro_torch.core import smo
from repro_torch.kernels import ops

# support threshold, relative to C (matches svm._sv_threshold; kept
# local — svm imports this module, not the other way around)
SV_EPS = 1e-8

# rows per float64 certificate block: bounds the live cross-Gram slab to
# CHUNK * n_sv floats regardless of n
CERT_CHUNK = 8192


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    """Cascade topology + termination knobs.

    shards: leaf count S (clamped to n); 1 degenerates to the plain
            unsharded solve (bit-identical to it).
    rounds: max feedback rounds. Round 2+ re-solves every shard on
            ``partition ∪ global SVs`` warm-started from the previous
            solution; the loop exits early on certificate success or on
            a fixed point (identical support set AND violation).
    tol:    global certificate tolerance; None inherits the solver tol.
    """

    shards: int = 4
    rounds: int = 8
    tol: Optional[float] = None


class CascadeResult(NamedTuple):
    """Global solution + certificate trail of one cascade run."""

    alpha: np.ndarray          # (n,) dual vector (per-sample beta for SVR)
    b: float
    n_iter: int                # solver iterations summed over all nodes
    converged: bool            # final certified violation <= tol
    kkt: float                 # final certified violation (f64 recompute)
    rounds: int                # feedback rounds actually run
    history: tuple             # per-round dicts: nodes, sv, kkt, n_iter
    alpha_raw: Optional[np.ndarray] = None   # (2n,) [alpha; alpha*] (SVR)
    w: Optional[np.ndarray] = None           # (k,) primal weights (low-rank)


def partition_indices(n: int, shards: int) -> list[np.ndarray]:
    """Deterministic round-robin partition: shard s owns rows ``s::S``.
    Interleaving keeps every shard class-mixed even when the caller's
    rows arrive sorted by label (the common dataset layout)."""
    s = max(1, min(int(shards), int(n)))
    return [np.arange(p, n, s, dtype=np.int64) for p in range(s)]


def validate_cascade(solver: Optional[str],
                     cascade: CascadeConfig) -> None:
    """Fail fast on configurations the cascade cannot honor. ``solver``
    is None on the low-rank path (which ignores the solver knob and
    always runs DCD nodes)."""
    if solver is not None and solver != "smo":
        raise ValueError(
            "shard='cascade' warm-starts sub-SVM solves and requires "
            f"solver='smo' (got solver={solver!r})")
    if cascade.shards < 1:
        raise ValueError(f"cascade_shards must be >= 1 "
                         f"(got {cascade.shards})")
    if cascade.rounds < 1:
        raise ValueError(f"cascade_rounds must be >= 1 "
                         f"(got {cascade.rounds})")


def _repair_equality(v: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Project a merged warm start back onto ``sum_i y_i v_i = 0`` by
    draining entries toward 0, largest first, on the offending sign
    side — every step stays inside the box (all boxes here contain 0 on
    the side being drained) and touches the fewest coordinates. Host
    float64: the residue being cancelled is itself a rounding-scale
    quantity and f32 arithmetic would leave a remainder.

    SVC passes v = alpha >= 0 with y the ±1 labels; SVR passes v = beta
    (signed) with y = 1, which makes the constraint ``sum beta = 0``."""
    v = np.asarray(v, np.float64).copy()
    c = np.asarray(y, np.float64) * v
    s = float(c.sum())
    if s == 0.0:
        return v.astype(np.float32)
    sign = 1.0 if s > 0.0 else -1.0
    excess = abs(s)
    idx = np.where(c * sign > 0.0)[0]
    for i in idx[np.argsort(-np.abs(v[idx]))]:
        take = min(abs(v[i]), excess)
        v[i] -= np.sign(v[i]) * take
        excess -= take
        if excess <= 0.0:
            break
    return v.astype(np.float32)


class _NodeFit(NamedTuple):
    """One solved cascade node (indices are GLOBAL row ids)."""

    idx: np.ndarray            # (k,) int64 rows of the node's samples
    alpha: np.ndarray          # (k,) per-sample dual (beta for SVR)
    b: float
    n_iter: int
    converged: bool
    raw: Optional[np.ndarray] = None   # (2k,) doubled [alpha; alpha*]
    w: Optional[np.ndarray] = None     # (k_feat,) DCD primal weights


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


# --------------------------------------------------------- f64 certificates
def _cross_gram_apply(kernel: K.KernelParams,
                      ecfg: Optional[KE.EngineConfig],
                      x: torch.Tensor, x_sv: torch.Tensor,
                      coef64: torch.Tensor) -> torch.Tensor:
    """g = K(x, x_sv) @ coef in float64 on the device, CERT_CHUNK rows at
    a time: float32 Gram blocks (the precision the model itself lives
    in) accumulated in float64. Under ``engine="pallas"`` an RBF or
    linear block is one launch of the ``rbf_gram`` block kernel."""
    if (ecfg is not None and ecfg.backend == "pallas"
            and kernel.name in ("rbf", "linear")):
        sv2 = K.sqnorms(x_sv)

        def gram(a):
            return ops.rbf_gram(a, x_sv, gamma=kernel.gamma,
                                mode=kernel.name, b2=sv2)
    else:
        gram_fn = K.make_gram_fn(kernel)

        def gram(a):
            return gram_fn(a, x_sv)
    return torch.cat([gram(xb).to(torch.float64) @ coef64
                      for xb in torch.split(x, CERT_CHUNK)])


def _doubled_violation(adapter, g: torch.Tensor, beta_full: np.ndarray,
                       root: _NodeFit, r) -> float:
    """float64 KKT violation of the doubled epsilon-SVR QP, given the
    prediction g = K beta (exact) or PhiBar wbar (low rank) and the raw
    doubled multipliers of the root's solve."""
    n = len(beta_full)
    y64 = adapter.yd.to(torch.float64)
    f = torch.cat([g + adapter.epsilon - y64, g - adapter.epsilon - y64])
    ones = torch.ones((n,), device=adapter.dev)
    a2 = torch.from_numpy(adapter.scatter_raw(beta_full, root)).to(adapter.dev)
    return float(smo.kkt_violation(a2, torch.cat([ones, -ones]), f, 0.0,
                                   adapter.cfg.C, r=r))


def _scatter_raw(beta_full: np.ndarray, root: _NodeFit) -> np.ndarray:
    """(2n,) raw doubled multipliers from the root's actual solve (the
    root is always solved alone, so ``raw`` is present)."""
    n = len(beta_full)
    a2 = np.zeros((2 * n,), np.float32)
    k = len(root.idx)
    a2[root.idx] = root.raw[:k]
    a2[n + root.idx] = root.raw[k:]
    return a2


# ----------------------------------------------------------------- adapters
class _ExactSVCAdapter:
    """Exact-kernel classification: shard samples, solve with SMO."""

    kind = "svc"

    def __init__(self, x, yy, *, smo_cfg, kernel, engine, dev, mesh,
                 worker_axes):
        self.x = np.asarray(x, np.float32)
        self.yy = np.asarray(yy, np.float32)
        self.dev = dev
        self.xd = torch.from_numpy(self.x).to(dev)
        self.yd = torch.from_numpy(self.yy).to(dev)
        self.cfg = smo_cfg
        self.kernel = kernel
        self.ecfg = (KE.EngineConfig(backend=engine) if isinstance(engine, str)
                     else engine)
        self.thr = SV_EPS * smo_cfg.C
        self.mesh = mesh
        self.worker_axes = tuple(worker_axes)

    def is_sv(self, alpha: np.ndarray) -> np.ndarray:
        return alpha > self.thr

    def repair(self, idx: np.ndarray, v: np.ndarray) -> np.ndarray:
        return _repair_equality(v, self.yy[idx])

    def _node(self, idx):
        """(x, y) of a node's rows, on the device."""
        return (torch.from_numpy(self.x[idx]).to(self.dev),
                torch.from_numpy(self.yy[idx]).to(self.dev))

    def _solve_one(self, idx, a0):
        xx, yv = self._node(idx)
        r = smo.binary_smo(
            xx, yv, cfg=self.cfg, kernel=self.kernel, engine=self.ecfg,
            alpha0=None if a0 is None else torch.from_numpy(a0).to(self.dev))
        return _NodeFit(idx=idx, alpha=_host(r.alpha), b=float(r.b),
                        n_iter=int(r.n_iter), converged=bool(r.converged))

    def _taskset_kwargs(self):
        return {}

    def solve_level(self, nodes):
        """nodes: [(idx, a0-or-None)] -> [_NodeFit], order preserved."""
        if len(nodes) == 1:
            idx, a0 = nodes[0]
            return [self._solve_one(idx, a0)]
        tasks = tuple(
            MC.BinaryTask(x=self.x[idx], y=self.yy[idx], pos=1, neg=0,
                          indices=idx) for idx, _ in nodes)
        ts = MC.TaskSet(tasks=tasks, classes=np.array([-1.0, 1.0]),
                        strategy="cascade")
        sizes = ts.sizes
        a0m = None
        if any(a0 is not None for _, a0 in nodes):
            # zeros on cold slots reproduce the cold start: clip(0) = 0
            # and matvec(0) is an exact zero f-cache correction
            a0m = np.zeros((len(nodes), int(sizes.max())), np.float32)
            for t, (_, a0) in enumerate(nodes):
                if a0 is not None:
                    a0m[t, :len(a0)] = a0
        fit = dist.fit_taskset(
            ts, solver="smo", smo_cfg=self.cfg, kernel=self.kernel,
            engine=self.ecfg, alpha0=a0m, device=self.dev, mesh=self.mesh,
            worker_axes=self.worker_axes,
            **self._taskset_kwargs())
        return [
            _NodeFit(idx=nodes[t][0],
                     alpha=fit.alpha[t, :int(sizes[t])].copy(),
                     b=float(fit.b[t]), n_iter=int(fit.n_iter[t]),
                     converged=bool(fit.converged[t]))
            for t in range(len(nodes))
        ]

    def _gradient(self, sv: np.ndarray, coef: np.ndarray) -> torch.Tensor:
        """g = sum_j coef_j K(x_i, x_j) over the support ``sv``, float64
        on the device."""
        if not sv.any():
            return torch.zeros(len(self.yy), dtype=torch.float64,
                               device=self.dev)
        sv_t = torch.from_numpy(np.flatnonzero(sv)).to(self.dev)
        return _cross_gram_apply(
            self.kernel, self.ecfg, self.xd, self.xd.index_select(0, sv_t),
            torch.from_numpy(coef[sv]).to(self.dev))

    def certify(self, alpha_full: np.ndarray, root: _NodeFit) -> float:
        g = self._gradient(self.is_sv(alpha_full),
                           alpha_full.astype(np.float64) * self.yy)
        return float(smo.kkt_violation(
            torch.from_numpy(alpha_full).to(self.dev), self.yd,
            g - self.yd.to(torch.float64), 0.0, self.cfg.C))


class _ExactSVRAdapter(_ExactSVCAdapter):
    """Exact-kernel epsilon-SVR: duals are per-sample betas, the scalar
    root solve additionally yields the raw doubled multipliers the
    certificate (and ``alpha_raw_``) needs."""

    kind = "svr"

    def __init__(self, x, y, *, epsilon, smo_cfg, kernel, engine, dev,
                 mesh, worker_axes):
        super().__init__(x, np.asarray(y, np.float32), smo_cfg=smo_cfg,
                         kernel=kernel, engine=engine, dev=dev, mesh=mesh,
                         worker_axes=worker_axes)
        self.epsilon = float(epsilon)

    def is_sv(self, beta: np.ndarray) -> np.ndarray:
        return np.abs(beta) > self.thr

    def repair(self, idx: np.ndarray, v: np.ndarray) -> np.ndarray:
        return _repair_equality(v, np.ones_like(v))

    def _solve_one(self, idx, a0):
        xx, yv = self._node(idx)
        a02 = None
        if a0 is not None:
            b0 = torch.from_numpy(a0).to(self.dev)
            a02 = torch.cat([torch.clamp_min(b0, 0.0),
                             torch.clamp_min(-b0, 0.0)])
        r = smo.svr_smo(xx, yv, epsilon=self.epsilon, cfg=self.cfg,
                        kernel=self.kernel, engine=self.ecfg, alpha0=a02)
        return _NodeFit(idx=idx, alpha=_host(r.beta), b=float(r.b),
                        n_iter=int(r.n_iter), converged=bool(r.converged),
                        raw=_host(r.alpha))

    def _taskset_kwargs(self):
        return {"svr_epsilon": self.epsilon}

    scatter_raw = staticmethod(_scatter_raw)

    def certify(self, beta_full: np.ndarray, root: _NodeFit) -> float:
        g = self._gradient(self.is_sv(beta_full),
                           beta_full.astype(np.float64))
        return _doubled_violation(self, g, beta_full, root, r=None)


class _DCDSVCAdapter:
    """Low-rank classification over a SHARED feature matrix Phi: shards
    slice rows of Phi, nodes are augmented-bias DCD solves (no equality
    constraint — warm starts need no repair), the certificate pins
    r = 0 (the test-harness convention for the linear path)."""

    kind = "svc"

    def __init__(self, phi, yy, *, dcd_cfg):
        self.phi = phi.to(torch.float32).contiguous()
        self.dev = self.phi.device
        self.yy = np.asarray(yy, np.float32)
        self.yd = torch.from_numpy(self.yy).to(self.dev)
        self.cfg = dcd_cfg
        self.thr = SV_EPS * dcd_cfg.C
        # PhiBar = [Phi, bias] in float64 once: the certificate operand
        n = self.phi.shape[0]
        self.phib64 = torch.cat(
            [self.phi.to(torch.float64),
             torch.full((n, 1), dcd_cfg.bias, dtype=torch.float64,
                        device=self.dev)], dim=1)

    def is_sv(self, alpha: np.ndarray) -> np.ndarray:
        return alpha > self.thr

    def repair(self, idx: np.ndarray, v: np.ndarray) -> np.ndarray:
        return np.asarray(v, np.float32)   # no equality constraint

    def _rows(self, nodes):
        return [torch.from_numpy(idx).to(self.dev) for idx, _ in nodes]

    def _starts(self, nodes):
        return [None if a0 is None else torch.from_numpy(a0).to(self.dev)
                for _, a0 in nodes]

    def _fit(self, r, idx):
        return _NodeFit(idx=idx, alpha=_host(r.alpha), b=float(r.b),
                        n_iter=int(r.n_iter), converged=bool(r.converged),
                        w=_host(r.w))

    def solve_level(self, nodes):
        """One node: its lone ``linear_svc``; several: one
        ``linear_svc_tasks`` over their rows of Phi (each node that
        lone solve, bit for bit)."""
        rows, starts = self._rows(nodes), self._starts(nodes)
        ys = [self.yd.index_select(0, r) for r in rows]
        if len(nodes) == 1:
            fits = [linear.linear_svc(self.phi.index_select(0, rows[0]),
                                      ys[0], cfg=self.cfg,
                                      alpha0=starts[0])]
        else:
            fits = linear.linear_svc_tasks(self.phi, rows, ys, cfg=self.cfg,
                                           alpha0=starts)
        return [self._fit(r, idx) for r, (idx, _) in zip(fits, nodes)]

    def _prediction(self, coef: np.ndarray) -> torch.Tensor:
        wbar = self.phib64.T @ torch.from_numpy(
            coef.astype(np.float64)).to(self.dev)
        return self.phib64 @ wbar

    def certify(self, alpha_full: np.ndarray, root: _NodeFit) -> float:
        f = (self._prediction(alpha_full.astype(np.float64) * self.yy)
             - self.yd.to(torch.float64))
        return float(smo.kkt_violation(
            torch.from_numpy(alpha_full).to(self.dev), self.yd, f, 0.0,
            self.cfg.C, r=0.0))


class _DCDSVRAdapter(_DCDSVCAdapter):
    """Low-rank epsilon-SVR cascade (doubled DCD per node)."""

    kind = "svr"
    scatter_raw = staticmethod(_scatter_raw)

    def __init__(self, phi, y, *, epsilon, dcd_cfg):
        super().__init__(phi, np.asarray(y, np.float32), dcd_cfg=dcd_cfg)
        self.epsilon = float(epsilon)

    def is_sv(self, beta: np.ndarray) -> np.ndarray:
        return np.abs(beta) > self.thr

    def _fit(self, r, idx):
        return _NodeFit(idx=idx, alpha=_host(r.beta), b=float(r.b),
                        n_iter=int(r.n_iter), converged=bool(r.converged),
                        raw=_host(r.alpha), w=_host(r.w))

    def solve_level(self, nodes):
        """As the SVC adapter, over the doubled QP: ``linear_svr`` /
        ``linear_svr_tasks``."""
        rows, starts = self._rows(nodes), self._starts(nodes)
        ys = [self.yd.index_select(0, r) for r in rows]
        if len(nodes) == 1:
            fits = [linear.linear_svr(self.phi.index_select(0, rows[0]),
                                      ys[0], epsilon=self.epsilon,
                                      cfg=self.cfg, alpha0=starts[0])]
        else:
            fits = linear.linear_svr_tasks(self.phi, rows, ys,
                                           epsilon=self.epsilon,
                                           cfg=self.cfg, alpha0=starts)
        return [self._fit(r, idx) for r, (idx, _) in zip(fits, nodes)]

    def certify(self, beta_full: np.ndarray, root: _NodeFit) -> float:
        return _doubled_violation(self, self._prediction(beta_full),
                                  beta_full, root, r=0.0)


# --------------------------------------------------------------- round loop
def _merge(a: _NodeFit, b: _NodeFit, adapter):
    """SV-union of two solved children -> (idx, warm start) for the
    parent. Duplicated rows (feedback rounds re-inject global SVs into
    every shard) resolve first-wins; the merged start is projected back
    onto the solver's equality constraint by ``adapter.repair``."""
    ka, kb = adapter.is_sv(a.alpha), adapter.is_sv(b.alpha)
    idx = np.concatenate([a.idx[ka], b.idx[kb]])
    vals = np.concatenate([a.alpha[ka], b.alpha[kb]])
    if len(idx) == 0:
        # degenerate children (e.g. single-class shards solved to
        # alpha = 0): hand the parent a token sample per child so the
        # solve stays non-empty
        idx = np.unique(np.concatenate([a.idx[:1], b.idx[:1]]))
        return idx, None
    uniq, first = np.unique(idx, return_index=True)
    return uniq, adapter.repair(uniq, vals[first])


def _run_cascade(n: int, adapter, cascade: CascadeConfig,
                 tol: float) -> tuple:
    """Shared round/tree loop; returns (alpha_full, root, n_iter,
    converged, kkt, rounds, history)."""
    parts = partition_indices(n, cascade.shards)
    prev_alpha = None      # (n,) last round's global scatter
    prev_sv = None
    prev_viol = None
    history = []
    total_iter = 0
    converged = False
    viol = float("inf")
    rnd = 0
    for rnd in range(1, max(1, cascade.rounds) + 1):
        if prev_alpha is None:
            leaves = [(p, None) for p in parts]
        else:
            sv_idx = np.flatnonzero(adapter.is_sv(prev_alpha))
            leaves = []
            for p in parts:
                idx = np.unique(np.concatenate([p, sv_idx]))
                leaves.append((idx, adapter.repair(idx, prev_alpha[idx])))
        solved = adapter.solve_level(leaves)
        total_iter += sum(s.n_iter for s in solved)
        n_nodes = len(solved)
        while len(solved) > 1:
            carry = None
            if len(solved) % 2:
                carry, solved = solved[-1], solved[:-1]
            to_solve = [_merge(solved[i], solved[i + 1], adapter)
                        for i in range(0, len(solved), 2)]
            new = adapter.solve_level(to_solve)
            total_iter += sum(s.n_iter for s in new)
            n_nodes += len(new)
            solved = new + ([carry] if carry is not None else [])
        root = solved[0]
        alpha_full = np.zeros((n,), np.float32)
        alpha_full[root.idx] = root.alpha
        viol = adapter.certify(alpha_full, root)
        sv_now = np.flatnonzero(adapter.is_sv(alpha_full))
        history.append({"round": rnd, "nodes": n_nodes,
                        "root_size": int(len(root.idx)),
                        "sv": int(len(sv_now)), "kkt": viol,
                        "n_iter": total_iter})
        prev_alpha = alpha_full
        if viol <= tol:
            converged = True
            break
        if (prev_sv is not None and prev_viol is not None
                and viol == prev_viol
                and np.array_equal(sv_now, prev_sv)):
            # fixed point: feedback reproduced the identical solution,
            # further rounds cannot move the certificate
            break
        prev_sv, prev_viol = sv_now, viol
    return (prev_alpha, root, total_iter, converged, viol, rnd,
            tuple(history))


# ------------------------------------------------------------- entry points
def _device(device, mesh) -> torch.device:
    return resolve_device(device) if mesh is None else mesh.device


def cascade_binary(x, yy, *,
                   smo_cfg: smo.SMOConfig = smo.SMOConfig(),
                   kernel: K.KernelParams = K.KernelParams(),
                   engine=None,
                   cascade: CascadeConfig = CascadeConfig(),
                   mesh=None,
                   worker_axes: tuple[str, ...] = ("workers",),
                   device: str | torch.device = "cuda") -> CascadeResult:
    """Exact-kernel binary cascade on ``device`` (with a ``mesh``, a
    collective call on ``mesh.device``, a level's nodes spread over
    ``worker_axes``). ``x`` (n, d) and ``yy`` in {+1, -1} are host
    arrays; ``engine`` is an ``EngineConfig`` or backend name (None:
    dense, as ``binary_smo``)."""
    adapter = _ExactSVCAdapter(x, yy, smo_cfg=smo_cfg, kernel=kernel,
                               engine=engine, dev=_device(device, mesh),
                               mesh=mesh, worker_axes=worker_axes)
    tol = smo_cfg.tol if cascade.tol is None else cascade.tol
    alpha, root, n_iter, conv, viol, rounds, hist = _run_cascade(
        len(adapter.yy), adapter, cascade, tol)
    return CascadeResult(alpha=alpha, b=root.b, n_iter=n_iter,
                         converged=conv, kkt=viol, rounds=rounds,
                         history=hist)


def cascade_svr(x, y, *,
                epsilon: float = 0.1,
                smo_cfg: smo.SMOConfig = smo.SMOConfig(),
                kernel: K.KernelParams = K.KernelParams(),
                engine=None,
                cascade: CascadeConfig = CascadeConfig(),
                mesh=None,
                worker_axes: tuple[str, ...] = ("workers",),
                device: str | torch.device = "cuda") -> CascadeResult:
    """Exact-kernel epsilon-SVR cascade on ``device`` (a mesh as in
    ``cascade_binary``); ``alpha`` is the per-sample beta vector,
    ``alpha_raw`` the (2n,) doubled scatter of the root solve."""
    adapter = _ExactSVRAdapter(x, y, epsilon=epsilon, smo_cfg=smo_cfg,
                               kernel=kernel, engine=engine,
                               dev=_device(device, mesh), mesh=mesh,
                               worker_axes=worker_axes)
    tol = smo_cfg.tol if cascade.tol is None else cascade.tol
    beta, root, n_iter, conv, viol, rounds, hist = _run_cascade(
        len(adapter.yy), adapter, cascade, tol)
    return CascadeResult(alpha=beta, b=root.b, n_iter=n_iter,
                         converged=conv, kkt=viol, rounds=rounds,
                         history=hist,
                         alpha_raw=adapter.scatter_raw(beta, root))


def cascade_dcd(phi: torch.Tensor, yy, *,
                dcd_cfg: linear.DCDConfig = linear.DCDConfig(),
                cascade: CascadeConfig = CascadeConfig()
                ) -> CascadeResult:
    """Low-rank classification cascade over a shared feature matrix
    ``phi`` (transform the full X ONCE, then cascade over row slices),
    on ``phi``'s device. Returns the root's primal ``w`` for serving."""
    adapter = _DCDSVCAdapter(phi, yy, dcd_cfg=dcd_cfg)
    tol = dcd_cfg.tol if cascade.tol is None else cascade.tol
    alpha, root, n_iter, conv, viol, rounds, hist = _run_cascade(
        len(adapter.yy), adapter, cascade, tol)
    return CascadeResult(alpha=alpha, b=root.b, n_iter=n_iter,
                         converged=conv, kkt=viol, rounds=rounds,
                         history=hist, w=root.w)


def cascade_dcd_svr(phi: torch.Tensor, y, *,
                    epsilon: float = 0.1,
                    dcd_cfg: linear.DCDConfig = linear.DCDConfig(),
                    cascade: CascadeConfig = CascadeConfig()
                    ) -> CascadeResult:
    """Low-rank epsilon-SVR cascade over a shared feature matrix, on
    ``phi``'s device."""
    adapter = _DCDSVRAdapter(phi, y, epsilon=epsilon, dcd_cfg=dcd_cfg)
    tol = dcd_cfg.tol if cascade.tol is None else cascade.tol
    beta, root, n_iter, conv, viol, rounds, hist = _run_cascade(
        len(adapter.yy), adapter, cascade, tol)
    return CascadeResult(alpha=beta, b=root.b, n_iter=n_iter,
                         converged=conv, kkt=viol, rounds=rounds,
                         history=hist, w=root.w,
                         alpha_raw=adapter.scatter_raw(beta, root))
