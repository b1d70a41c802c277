"""Gradient-descent dual kernel SVM — the paper's TensorFlow baseline.

Mirrors ``repro/core/gd.py``: plain fixed-step gradient descent on the
negated soft-margin dual with a soft penalty for the equality
constraint, the full Gram interaction evaluated every step, the
multipliers projected back onto the box after each step:

    L(a) = 1/2 (s a)' K (s a) + p'a + pen (s'a)^2 / n_valid,
    a <- clip(a - lr grad L(a), 0, C) * mask

with s = y, p = -1 for classification (``binary_gd``), and the doubled
epsilon-SVR dual of ``smo.svr_smo`` for regression (``svr_gd``: s =
[+1; -1], p = [eps - y; eps + y] over [alpha; alpha*]).

The reference takes the gradient with ``jax.grad`` inside a
``lax.scan``. The port uses its closed form,
``g = s*u + p + 2 pen (s'a) s / n_valid`` with ``u = K (s a)``, which
``jax.grad`` gives for a symmetric K. The loss after step t needs
``K (s a_{t+1})``, which is the next step's ``u``, so every ``u`` is
computed once: a fit runs ``steps`` matvecs in all (the first ``u``,
at a = 0, is 0), the last one also feeding the bias; the reference
evaluates about three a step. Under ``engine="pallas"`` a matvec is
one ``ops.gram_matvec`` launch. The step loop only enqueues device
work: it reads nothing back to the host.

Sums over the samples (s'a, the loss, the bias) accumulate in float64
and round to float32 once, so that a task's sums do not depend on how
its vector is laid out: ``binary_gd_tasks``, which steps the T tasks of
a multiclass bucket together over a ``TaskKernelEngine`` (one
task-axis matvec launch a step under ``pallas``), gives each task the
result of ``binary_gd`` on its own row of the bucket.

``svr_gd`` evaluates the doubled matvec as ``[u; u]`` with
``u = K(x) (alpha - alpha*)``: ``K2 = [[K, K], [K, K]]`` over [x; x],
so one n-row matvec takes the place of a 2n-row one.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core import kernel_engine as KE
from repro_torch.core import kernels as K
from repro_torch.core.smo import _svr_spec


@dataclasses.dataclass(frozen=True)
class GDConfig:
    C: float = 1.0
    lr: float = 0.01
    steps: int = 2000          # the TF recipes run a fixed step count
    eq_penalty: float = 1.0    # soft penalty for sum_i a_i y_i = 0


class GDResult(NamedTuple):
    alpha: torch.Tensor       # (n,) multipliers ((T, w) for a bucket)
    b: torch.Tensor           # () bias ((T,))
    loss_curve: torch.Tensor  # (steps,) loss after each step ((T, steps))
    n_iter: torch.Tensor      # () steps run


class SVRGDResult(NamedTuple):
    beta: torch.Tensor        # (n,) alpha - alpha*: K(x_i, .) coefficients
    b: torch.Tensor           # () bias, prediction = sum beta_i K(x_i,.) + b
    alpha: torch.Tensor       # (2n,) raw doubled multipliers [alpha; alpha*]
    loss_curve: torch.Tensor  # (steps,) loss after each step
    n_iter: torch.Tensor


def _sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, kept as a (..., 1) float32: accumulated in
    float64 and rounded once, so the bits do not depend on the layout
    (a lone vector or one row of a bucket) the device reduces over."""
    return torch.sum(v, dim=-1, keepdim=True,
                     dtype=torch.float64).to(torch.float32)  # repro: noqa[R002] -- the sample sums' one float64 accumulation, rounded once: bits independent of the layout


def _descend(matvec: Callable[[torch.Tensor], torch.Tensor],
             s: torch.Tensor, p: torch.Tensor, mask: torch.Tensor,
             cfg: GDConfig):
    """The fixed-step projected loop over (n,) or (T, w) state: returns
    the final multipliers, ``u = K (s a)`` at them, and the (..., steps)
    loss curve. Enqueues device work only (no host read)."""
    n_valid = torch.clamp_min(_sum(mask.to(torch.float32)), 1.0)
    pen = cfg.eq_penalty
    a = torch.zeros_like(s)
    u = torch.zeros_like(s)        # K (s * 0) = 0: no matvec at the start
    eq = torch.zeros_like(n_valid)
    losses = torch.empty(s.shape[:-1] + (cfg.steps,), dtype=torch.float32,
                         device=s.device)
    for t in range(cfg.steps):
        g = s * u + p + (2.0 * pen * eq / n_valid) * s
        a = torch.clamp(a - cfg.lr * g, 0.0, cfg.C) * mask
        sa = s * a
        u = matvec(sa)
        eq = _sum(sa)
        loss = 0.5 * _sum(sa * u) + _sum(p * a) + pen * eq * eq / n_valid
        losses[..., t] = loss[..., 0]
    return a, u, losses


def _bias(alpha, target, u, mask, c: float, to_all: bool) -> torch.Tensor:
    """b from the free multipliers (0 < a < C), else from every SV, else
    (``to_all``, the SVR's rule) from every valid sample: the mean of
    ``target - u``, where ``target`` is y (classification) or
    y - s eps (doubled SVR)."""
    free = mask & (alpha > 1e-6) & (alpha < c - 1e-6)
    anysv = mask & (alpha > 1e-6)
    if to_all:
        anysv = torch.where(anysv.any(-1, keepdim=True), anysv, mask)
    use = torch.where(free.any(-1, keepdim=True), free, anysv)
    cnt = torch.clamp_min(_sum(use.to(torch.float32)), 1.0)
    return (_sum(torch.where(use, target - u, 0.0)) / cnt)[..., 0]


def _classify(matvec, y, mask, cfg: GDConfig) -> GDResult:
    """The classification loop: s = y, p = -1, padding (|y| <= 0.5)
    masked out, as ``smo.solve_qp`` masks it."""
    if mask is None:
        mask = torch.ones(y.shape, dtype=torch.bool, device=y.device)
    mask = mask.to(y.device) & (torch.abs(y) > 0.5)
    alpha, u, losses = _descend(matvec, y, torch.full_like(y, -1.0), mask,
                                cfg)
    b = _bias(alpha, y, u, mask, cfg.C, to_all=False)
    return GDResult(alpha=alpha, b=b, loss_curve=losses,
                    n_iter=torch.tensor(cfg.steps, device=y.device))


def binary_gd(x: torch.Tensor,
              y: torch.Tensor,
              mask: Optional[torch.Tensor] = None,
              *,
              cfg: GDConfig = GDConfig(),
              kernel: K.KernelParams = K.KernelParams(),
              gram: Optional[torch.Tensor] = None,
              engine: Optional[KE.KernelEngine | KE.EngineConfig | str]
              = None) -> GDResult:
    """Train one binary SVM by projected gradient descent on the dual,
    on ``x``'s device. ``y`` holds labels in {+1, -1} (0 marks padding).

    ``engine`` (a bound ``KernelEngine``, an ``EngineConfig`` or a
    backend name; None is dense, as in the reference) gives the step's
    matvec; ``gram=`` forces the dense product with that Gram.
    """
    x = x.to(torch.float32)
    y = y.to(device=x.device, dtype=torch.float32)
    if gram is not None:
        gram = gram.to(device=x.device, dtype=torch.float32)
        matvec = gram.__matmul__
    else:
        if engine is None:
            engine = KE.DenseKernelEngine(x, kernel)
        elif not isinstance(engine, KE.KernelEngine):
            engine = KE.make_engine(x, kernel, engine)
        matvec = engine.matvec
    return _classify(matvec, y, mask, cfg)


def binary_gd_tasks(x: torch.Tensor,
                    y: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    *,
                    cfg: GDConfig = GDConfig(),
                    kernel: K.KernelParams = K.KernelParams(),
                    engine: Optional[KE.TaskKernelEngine | KE.EngineConfig
                                     | str] = None) -> GDResult:
    """The T binary problems of one multiclass bucket (x (T, w, d), labels
    y (T, w), 0 on padding) descending together, where the reference
    vmaps ``binary_gd`` over the bucket: each step is one task-axis
    matvec (``TaskKernelEngine.matvec``) for the whole bucket. Task t's
    result is ``binary_gd(x[t], y[t], mask[t])`` on the same engine.
    Returns a ``GDResult`` of (T, w) / (T,) / (T, steps) tensors."""
    if x.ndim != 3:
        raise ValueError(f"binary_gd_tasks: x must be (T, w, d), got "
                         f"{tuple(x.shape)}")
    y = y.to(device=x.device, dtype=torch.float32)
    eng = (engine if isinstance(engine, KE.TaskKernelEngine)
           else KE.TaskKernelEngine(x, kernel,
                                    "dense" if engine is None else engine))
    return _classify(eng.matvec, y, mask, cfg)


def svr_gd(x: torch.Tensor,
           y: torch.Tensor,
           mask: Optional[torch.Tensor] = None,
           *,
           epsilon: float = 0.1,
           cfg: GDConfig = GDConfig(),
           kernel: K.KernelParams = K.KernelParams(),
           engine: Optional[KE.EngineConfig | str] = None) -> SVRGDResult:
    """Train one epsilon-SVR by projected gradient descent on the doubled
    epsilon-insensitive dual (``smo.svr_smo``'s QP), on ``x``'s device.
    The doubled matvec is ``[u; u]`` from one n-row matvec on the engine
    built over ``x`` (an ``EngineConfig`` or backend name; None is
    dense); a pre-bound engine is refused, as in the reference."""
    if isinstance(engine, KE.KernelEngine):
        raise ValueError(
            "svr_gd solves the doubled 2n-variable dual and must build "
            "its engine on [x; x]; pass an EngineConfig or backend name, "
            f"not a bound engine ({type(engine).__name__})")
    n = x.shape[0]
    x = x.to(torch.float32)
    y = torch.as_tensor(y, dtype=torch.float32, device=x.device)
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=x.device)
    s, p, _, _ = _svr_spec(y, epsilon, cfg.C)
    m2 = torch.cat([mask, mask]).to(x.device)
    eng = (KE.DenseKernelEngine(x, kernel) if engine is None
           else KE.make_engine(x, kernel, engine))

    def matvec(v):   # K2 v over [x; x] from one n-row product
        u = eng.matvec(v[:n] + v[n:])
        return torch.cat([u, u])

    alpha, u, losses = _descend(matvec, s, p, m2, cfg)
    b = _bias(alpha, torch.cat([y, y]) - s * epsilon, u, m2, cfg.C,
              to_all=True)
    return SVRGDResult(beta=alpha[:n] - alpha[n:], b=b, alpha=alpha,
                       loss_curve=losses,
                       n_iter=torch.tensor(cfg.steps, device=y.device))
