"""AdamW, SGD and schedules over parameters by name (the port of
``repro/optim/adamw.py``).

Parameters, gradients and the Adam moments are dicts ``{name: tensor}``
(a ``Model``'s ``named_parameters()``). The arithmetic is the
reference's, in its order: global-norm clip, ``mu`` and ``nu``, bias
corrections from the float32 step, then ``p - lr (m^/(sqrt(v^) + eps) +
wd p)`` — not ``torch.optim.AdamW``'s, which applies the decay first.
Unlike the reference, ``update`` writes the parameters and the moments
in place (``torch._foreach_*`` over slices of the tensors, so a step
keeps few temporaries of a 1 B-parameter model alive) and returns them;
the step count is a host int, so a step reads nothing back from the
card.

DTensor parameters (``sharding.place``) take the same arithmetic on
their local blocks: the moments are DTensors placed as the parameters,
each gradient comes placed as its parameter, and only the global norm
crosses ranks (one all-reduce of the local sums of squares).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

# tensors a foreach pass takes at once: bounds the temporaries of a step
_SLICE = 32


class AdamWState(NamedTuple):
    step: int
    mu: dict
    nu: dict | None


def _slices(*lists):
    n = len(lists[0])
    for i in range(0, n, _SLICE):
        yield tuple(x[i:i + _SLICE] for x in lists)


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local block (a view: in-place updates reach the
    DTensor), a plain tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def _zeros(params: dict) -> dict:
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float | Callable[[int], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params: dict) -> AdamWState:
        return AdamWState(step=0, mu=_zeros(params), nu=_zeros(params))

    def _lr(self, step: int) -> float:
        return self.lr(step) if callable(self.lr) else self.lr

    @torch.no_grad()
    def update(self, grads: dict, state: AdamWState, params: dict):
        """One step: (params, state), both updated in place. ``grads``
        has every parameter's name."""
        names = list(params)
        g = [grads[k] for k in names]
        gnorm = global_norm(g) if self.grad_clip else None
        g = [_local(x) for x in g]
        if self.grad_clip:
            scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
            g = torch._foreach_mul(g, scale)
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(step))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(step))
        lr = self._lr(step)
        mu = [_local(state.mu[k]) for k in names]
        nu = [_local(state.nu[k]) for k in names]
        ps = [_local(params[k]) for k in names]
        for gs, ms, vs, pp in _slices(g, mu, nu, ps):
            torch._foreach_mul_(ms, b1)                     # b1 m + (1 - b1) g
            torch._foreach_add_(ms, torch._foreach_mul(gs, 1 - b1))
            gg = torch._foreach_mul(gs, 1 - b2)             # (1 - b2) g g
            torch._foreach_mul_(gg, gs)
            torch._foreach_mul_(vs, b2)
            torch._foreach_add_(vs, gg)
            den = torch._foreach_div(vs, bc2)               # sqrt(v^) + eps
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            u = torch._foreach_div(ms, bc1)                 # m^ / den
            torch._foreach_div_(u, den)
            torch._foreach_add_(u, torch._foreach_mul(pp, self.weight_decay))
            torch._foreach_mul_(u, lr)
            torch._foreach_sub_(pp, u)
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu)


@dataclasses.dataclass(frozen=True)
class SGD:
    lr: float = 0.01
    momentum: float = 0.0

    def init(self, params: dict) -> AdamWState:
        return AdamWState(step=0, mu=_zeros(params), nu=None)

    @torch.no_grad()
    def update(self, grads: dict, state: AdamWState, params: dict):
        """One step, in place: ``mu = momentum mu + g`` (or g), ``p -= lr
        mu``."""
        names = list(params)
        if self.momentum:
            mu = state.mu
            for k in names:
                _local(mu[k]).mul_(self.momentum).add_(_local(grads[k]))
        else:
            mu = {k: grads[k] for k in names}
        for k in names:
            _local(params[k]).sub_(self.lr * _local(mu[k]))
        return params, AdamWState(step=state.step + 1, mu=mu, nu=None)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, leaves in
    order (a dict's values, or a sequence), as a 0-d float32 tensor.
    DTensor leaves add their local blocks' sums, each divided by the
    number of ranks that hold the same block, and one all-reduce over
    the mesh sums the ranks; the result is the plain tensor every rank
    holds."""
    leaves = list(tree.values()) if isinstance(tree, dict) else list(tree)
    mesh = next((x.device_mesh for x in leaves if isinstance(x, DTensor)),
                None)
    total = sum(_sumsq(x) for x in leaves)
    if mesh is not None:
        from torch.distributed.tensor import Partial
        total = DTensor.from_local(torch.as_tensor(total, dtype=torch.float32),
                                   mesh, [Partial()] * mesh.ndim
                                   ).full_tensor()
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def _sumsq(x: torch.Tensor) -> torch.Tensor:
    if not isinstance(x, DTensor):
        return torch.sum(torch.square(x.to(torch.float32)))
    copies = math.prod(x.device_mesh.size(i)
                       for i, p in enumerate(x.placements) if p.is_replicate())
    local = torch.sum(torch.square(x.to_local().to(torch.float32)))
    return local / copies if copies > 1 else local


def cosine_schedule(*, peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable[[int], float]:
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    down to ``floor * peak_lr`` at ``total``; float32 arithmetic, as the
    reference computes it."""
    f32 = np.float32

    def lr(step: int) -> float:
        s = f32(step)
        if s < f32(warmup):
            return float(f32(peak_lr) * s / f32(max(warmup, 1)))
        t = np.clip((s - f32(warmup)) / f32(max(total - warmup, 1)),
                    f32(0.0), f32(1.0))
        # (1 - floor) * 0.5 is folded in double first, as Python does
        cos = f32(peak_lr) * (f32(floor) + f32((1 - floor) * 0.5)
                              * (f32(1) + np.cos(f32(math.pi) * t)))
        return float(cos)
    return lr
