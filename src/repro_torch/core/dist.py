"""The multiclass task layer: every binary task of a TaskSet, one batched
SMO per schedule bucket.

Mirrors the task-parallel, single-device part of ``repro/core/dist.py``
(paper Fig. 4, ``MPI-CUDA_multiSMO``): C = m(m-1)/2 (OvO) or m (OvR)
binary problems, grouped by the size-bucketed ``Schedule``
(``core/multiclass.py``). The reference vmaps ``binary_smo`` over each
bucket; here each bucket is stacked into (T, w, d) and solved by
``smo.solve_qp_tasks`` — one batched SMO whose every iteration is one
selection launch and two row launches for the whole bucket, and whose
host check reads one flag per ``check_every`` block. Each task freezes
when its own gap closes, so its result is that of the task solved
alone.

``fit_taskset`` runs on ``device`` ("cuda" by default; "cpu" must be
asked for). ``vmapped_ovo_fit`` is the legacy shim over it for the
padded ``ovo.OvOTasks`` stack.

Not ported yet, and raising NotImplementedError until their slice: a
``mesh`` / ``shard="data" | "auto"`` (data- and task-parallel over
several devices, ROADMAP A.11), ``shard="cascade"`` (A.9) and
``solver="gd"`` (A.7).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import kernel_engine as KE
from repro_torch.core import kernels as K
from repro_torch.core import multiclass as MC
from repro_torch.core import smo as smo_mod
from repro_torch.core.ovo import OvOTasks

# the reference's options of the task layer this port refuses, and the
# item that ports each
_UNPORTED_SHARD = {
    "data": "data-parallel SMO over a mesh (ROADMAP A.11)",
    "auto": "data-parallel SMO over a mesh (ROADMAP A.11)",
    "cascade": "the cascade (ROADMAP A.9)",
}


class OvOFit(NamedTuple):
    alpha: torch.Tensor      # (C, n_task)
    b: torch.Tensor          # (C,)
    n_iter: torch.Tensor     # (C,)
    converged: torch.Tensor  # (C,) bool


class TaskSetFit(NamedTuple):
    """Host-side results for a fitted TaskSet. Row ``t`` of ``alpha`` is
    valid up to ``sizes[t]`` (tasks are solved at their bucket width;
    storage pads to the widest task)."""

    alpha: np.ndarray      # (C, max_k) float32
    b: np.ndarray          # (C,) float32
    n_iter: np.ndarray     # (C,) int
    converged: np.ndarray  # (C,) bool
    sizes: np.ndarray      # (C,) int true task lengths


def resolve_worker_count(mesh=None, worker_axes: tuple[str, ...] = ()) -> int:
    """Worker count of a task-parallel layout: 1 without a mesh. A mesh
    (several devices) raises until data-parallel SMO is ported."""
    if mesh is None:
        return 1
    raise NotImplementedError(
        f"a mesh (worker_axes={tuple(worker_axes)}) is not ported yet; "
        "multi-device layouts come with ROADMAP A.11")


def _check_options(mesh, worker_axes, solver: str, shard: str) -> None:
    if solver == "gd":
        raise NotImplementedError(
            "solver 'gd' is not ported yet; the GD baseline comes with "
            "ROADMAP A.7")
    if solver != "smo":
        raise ValueError(f"unknown solver {solver!r}")
    if shard in _UNPORTED_SHARD:
        raise NotImplementedError(
            f"shard={shard!r} is not ported yet; it comes with "
            f"{_UNPORTED_SHARD[shard]}")
    if shard != "task":
        raise ValueError(f"unknown shard mode {shard!r}; expected "
                         "'task', 'data', 'auto' or 'cascade'")
    resolve_worker_count(mesh, tuple(worker_axes))


def _bucket_arrays(taskset: MC.TaskSet, bucket: MC.Bucket,
                   alpha0: Optional[np.ndarray] = None):
    """Stack one bucket's tasks into (slots, width, d) solver inputs in
    the layout grid's row order; dummy slots (-1) are fully masked.
    ``alpha0`` is a (C, max_k) warm-start matrix (``TaskSetFit`` layout);
    the stacked (slots, width) warm starts come back fourth (None
    without one)."""
    ids = bucket.task_ids.reshape(-1)
    d = taskset.tasks[0].x.shape[1]
    xt = np.zeros((len(ids), bucket.width, d), np.float32)
    yt = np.zeros((len(ids), bucket.width), np.float32)
    mk = np.zeros((len(ids), bucket.width), bool)
    a0 = (None if alpha0 is None
          else np.zeros((len(ids), bucket.width), np.float32))
    for s, t in enumerate(ids):
        if t < 0:
            continue
        task = taskset.tasks[t]
        k = task.size
        xt[s, :k] = task.x
        yt[s, :k] = task.y
        mk[s, :k] = True
        if a0 is not None:
            a0[s, :k] = alpha0[t, :k]
    return xt, yt, mk, a0


def _fit_bucket(x, y, mask, a0, *, smo_cfg: smo_mod.SMOConfig,
                kernel: K.KernelParams, engine, svr_epsilon):
    """One bucket: the classification spec, or with ``svr_epsilon`` the
    doubled epsilon-SVR spec of every task ([x; x] along the width,
    signs [+1; -1], p = [eps - y; eps + y]; alpha comes back as beta =
    alpha - alpha*, and a warm start is a beta split into its doubled
    parts)."""
    if svr_epsilon is None:
        return smo_mod.binary_smo_tasks(x, y, mask, cfg=smo_cfg,
                                        kernel=kernel, engine=engine,
                                        alpha0=a0)
    w = x.shape[1]
    ones = torch.ones_like(y)
    s = torch.cat([ones, -ones], dim=1)
    p = torch.cat([svr_epsilon - y, svr_epsilon + y], dim=1)
    a02 = None
    if a0 is not None:
        a02 = torch.cat([torch.clamp_min(a0, 0.0), torch.clamp_min(-a0, 0.0)],
                        dim=1)
    r = smo_mod.solve_qp_tasks(
        torch.cat([x, x], dim=1), s, p, 0.0, float(smo_cfg.C),
        torch.cat([mask, mask], dim=1), cfg=smo_cfg, kernel=kernel,
        engine=engine, alpha0=a02)
    return r._replace(alpha=r.alpha[:, :w] - r.alpha[:, w:])


def fit_taskset(taskset: MC.TaskSet,
                schedule: Optional[MC.Schedule] = None,
                *,
                mesh=None,
                worker_axes: tuple[str, ...] = ("workers",),
                solver: str = "smo",
                smo_cfg: smo_mod.SMOConfig = smo_mod.SMOConfig(),
                kernel: K.KernelParams = K.KernelParams(),
                engine: Optional[KE.EngineConfig | str] = None,
                schedule_cfg: Optional[MC.ScheduleConfig] = None,
                shard: str = "task",
                alpha0: Optional[np.ndarray] = None,
                svr_epsilon: Optional[float] = None,
                device: str | torch.device = "cuda") -> TaskSetFit:
    """Fit every binary task of ``taskset``, one batched SMO per schedule
    bucket, on ``device``.

    ``schedule`` defaults to a fresh pow2-bucketed build (``schedule_cfg``
    tunes it). ``engine`` is an ``EngineConfig`` or backend name applied
    per bucket (``auto``: dense up to ``dense_limit`` columns; None is
    dense, as in the reference); the row cache is dropped, as under the
    reference's vmap. ``alpha0`` is a (C, max_k) warm start in the
    ``TaskSetFit.alpha`` layout; ``svr_epsilon`` switches every task to
    the doubled epsilon-SVR spec (task ``y`` = targets, returned
    ``alpha`` = beta).
    """
    _check_options(mesh, worker_axes, solver, shard)
    dev = resolve_device(device)
    if schedule is None:
        cfg = schedule_cfg if schedule_cfg is not None else MC.ScheduleConfig()
        schedule = MC.build_schedule(taskset.sizes,
                                     dataclasses.replace(cfg, n_workers=1))
    if schedule.n_workers != 1:
        raise ValueError(f"schedule laid out for {schedule.n_workers} "
                         "workers but this fit runs on one device")
    sizes = taskset.sizes
    c = taskset.n_tasks
    alpha = np.zeros((c, int(sizes.max())), np.float32)
    b = np.zeros(c, np.float32)
    n_iter = np.zeros(c, np.int64)
    converged = np.zeros(c, bool)
    for bucket in schedule.buckets:
        xt, yt, mk, a0 = _bucket_arrays(taskset, bucket, alpha0)
        r = _fit_bucket(*(None if a is None else torch.from_numpy(a).to(dev)
                          for a in (xt, yt, mk, a0)),
                        smo_cfg=smo_cfg, kernel=kernel, engine=engine,
                        svr_epsilon=svr_epsilon)
        r_alpha, r_b, r_iter, r_conv = (t.cpu().numpy() for t in (
            r.alpha, r.b, r.n_iter, r.converged))
        for s, t in enumerate(bucket.task_ids.reshape(-1)):
            if t < 0:
                continue
            k = int(sizes[t])
            alpha[t, :k] = r_alpha[s, :k]
            b[t] = r_b[s]
            n_iter[t] = r_iter[s]
            converged[t] = r_conv[s]
    return TaskSetFit(alpha=alpha, b=b, n_iter=n_iter, converged=converged,
                      sizes=sizes)


def taskset_from_ovo(tasks: OvOTasks) -> MC.TaskSet:
    """Legacy padded ``OvOTasks`` stack -> variable-length TaskSet.
    Fully-masked padding tasks (the ``pad_tasks_to`` dummies) are
    dropped; they must be trailing."""
    cls_index = {c: i for i, c in enumerate(tasks.classes)}
    out = []
    seen_empty = False
    for t in range(tasks.x.shape[0]):
        k = int(tasks.mask[t].sum())
        if k == 0:
            seen_empty = True
            continue
        if seen_empty:
            raise ValueError(
                f"fully-masked OvOTasks entry precedes real task {t}; "
                f"padding tasks must be trailing (ovo.build_tasks "
                f"pad_tasks_to appends them)")
        if not tasks.mask[t, :k].all():
            raise ValueError(f"OvOTasks mask for task {t} is not a "
                             f"prefix; cannot convert to a TaskSet")
        a, b = tasks.pairs[t]
        out.append(MC.BinaryTask(
            x=np.asarray(tasks.x[t, :k], np.float32),
            y=np.asarray(tasks.y[t, :k], np.float32),
            pos=cls_index[a], neg=cls_index[b]))
    return MC.TaskSet(tasks=tuple(out), classes=tasks.classes,
                      strategy="ovo")


def vmapped_ovo_fit(tasks: OvOTasks, *, solver: str = "smo",
                    smo_cfg: smo_mod.SMOConfig = smo_mod.SMOConfig(),
                    kernel: K.KernelParams = K.KernelParams(),
                    engine: Optional[KE.EngineConfig | str] = None,
                    device: str | torch.device = "cuda") -> OvOFit:
    """Legacy shim: the padded OvO stack fitted by ``fit_taskset`` in one
    bucket at the original padded width, results re-expanded to the
    (c_total, n_task) layout (dummy tasks report converged)."""
    c_total, n_task = tasks.y.shape
    taskset = taskset_from_ovo(tasks)
    fit = fit_taskset(
        taskset, solver=solver, smo_cfg=smo_cfg, kernel=kernel,
        engine=engine, device=device,
        schedule_cfg=MC.ScheduleConfig(bucket_by="none", pad_width=n_task))
    c_real = taskset.n_tasks
    alpha = np.zeros((c_total, n_task), np.float32)
    alpha[:c_real, :fit.alpha.shape[1]] = fit.alpha
    b = np.zeros(c_total, np.float32)
    b[:c_real] = fit.b
    n_iter = np.zeros(c_total, np.int64)
    n_iter[:c_real] = fit.n_iter
    converged = np.ones(c_total, bool)
    converged[:c_real] = fit.converged
    return OvOFit(alpha=torch.from_numpy(alpha), b=torch.from_numpy(b),
                  n_iter=torch.from_numpy(n_iter),
                  converged=torch.from_numpy(converged))
