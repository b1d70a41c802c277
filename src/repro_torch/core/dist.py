"""The multiclass task layer: every binary task of a TaskSet, one batched
SMO per schedule bucket.

Mirrors the task-parallel, single-device part of ``repro/core/dist.py``
(paper Fig. 4, ``MPI-CUDA_multiSMO``): C = m(m-1)/2 (OvO) or m (OvR)
binary problems, grouped by the size-bucketed ``Schedule``
(``core/multiclass.py``). The reference vmaps ``binary_smo`` (or
``binary_gd``) over each bucket; here each bucket is stacked into
(T, w, d) and solved by ``smo.solve_qp_tasks`` — one batched SMO whose
every iteration is one selection launch and two row launches for the
whole bucket, and whose host check reads one flag per ``check_every``
block; each task freezes when its own gap closes, so its result is
that of the task solved alone — or, with ``solver="gd"``, by
``gd.binary_gd_tasks``: the bucket's tasks step together, one
task-axis matvec launch a step, each task as its lone ``binary_gd``.

``fit_taskset`` runs on ``device`` ("cuda" by default; "cpu" must be
asked for), or with a ``mesh`` (``launch.mesh``) on the mesh's ranks:
then it is a collective call (every rank calls it with the same
arguments and gets the same full result) and ``shard`` picks the axis
of parallelism per bucket, as in the reference — ``"task"`` (each rank
solves the run of slots the LPT layout gave it; one all_reduce a bucket
hands every rank all results), ``"data"`` (each task in turn through
``smo.sharded_binary_smo``, its samples over the whole mesh) or
``"auto"`` (data-parallel for a bucket of tasks at least
``data_min_width`` wide and fewer than the workers). ``shard="cascade"``
is not a mode of the task layer (the cascade is ``SVC`` /
``SVR(shard="cascade")``) and raises ValueError, as in the reference.
``vmapped_ovo_fit`` / ``distributed_ovo_fit`` are the legacy shims over
it for the padded ``ovo.OvOTasks`` stack; ``sequential_ovo_fit`` is the
paper's "Multi-Tensorflow": one separately dispatched solve per task.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import gd as gd_mod
from repro_torch.core import kernel_engine as KE
from repro_torch.core import kernels as K
from repro_torch.core import multiclass as MC
from repro_torch.core import smo as smo_mod
from repro_torch.core.ovo import OvOTasks

# fit_taskset(shard="auto") sends a bucket data-parallel only when its
# tasks are wide enough to amortize the per-iteration collectives AND too
# few to keep every worker busy under task parallelism
DATA_PARALLEL_MIN_WIDTH = 2048


class OvOFit(NamedTuple):
    alpha: torch.Tensor      # (C, n_task)
    b: torch.Tensor          # (C,)
    n_iter: torch.Tensor     # (C,)
    converged: torch.Tensor  # (C,) bool (always True for GD: fixed steps)


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
    """Worker count of a task-parallel layout: the product of the mesh
    extents over ``worker_axes`` (1 without a mesh). Validates the axis
    names up front, as the reference does; shared by ``fit_taskset`` and
    the ``SVC`` / ``SVR`` routing."""
    if mesh is None:
        return 1
    missing = tuple(a for a in worker_axes if a not in mesh.shape)
    if missing:
        raise ValueError(
            f"worker axes {missing} are not axes of the mesh "
            f"(mesh axes: {tuple(mesh.shape)}); pass worker_axes "
            f"matching the mesh (make_shard_mesh's default axis is "
            f"'shards')")
    return int(np.prod([mesh.shape[a] for a in worker_axes]))


def validate_data_shard(mesh, worker_axes, solver: str) -> None:
    """Hard requirements of the sample-sharded (``shard="data"``) path,
    shared by ``fit_taskset`` and ``SVC`` / ``SVR``: an explicit data
    request that cannot be honored raises, never degrades to a local
    task-parallel fit."""
    if mesh is None:
        raise ValueError("shard='data' needs a mesh to shard the sample "
                         "axis over (e.g. launch.mesh.make_shard_mesh)")
    if solver != "smo":
        raise ValueError("shard='data' requires solver='smo' (the GD "
                         "baseline has no sharded path)")
    if len(worker_axes) != 1:
        raise ValueError("shard='data' shards the sample axis over "
                         "exactly one mesh axis; got "
                         f"worker_axes={tuple(worker_axes)}")
    if worker_axes[0] not in mesh.shape:
        raise ValueError(
            f"worker axis {worker_axes[0]!r} is not an axis of the mesh "
            f"(axes: {tuple(mesh.shape)}); pass worker_axes matching the "
            f"mesh (make_shard_mesh's default axis is 'shards')")


def _wants_data_parallel(shard: str, bucket: MC.Bucket, n_real: int,
                         n_workers: int, solver: str, mesh,
                         worker_axes, data_min_width: int) -> bool:
    """Per-bucket parallelism mode: explicit ``shard="data"`` validates
    hard; ``"auto"`` goes data-parallel only for wide tasks (collectives
    amortized over O(width) row work) too few to fill the workers."""
    if shard == "data":
        validate_data_shard(mesh, worker_axes, solver)
        return True
    if shard == "task" or mesh is None or n_workers <= 1:
        return False
    return (solver == "smo" and len(worker_axes) == 1
            and bucket.width >= data_min_width and n_real < n_workers)


def _check_options(solver: str, shard: str, warm: bool) -> None:
    if solver not in ("smo", "gd"):
        raise ValueError(f"unknown solver {solver!r}")
    if shard not in ("task", "data", "auto"):
        raise ValueError(f"unknown shard mode {shard!r}; expected "
                         "'task', 'data' or 'auto' (the cascade is "
                         "SVC / SVR(shard='cascade'))")
    if warm:
        if solver != "smo":
            raise ValueError(
                "alpha0 warm starts / svr_epsilon tasks require "
                f"solver='smo' (got solver={solver!r})")
        if shard == "data":
            raise ValueError(
                "alpha0/svr_epsilon run on the task-parallel path only; "
                "shard='data' (sharded_binary_smo) has no warm-start or "
                "SVR-taskset support — use shard='task' or 'auto'")


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


def _solve_slots(taskset: MC.TaskSet, bucket: MC.Bucket, alpha0, dev, *,
                 solver, smo_cfg, gd_cfg, kernel, engine, svr_epsilon):
    """One batched solve of ``bucket``'s slots on ``dev``: {task id:
    (alpha row, b, n_iter, converged)} for its real tasks."""
    xt, yt, mk, a0 = (None if a is None else torch.from_numpy(a).to(dev)
                      for a in _bucket_arrays(taskset, bucket, alpha0))
    if solver == "gd":
        r = gd_mod.binary_gd_tasks(xt, yt, mk, cfg=gd_cfg, kernel=kernel,
                                   engine=engine)
        r_iter = np.full(len(yt), gd_cfg.steps, np.int64)
        r_conv = np.ones(len(yt), bool)
    else:
        r = _fit_bucket(xt, yt, mk, a0, smo_cfg=smo_cfg, kernel=kernel,
                        engine=engine, svr_epsilon=svr_epsilon)
        r_iter, r_conv = r.n_iter.cpu().numpy(), r.converged.cpu().numpy()
    r_alpha, r_b = r.alpha.cpu().numpy(), r.b.cpu().numpy()
    return {int(t): (r_alpha[s], r_b[s], r_iter[s], r_conv[s])
            for s, t in enumerate(bucket.task_ids.reshape(-1)) if t >= 0}


def _task_parallel_bucket(taskset: MC.TaskSet, bucket: MC.Bucket, alpha0,
                          mesh, **solve):
    """A bucket over the mesh's workers: this rank solves the run of
    slots the LPT layout gave it (row ``mesh.rank`` of the grid; dummy
    slots are not run), then ONE all_reduce SUM of a zero-filled
    (tasks, width + 3) float64 buffer, each rank writing its tasks' rows
    (alpha, b, n_iter, converged: exact in float64), hands every rank
    every result."""
    real = [int(t) for t in bucket.task_ids.reshape(-1) if t >= 0]
    row = {t: k for k, t in enumerate(real)}
    width = bucket.width
    buf = np.zeros((len(real), width + 3), np.float64)  # repro: noqa[R002] -- exact carrier of float32 alphas and int iteration counts through one all_reduce
    mine = bucket.task_ids[mesh.rank]
    mine = mine[mine >= 0]
    if len(mine):
        own = MC.Bucket(width=width, task_ids=mine[None])
        for t, (a, b, it, cv) in _solve_slots(taskset, own, alpha0,
                                              mesh.device, **solve).items():
            buf[row[t], :width] = a
            buf[row[t], width:] = (b, it, cv)
    out = mesh.all_reduce(torch.from_numpy(buf).to(mesh.device)).cpu().numpy()
    return {t: (out[k, :width].astype(np.float32), out[k, width],
                int(out[k, width + 1]), bool(out[k, width + 2]))
            for t, k in row.items()}


def _data_parallel_bucket(taskset: MC.TaskSet, bucket: MC.Bucket, *, mesh,
                          axis: str, smo_cfg: smo_mod.SMOConfig,
                          kernel: K.KernelParams, engine):
    """Solve one bucket's tasks one after another, each sample-sharded
    over the whole mesh axis (``smo.sharded_binary_smo``), padded to the
    bucket width as in the reference: {task id: (alpha row, b, n_iter,
    converged)}."""
    outs = {}
    for t in (int(t) for t in bucket.task_ids.reshape(-1) if t >= 0):
        task = taskset.tasks[t]
        k = task.size
        xt = np.zeros((bucket.width, task.x.shape[1]), np.float32)
        yt = np.zeros((bucket.width,), np.float32)
        mk = np.zeros((bucket.width,), bool)
        xt[:k], yt[:k], mk[:k] = task.x, task.y, True
        r = smo_mod.sharded_binary_smo(xt, yt, mk, mesh=mesh, axis=axis,
                                       cfg=smo_cfg, kernel=kernel,
                                       engine=engine)
        outs[t] = (r.alpha.cpu().numpy(), float(r.b), int(r.n_iter),
                   bool(r.converged))
    return outs


def fit_taskset(taskset: MC.TaskSet,
                schedule: Optional[MC.Schedule] = None,
                *,
                mesh=None,
                worker_axes: tuple[str, ...] = ("workers",),
                solver: str = "smo",
                smo_cfg: smo_mod.SMOConfig = smo_mod.SMOConfig(),
                gd_cfg: gd_mod.GDConfig = gd_mod.GDConfig(),
                kernel: K.KernelParams = K.KernelParams(),
                engine: Optional[KE.EngineConfig | str] = None,
                schedule_cfg: Optional[MC.ScheduleConfig] = None,
                shard: str = "task",
                data_min_width: int = DATA_PARALLEL_MIN_WIDTH,
                alpha0: Optional[np.ndarray] = None,
                svr_epsilon: Optional[float] = None,
                device: str | torch.device = "cuda") -> TaskSetFit:
    """Fit every binary task of ``taskset``, one batched SMO (or, with
    ``solver="gd"``, one batched GD of ``gd_cfg``) per schedule bucket,
    on ``device`` — or, with a ``mesh``, on the mesh's ranks (a
    collective call on ``mesh.device``; ``device`` is not read).

    ``schedule`` defaults to a fresh pow2-bucketed build for the mesh's
    worker count (``schedule_cfg`` tunes it). ``shard`` picks the axis
    of parallelism per bucket (see the module docstring): ``"task"``,
    ``"data"`` (needs a mesh with one worker axis and ``solver="smo"``)
    or ``"auto"`` (``data_min_width``). ``engine`` is an
    ``EngineConfig`` or backend name applied per bucket (``auto``: dense
    up to ``dense_limit`` columns; None is dense, as in the reference);
    the row cache is dropped, as under the reference's vmap, except in a
    data-parallel solve, whose engine is the ``sharded`` backend with
    ``engine``'s knobs. ``alpha0`` is a (C, max_k) warm start in the
    ``TaskSetFit.alpha`` layout; ``svr_epsilon`` switches every task to
    the doubled epsilon-SVR spec (task ``y`` = targets, returned
    ``alpha`` = beta). Both need ``solver="smo"`` and never route
    data-parallel (``shard="data"`` with them raises, as in the
    reference). GD tasks report ``n_iter = steps`` and ``converged``
    True, as in the reference. Each task's result is the one it gets
    alone, whatever the layout: a mesh fit with ``shard="task"`` equals
    the fit without one bit for bit.
    """
    n_workers = resolve_worker_count(mesh, tuple(worker_axes))
    warm = alpha0 is not None or svr_epsilon is not None
    _check_options(solver, shard, warm)
    dev = resolve_device(device) if mesh is None else mesh.device
    if schedule is None:
        cfg = schedule_cfg if schedule_cfg is not None else MC.ScheduleConfig()
        schedule = MC.build_schedule(
            taskset.sizes, dataclasses.replace(cfg, n_workers=n_workers))
    if schedule.n_workers != n_workers:
        raise ValueError(f"schedule laid out for {schedule.n_workers} "
                         f"workers but the fit has {n_workers}")
    solve = dict(solver=solver, smo_cfg=smo_cfg, gd_cfg=gd_cfg,
                 kernel=kernel, engine=engine, svr_epsilon=svr_epsilon)
    sizes = taskset.sizes
    c = taskset.n_tasks
    alpha = np.zeros((c, int(sizes.max())), np.float32)
    b = np.zeros(c, np.float32)
    n_iter = np.zeros(c, np.int64)
    converged = np.zeros(c, bool)
    for bucket in schedule.buckets:
        n_real = int((bucket.task_ids >= 0).sum())
        if not warm and _wants_data_parallel(
                shard, bucket, n_real, n_workers, solver, mesh,
                worker_axes, data_min_width):
            results = _data_parallel_bucket(
                taskset, bucket, mesh=mesh, axis=worker_axes[0],
                smo_cfg=smo_cfg, kernel=kernel, engine=engine)
        elif mesh is None:
            results = _solve_slots(taskset, bucket, alpha0, dev, **solve)
        else:
            results = _task_parallel_bucket(taskset, bucket, alpha0, mesh,
                                            **solve)
        for t, (a, bt, it, cv) in results.items():
            k = int(sizes[t])
            alpha[t, :k] = a[:k]
            b[t], n_iter[t], converged[t] = bt, it, cv
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


def _ovo_fit_shim(tasks: OvOTasks, mesh, worker_axes, *, solver, smo_cfg,
                  gd_cfg, kernel, engine, device) -> OvOFit:
    """The padded OvO stack fitted by ``fit_taskset`` in one bucket at
    the original padded width, results re-expanded to the (c_total,
    n_task) layout (dummy tasks report converged)."""
    c_total, n_task = tasks.y.shape
    taskset = taskset_from_ovo(tasks)
    fit = fit_taskset(
        taskset, mesh=mesh, worker_axes=worker_axes, solver=solver,
        smo_cfg=smo_cfg, gd_cfg=gd_cfg, kernel=kernel, engine=engine,
        device=device,
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


def vmapped_ovo_fit(tasks: OvOTasks, *, solver: str = "smo",
                    smo_cfg: smo_mod.SMOConfig = smo_mod.SMOConfig(),
                    gd_cfg: gd_mod.GDConfig = gd_mod.GDConfig(),
                    kernel: K.KernelParams = K.KernelParams(),
                    engine: Optional[KE.EngineConfig | str] = None,
                    device: str | torch.device = "cuda") -> OvOFit:
    """Legacy shim: the padded OvO stack fitted on one device by
    ``fit_taskset`` (see ``_ovo_fit_shim``)."""
    return _ovo_fit_shim(tasks, None, ("workers",), solver=solver,
                         smo_cfg=smo_cfg, gd_cfg=gd_cfg, kernel=kernel,
                         engine=engine, device=device)


def distributed_ovo_fit(tasks: OvOTasks, mesh,
                        worker_axes: tuple[str, ...] = ("workers",), *,
                        solver: str = "smo",
                        smo_cfg: smo_mod.SMOConfig = smo_mod.SMOConfig(),
                        gd_cfg: gd_mod.GDConfig = gd_mod.GDConfig(),
                        kernel: K.KernelParams = K.KernelParams(),
                        engine: Optional[KE.EngineConfig | str] = None
                        ) -> OvOFit:
    """Legacy shim: the padded OvO stack, its task axis over
    ``worker_axes`` of ``mesh``, through ``fit_taskset`` (a collective
    call). The task count must be divisible by the worker count (build
    the tasks with ``pad_tasks_to=n_workers``), as in the reference."""
    n_workers = resolve_worker_count(mesh, tuple(worker_axes))
    c_total = tasks.x.shape[0]
    if c_total % n_workers:
        raise ValueError(
            f"task count {c_total} not divisible by {n_workers} workers; "
            f"build tasks with pad_tasks_to={n_workers}")
    return _ovo_fit_shim(tasks, mesh, worker_axes, solver=solver,
                         smo_cfg=smo_cfg, gd_cfg=gd_cfg, kernel=kernel,
                         engine=engine, device=mesh.device)


def sequential_ovo_fit(tasks: OvOTasks, *, solver: str = "gd",
                       smo_cfg: smo_mod.SMOConfig = smo_mod.SMOConfig(),
                       gd_cfg: gd_mod.GDConfig = gd_mod.GDConfig(),
                       kernel: K.KernelParams = K.KernelParams(),
                       engine: Optional[KE.EngineConfig | str] = None,
                       n_real_tasks: Optional[int] = None,
                       device: str | torch.device = "cuda") -> OvOFit:
    """The paper's "Multi-Tensorflow": one solve per task of the padded
    OvO stack, dispatched one after another on ``device`` — on purpose
    not batched, to reproduce the baseline's execution profile.
    ``solver`` is "gd" (the baseline) or "smo"; the first
    ``n_real_tasks`` tasks are solved (all by default). Returns device
    tensors stacked over the tasks."""
    if solver not in ("smo", "gd"):
        raise ValueError(f"unknown solver {solver!r}")
    dev = resolve_device(device)
    c_total = tasks.x.shape[0] if n_real_tasks is None else n_real_tasks
    outs = []
    for t in range(c_total):
        xt, yt, mt = (torch.from_numpy(np.asarray(a[t])).to(dev)
                      for a in (tasks.x, tasks.y, tasks.mask))
        if solver == "gd":
            r = gd_mod.binary_gd(xt, yt, mt, cfg=gd_cfg, kernel=kernel,
                                 engine=engine)
            conv = torch.ones((), dtype=torch.bool, device=dev)
        else:
            r = smo_mod.binary_smo(xt, yt, mt, cfg=smo_cfg, kernel=kernel,
                                   engine=engine)
            conv = r.converged
        outs.append(OvOFit(r.alpha, r.b, r.n_iter, conv))
    return OvOFit(*(torch.stack(f) for f in zip(*outs)))
