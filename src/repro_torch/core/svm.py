"""Public SVM API of the port — ``SVC`` (binary and multiclass) and
epsilon-``SVR``.

    clf = SVC(kernel="rbf", C=1.0)                    # paper's CUDA path
    clf = SVC(engine="pallas", shrink_every=4)        # hand-written kernels
    clf = SVC(engine="rff", rank=1024)                # low-rank tier
    clf = SVC(strategy="ovr")                         # one-vs-rest
    clf = SVC(decision="margin")                      # OvO summed margins
    clf = SVC(solver="gd", gd_steps=2000)             # paper's TF baseline
    clf = SVC(shard="cascade", cascade_shards=4)      # hierarchical cascade
    clf.fit(X, y); clf.predict(Xt); clf.score(Xt, yt)  # binary or multiclass
    reg = SVR(epsilon=0.1, engine="pallas").fit(X, y); reg.score(Xt, yt)

Mirrors the SMO, GD, cascade, low-rank, multiclass and SVR paths of
``repro/core/svm.py``. ``fit`` runs on ``device`` ("cuda" by default;
"cpu" must be asked for) and keeps the reference's conventions:
``classes_[1]`` maps to +1 in a binary fit, so a positive margin
predicts ``classes_[1]`` (sklearn orientation); a multiplier counts as
a support vector above ``1e-8 * C`` (``|beta|`` for SVR); a gamma <= 0
("scale") is re-resolved from the data on every fit; single-class input
raises.

Exact engines train by SMO (``core/smo.py``), or with ``solver="gd"``
by the paper's fixed-step projected gradient descent (``core/gd.py``:
``gd_steps`` steps of ``gd_lr``, one engine matvec a step;
``converged_`` is True, as in the reference); the low-rank engines
(``engine="nystrom" | "rff"`` with ``rank`` / ``landmarks`` / ``seed``)
train by dual coordinate descent on an explicit feature map
(``core/approx.py`` + ``core/linear.py``), with ``max_iter`` bounding
the epochs. After ``fit`` the model keeps only its serving state, and
``predict`` / ``decision_function`` answer through a cached
``serve.Predictor`` over ``serve.pack(self)`` — the same artifact
``serve.save`` writes.

Multiclass fits go through the strategy layer (``core/multiclass.py``):
``strategy`` picks the decomposition ("ovo" pairwise, "ovr"
one-vs-rest), ``decision`` the OvO aggregation ("vote" majority,
"margin" summed tanh margins; OvR always argmaxes). Exact engines solve
one batched SMO per schedule bucket (``dist.fit_taskset``), each bucket
at its own pow2 width (``schedule="bucketed"``) or every task at the
widest (``schedule="padded"``); the support vectors are then compacted
into pow2 SV-width serving buckets. Low-rank engines draw one feature
map over all of X, transform it once and fit each task by DCD on its
rows of it, so serving is one transform and a (n_tasks, rank) product.

``shard="cascade"`` trains hierarchically (``core/cascade.py``): the
data in ``cascade_shards`` round-robin shards solved independently,
support-vector unions merged up a binary tree, and feedback rounds (at
most ``cascade_rounds``) until the full-dataset float64 KKT certificate
passes at the solver tol — ``converged_`` reports the certificate, and
``cascade_rounds_`` / ``cascade_kkt_`` / ``cascade_history_`` the
trail (per task, rounds and certificate only, for a multiclass fit). It
needs ``solver="smo"``; on a low-rank engine it runs over row slices of
the one feature map (DCD nodes, the solver knob ignored). The serving
state has the shape of every other path's, so ``serve.pack`` and the
``Predictor`` work unchanged.

Not ported yet, and raising NotImplementedError until their slice:
``shard="data" | "auto"``, a ``mesh`` (ROADMAP A.11).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import approx, dist, gd
from repro_torch.core import cascade as cascade_mod
from repro_torch.core import kernel_engine as KE
from repro_torch.core import kernels as K
from repro_torch.core import linear
from repro_torch.core import multiclass as MC
from repro_torch.core import smo
from repro_torch import serve

# Support threshold, RELATIVE to the box constraint: alpha > _SV_EPS * C
# counts as a support vector (an absolute cutoff would drop every SV
# once C < eps).
_SV_EPS = 1e-8


def _sv_threshold(C: float) -> float:
    return _SV_EPS * float(C)


def _host(a) -> np.ndarray:
    """numpy view of a result field (a tensor on any device, or already
    host numpy, as a cascade's)."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _cascade_attrs(model, r: cascade_mod.CascadeResult) -> None:
    """A binary cascade's trail; ``converged_`` is its certificate."""
    model.n_iter_ = int(r.n_iter)
    model.converged_ = bool(r.converged)
    model.cascade_rounds_ = int(r.rounds)
    model.cascade_kkt_ = float(r.kkt)
    model.cascade_history_ = r.history


def _check_modes(solver: str, shard: str, mesh) -> None:
    if solver not in ("smo", "gd"):
        raise ValueError(f"unknown solver {solver!r}; expected 'smo' or "
                         "'gd'")
    if shard not in ("task", "data", "auto", "cascade"):
        raise ValueError(f"unknown shard mode {shard!r}; expected "
                         "'task', 'data', 'auto' or 'cascade'")
    if shard in ("data", "auto") or mesh is not None:
        raise NotImplementedError(
            f"shard={shard!r} / a mesh is not ported yet; data-parallel "
            "SMO over several devices comes with ROADMAP A.11")


def _engine_config(engine, rank: int, landmarks: str,
                   seed: int) -> KE.EngineConfig:
    """rank / landmarks / seed ride in EngineConfig, so an explicit
    EngineConfig instance carries its own values."""
    cfg = (engine if isinstance(engine, KE.EngineConfig)
           else KE.EngineConfig(backend=engine, rank=rank,
                                landmarks=landmarks, seed=seed))
    KE.check_backend(cfg.backend)
    return cfg


def _fit_inputs(model, x) -> tuple[np.ndarray, torch.Tensor]:
    """float32 host copy and device tensor of the training matrix, with
    gamma "scale" re-resolved from THIS data."""
    x = np.asarray(x, np.float32)
    xt = torch.from_numpy(x).to(model.device)
    model.kernel_params = K.resolve_gamma(model._kernel_cfg, xt)
    return x, xt


def _engine_values(model, xt: np.ndarray) -> np.ndarray:
    """Pre-predictor path of a fit: the feature transform and ``w`` for
    a low-rank fit, else a ``KernelEngine`` over the support vectors
    and ``engine.decide`` (the ``decision`` kernel under
    ``engine="pallas"``). A multiclass fit gives the (n_tasks, nt)
    stacked decisions: one transform and the stacked ``task_w_``, or one
    engine per task of each serving bucket."""
    if not model._fitted:
        raise ValueError(f"{type(model).__name__} is not fitted yet (call "
                         ".fit first)")
    dev = model.device
    z = torch.from_numpy(np.asarray(xt, np.float32)).to(dev)
    multiclass = not getattr(model, "_binary", True)
    if model._feature_map is not None:
        phi = model._feature_map.transform(z)
        if multiclass:
            w = torch.from_numpy(model.task_w_).to(dev)
            b = torch.from_numpy(model.task_b_).to(dev)
            return ((phi @ w.T).T + b[:, None]).cpu().numpy()
        w = torch.from_numpy(model.w_).to(dev)
        return (phi @ w + model.b_).cpu().numpy()
    scfg = serve.serving_config(model.engine_cfg)
    if multiclass:
        df = np.zeros((model._taskset.n_tasks, z.shape[0]), np.float32)
        for g in model._serving_buckets:
            for t, sv, coef, b in zip(g.task_ids, g.sv_x, g.sv_coef, g.b):
                eng = KE.make_engine(torch.from_numpy(sv).to(dev),
                                     model.kernel_params, scfg)
                df[t] = eng.decide(z, torch.from_numpy(coef).to(dev),
                                   float(b)).cpu().numpy()
        return df
    if model.n_support_ == 0:  # degenerate fit: constant decision
        return np.full(z.shape[0], model.b_, np.float32)
    eng = KE.make_engine(torch.from_numpy(model.support_vectors_).to(dev),
                         model.kernel_params, scfg)
    coef = torch.from_numpy(model.dual_coef_).to(dev)
    return eng.decide(z, coef, model.b_).cpu().numpy()


def _predictor(model) -> "serve.Predictor":
    """The cached serving engine of a fit (one per serving engine
    config; the bank stays resident on the device). Repacked on refit."""
    if not model._fitted:
        raise ValueError(f"{type(model).__name__} is not fitted yet (call "
                         ".fit first)")
    scfg = serve.serving_config(model.engine_cfg)
    pred = model._predictors.get(scfg)
    if pred is None:
        pred = serve.Predictor(serve.pack(model), engine=scfg,
                               device=model.device)
        model._predictors[scfg] = pred
    return pred


class SVC:
    def __init__(self, *, kernel: str = "rbf", C: float = 1.0,
                 gamma: float = -1.0, degree: int = 3, coef0: float = 0.0,
                 tol: float = 1e-3, max_iter: int = 100_000,
                 solver: str = "smo", gd_lr: float = 0.01,
                 gd_steps: int = 300,
                 engine: str | KE.EngineConfig = "auto",
                 rank: int = 256, landmarks: str = "uniform",
                 seed: int = 0,
                 shrink_every: int = 0,
                 strategy: str | MC.MulticlassStrategy = "ovo",
                 decision: str = "vote",
                 schedule: str = "bucketed",
                 mesh=None,
                 shard: str = "task",
                 cascade_shards: int = 4,
                 cascade_rounds: int = 8,
                 device: str | torch.device = "cuda"):
        _check_modes(solver, shard, mesh)
        self.device = resolve_device(device)
        # the constructor keeps the gamma<=0 "scale" sentinel; fit()
        # re-resolves from it each call (sklearn semantics)
        self._kernel_cfg = K.KernelParams(name=kernel, gamma=gamma,
                                          degree=degree, coef0=coef0)
        self.kernel_params = self._kernel_cfg
        self.smo_cfg = smo.SMOConfig(C=C, tol=tol, max_iter=max_iter,
                                     shrink_every=shrink_every)
        self.gd_cfg = gd.GDConfig(C=C, lr=gd_lr, steps=gd_steps)
        self.solver = solver
        self.engine_cfg = _engine_config(engine, rank, landmarks, seed)
        # max_iter bounds both solvers: SMO pair updates and (as epochs)
        # the low-rank DCD sweeps
        self.dcd_cfg = linear.DCDConfig(C=C, tol=tol, max_epochs=max_iter)
        self.shard = shard
        self.cascade_cfg = cascade_mod.CascadeConfig(shards=cascade_shards,
                                                     rounds=cascade_rounds)
        self.strategy = MC.get_strategy(strategy)
        if decision not in ("vote", "margin"):
            raise ValueError(f"unknown OvO decision {decision!r}; "
                             "expected 'vote' or 'margin'")
        self.decision = decision
        if schedule not in ("bucketed", "padded"):
            raise ValueError(f"unknown schedule {schedule!r}; "
                             "expected 'bucketed' or 'padded'")
        self.schedule = schedule
        self._fitted = False

    # ------------------------------------------------------------------ fit
    def fit(self, x: np.ndarray, y: np.ndarray) -> "SVC":
        x, xt = _fit_inputs(self, x)
        y = np.asarray(y)
        classes = np.unique(y)
        if len(classes) < 2:
            raise ValueError(
                f"SVC.fit needs >= 2 classes in y, got {len(classes)} "
                f"({classes.tolist()}); a single-class problem has no "
                f"decision boundary to learn")
        self.classes_ = classes
        self._predictors: dict = {}
        self._feature_map = None
        self._binary = len(classes) == 2
        lowrank = self.engine_cfg.backend in KE.LOWRANK_BACKENDS
        if not self._binary:
            if lowrank:
                self._fit_multiclass_lowrank(x, xt, y)
            else:
                self._fit_multiclass(x, y)
            self._fitted = True
            return self
        # sklearn orientation: classes_[1] maps to +1
        yy = np.where(y == classes[1], 1.0, -1.0).astype(np.float32)
        yt = torch.from_numpy(yy).to(self.device)
        if lowrank:
            self._fit_binary_lowrank(xt, yt)
        elif self.shard == "cascade":
            cascade_mod.validate_cascade(self.solver, self.cascade_cfg)
            r = cascade_mod.cascade_binary(
                x, yy, smo_cfg=self.smo_cfg, kernel=self.kernel_params,
                engine=self.engine_cfg, cascade=self.cascade_cfg,
                device=self.device)
            _cascade_attrs(self, r)
            self.alpha_, self.b_ = r.alpha, r.b
        elif self.solver == "smo":
            r = smo.binary_smo(xt, yt, cfg=self.smo_cfg,
                               kernel=self.kernel_params,
                               engine=self.engine_cfg)
            self.n_iter_ = int(r.n_iter)
            self.converged_ = bool(r.converged)
            self.alpha_ = r.alpha.cpu().numpy()
            self.b_ = float(r.b)
        else:
            r = gd.binary_gd(xt, yt, cfg=self.gd_cfg,
                             kernel=self.kernel_params,
                             engine=self.engine_cfg)
            self.n_iter_ = int(r.n_iter)
            self.converged_ = True
            self.loss_curve_ = r.loss_curve.cpu().numpy()
            self.alpha_ = r.alpha.cpu().numpy()
            self.b_ = float(r.b)
        # serving state: compacted support-vector set only
        sv = self.alpha_ > _sv_threshold(self.smo_cfg.C)
        self.support_ = np.where(sv)[0]
        self.n_support_ = int(sv.sum())
        self.support_vectors_ = x[sv]
        self.dual_coef_ = (self.alpha_ * yy)[sv].astype(np.float32)
        self._fitted = True
        return self

    def _fit_binary_lowrank(self, xt: torch.Tensor, yt: torch.Tensor) -> None:
        """Approximate-kernel binary fit: explicit low-rank features
        (``core/approx.py``) + the O(n k) dual coordinate descent
        (``core/linear.py``), or its cascade over row slices of the one
        map; no (n, n) object is ever formed."""
        fmap = approx.make_feature_map(xt, self.kernel_params,
                                       self.engine_cfg)
        phi = fmap.transform(xt)
        self._feature_map = fmap
        if self.shard == "cascade":
            # the solver knob is ignored on this path: don't validate it
            cascade_mod.validate_cascade(None, self.cascade_cfg)
            r = cascade_mod.cascade_dcd(phi, yt.cpu().numpy(),
                                        dcd_cfg=self.dcd_cfg,
                                        cascade=self.cascade_cfg)
            _cascade_attrs(self, r)
            self.alpha_, self.b_, self.w_ = r.alpha, r.b, r.w
            return
        r = linear.linear_svc(phi, yt, cfg=self.dcd_cfg)
        self.alpha_ = r.alpha.cpu().numpy()
        self.b_ = float(r.b)
        self.w_ = r.w.cpu().numpy()
        self.n_iter_ = int(r.n_iter)
        self.converged_ = bool(r.converged)

    def _fit_multiclass(self, x: np.ndarray, y: np.ndarray) -> None:
        """Every binary task of the strategy's TaskSet, one batched SMO
        (or GD) per schedule bucket (``dist.fit_taskset``), or a cascade
        per task, then the pow2 SV-width serving compaction."""
        taskset = self.strategy.build_taskset(x, y)
        if self.shard == "cascade":
            cascade_mod.validate_cascade(self.solver, self.cascade_cfg)
            sched = None
            fit = self._fit_taskset_cascade(taskset)
        else:
            bucket_by = "pow2" if self.schedule == "bucketed" else "none"
            sched = MC.build_schedule(taskset.sizes,
                                      MC.ScheduleConfig(bucket_by=bucket_by))
            fit = dist.fit_taskset(taskset, sched, solver=self.solver,
                                   smo_cfg=self.smo_cfg, gd_cfg=self.gd_cfg,
                                   kernel=self.kernel_params,
                                   engine=self.engine_cfg,
                                   device=self.device)
        self._taskset = taskset
        self._schedule = sched
        self._fit = fit
        self.n_iter_ = int(np.max(fit.n_iter))
        self.converged_ = bool(np.all(fit.converged))
        self._compact_tasks()

    def _fit_taskset_cascade(self, taskset: MC.TaskSet) -> dist.TaskSetFit:
        """Each binary task trained by its own cascade, results in the
        ``TaskSetFit`` layout (``converged``: each task's certificate)."""
        c, sizes = taskset.n_tasks, taskset.sizes
        alpha = np.zeros((c, int(sizes.max())), np.float32)
        b = np.zeros(c, np.float32)
        n_iter = np.zeros(c, np.int64)
        converged = np.zeros(c, bool)
        rounds = np.zeros(c, np.int64)
        kkt = np.zeros(c)
        for t, task in enumerate(taskset.tasks):
            r = cascade_mod.cascade_binary(
                task.x, task.y, smo_cfg=self.smo_cfg,
                kernel=self.kernel_params, engine=self.engine_cfg,
                cascade=self.cascade_cfg, device=self.device)
            alpha[t, :task.size] = r.alpha
            b[t], n_iter[t], converged[t] = r.b, r.n_iter, r.converged
            rounds[t], kkt[t] = r.rounds, r.kkt
        self.cascade_rounds_, self.cascade_kkt_ = rounds, kkt
        return dist.TaskSetFit(alpha=alpha, b=b, n_iter=n_iter,
                               converged=converged, sizes=sizes)

    def _compact_tasks(self) -> None:
        """Keep each task's alpha > threshold rows only, grouped into pow2
        SV-width serving buckets (``min_width=8``), each stacked as wide
        as the largest SV count inside it: the ``serve.TaskBucket``s the
        pack carries."""
        taskset, fit = self._taskset, self._fit
        thr = _sv_threshold(self.smo_cfg.C)
        sv_idx = [np.flatnonzero(fit.alpha[t, :task.size] > thr)
                  for t, task in enumerate(taskset.tasks)]
        sv_counts = np.array([len(i) for i in sv_idx], np.int64)
        self.n_support_ = sv_counts
        sched = MC.build_schedule(
            np.maximum(sv_counts, 1),
            MC.ScheduleConfig(bucket_by="pow2", min_width=8, n_workers=1))
        d = taskset.tasks[0].x.shape[1]
        groups = []
        for bucket in sched.buckets:
            ids = bucket.task_ids.reshape(-1)
            ids = ids[ids >= 0]
            width = max(1, int(sv_counts[ids].max()))
            sv_x = np.zeros((len(ids), width, d), np.float32)
            sv_coef = np.zeros((len(ids), width), np.float32)
            for s, t in enumerate(ids):
                idx, task = sv_idx[t], taskset.tasks[t]
                sv_x[s, :len(idx)] = task.x[idx]
                sv_coef[s, :len(idx)] = (fit.alpha[t, idx]
                                         * task.y[idx]).astype(np.float32)
            groups.append(serve.TaskBucket(
                task_ids=ids.astype(np.int64), sv_x=sv_x, sv_coef=sv_coef,
                b=fit.b[ids], sv_counts=sv_counts[ids]))
        self._serving_buckets = groups

    def _fit_multiclass_lowrank(self, x: np.ndarray, xt: torch.Tensor,
                                y: np.ndarray) -> None:
        """One feature map over all of X, transformed once; each task is a
        DCD fit on its rows of that Phi (``task.indices``), all tasks
        solved together by ``linear.linear_svc_tasks`` (one launch an
        epoch, each task as its lone solve) — or, with
        ``shard="cascade"``, a cascade per task over its rows — so serving
        is one transform and a (n_tasks, rank) product."""
        taskset = self.strategy.build_taskset(x, y)
        fmap = approx.make_feature_map(xt, self.kernel_params,
                                       self.engine_cfg)
        phi = fmap.transform(xt)
        n_tasks = taskset.n_tasks
        task_w = np.zeros((n_tasks, fmap.rank), np.float32)
        task_b = np.zeros((n_tasks,), np.float32)
        n_support = np.zeros(n_tasks, np.int64)
        n_iter = np.zeros(n_tasks, np.int64)
        converged = np.ones(n_tasks, bool)
        alphas = []
        thr = _sv_threshold(self.smo_cfg.C)
        rows = [torch.from_numpy(task.indices).to(self.device)
                for task in taskset.tasks]
        if self.shard == "cascade":
            cascade_mod.validate_cascade(None, self.cascade_cfg)
            fits = [cascade_mod.cascade_dcd(phi.index_select(0, r), task.y,
                                            dcd_cfg=self.dcd_cfg,
                                            cascade=self.cascade_cfg)
                    for r, task in zip(rows, taskset.tasks)]
            self.cascade_rounds_ = np.array([r.rounds for r in fits])
            self.cascade_kkt_ = np.array([r.kkt for r in fits])
        else:
            fits = linear.linear_svc_tasks(
                phi, rows, [torch.from_numpy(task.y) for task in taskset.tasks],
                cfg=self.dcd_cfg)
        for t, r in enumerate(fits):
            a = _host(r.alpha)
            alphas.append(a)
            task_w[t] = _host(r.w)
            task_b[t] = float(r.b)
            n_support[t] = int((a > thr).sum())
            n_iter[t] = int(r.n_iter)
            converged[t] = bool(r.converged)
        self._feature_map = fmap
        self._taskset = taskset
        self._task_alpha = alphas
        self.task_w_ = task_w
        self.task_b_ = task_b
        self.n_support_ = n_support
        self.task_n_iter_ = n_iter
        self.n_iter_ = int(n_iter.max())
        self.converged_ = bool(converged.all())

    # ------------------------------------------------------------- predict
    def predictor(self):
        """The cached serving engine for this fit (see ``_predictor``)."""
        return _predictor(self)

    def decision_function(self, xt: np.ndarray) -> np.ndarray:
        """(n_test,) margins for a binary fit (positive =>
        ``classes_[1]``); (n_tasks, n_test) stacked binary decisions for
        a multiclass one (OvO: m(m-1)/2 rows, OvR: m rows)."""
        return self.predictor().decision_function(xt)

    def _decision_function_engine(self, xt: np.ndarray) -> np.ndarray:
        """Decision values by the pre-predictor path (``_engine_values``)."""
        return _engine_values(self, xt)

    def predict(self, xt: np.ndarray) -> np.ndarray:
        return self.predictor().predict(xt)

    def score(self, xt: np.ndarray, yt: np.ndarray) -> float:
        return float(np.mean(self.predict(xt) == np.asarray(yt)))


class SVR:
    """epsilon-insensitive Support Vector Regression: one doubled-variable
    QP through the same engine / shrinking stack as binary ``SVC``
    (``smo.svr_smo``; ``gd.svr_gd`` with ``solver="gd"``; a cascade of
    them with ``shard="cascade"``), or, on a low-rank engine, the doubled
    DCD over the feature map (``linear.linear_svr``; its cascade)."""

    def __init__(self, *, kernel: str = "rbf", C: float = 1.0,
                 epsilon: float = 0.1,
                 gamma: float = -1.0, degree: int = 3, coef0: float = 0.0,
                 tol: float = 1e-3, max_iter: int = 100_000,
                 solver: str = "smo", gd_lr: float = 0.01,
                 gd_steps: int = 300,
                 engine: str | KE.EngineConfig = "auto",
                 rank: int = 256, landmarks: str = "uniform",
                 seed: int = 0,
                 shrink_every: int = 0,
                 mesh=None,
                 shard: str = "task",
                 cascade_shards: int = 4,
                 cascade_rounds: int = 8,
                 device: str | torch.device = "cuda"):
        _check_modes(solver, shard, mesh)
        self.device = resolve_device(device)
        # gamma "scale" sentinel kept; re-resolved per fit (see SVC)
        self._kernel_cfg = K.KernelParams(name=kernel, gamma=gamma,
                                          degree=degree, coef0=coef0)
        self.kernel_params = self._kernel_cfg
        self.smo_cfg = smo.SMOConfig(C=C, tol=tol, max_iter=max_iter,
                                     shrink_every=shrink_every)
        self.gd_cfg = gd.GDConfig(C=C, lr=gd_lr, steps=gd_steps)
        self.solver = solver
        self.epsilon = float(epsilon)
        self.engine_cfg = _engine_config(engine, rank, landmarks, seed)
        self.dcd_cfg = linear.DCDConfig(C=C, tol=tol, max_epochs=max_iter)
        self.shard = shard
        self.cascade_cfg = cascade_mod.CascadeConfig(shards=cascade_shards,
                                                     rounds=cascade_rounds)
        self._fitted = False

    # ------------------------------------------------------------------ fit
    def fit(self, x: np.ndarray, y: np.ndarray) -> "SVR":
        x, xt = _fit_inputs(self, x)
        y = np.asarray(y, np.float32)
        yt = torch.from_numpy(y).to(self.device)
        self._feature_map = None
        eps, cascade = self.epsilon, self.shard == "cascade"
        if self.engine_cfg.backend in KE.LOWRANK_BACKENDS:
            fmap = approx.make_feature_map(xt, self.kernel_params,
                                           self.engine_cfg)
            phi = fmap.transform(xt)
            if cascade:
                cascade_mod.validate_cascade(None, self.cascade_cfg)
                r = cascade_mod.cascade_dcd_svr(phi, y, epsilon=eps,
                                                dcd_cfg=self.dcd_cfg,
                                                cascade=self.cascade_cfg)
            else:
                r = linear.linear_svr(phi, yt, epsilon=eps, cfg=self.dcd_cfg)
            self._feature_map = fmap
            self.w_ = _host(r.w)
        elif cascade:
            cascade_mod.validate_cascade(self.solver, self.cascade_cfg)
            r = cascade_mod.cascade_svr(
                x, y, epsilon=eps, smo_cfg=self.smo_cfg,
                kernel=self.kernel_params, engine=self.engine_cfg,
                cascade=self.cascade_cfg, device=self.device)
        elif self.solver == "smo":
            r = smo.svr_smo(xt, yt, epsilon=eps, cfg=self.smo_cfg,
                            kernel=self.kernel_params,
                            engine=self.engine_cfg)
        else:
            r = gd.svr_gd(xt, yt, epsilon=eps, cfg=self.gd_cfg,
                          kernel=self.kernel_params, engine=self.engine_cfg)
            self.loss_curve_ = _host(r.loss_curve)
        if isinstance(r, cascade_mod.CascadeResult):
            # alpha IS the per-sample beta, alpha_raw the (2n,) doubled
            # scatter of the root solve
            _cascade_attrs(self, r)
            self.beta_, self.alpha_raw_ = r.alpha, r.alpha_raw
        else:
            self.n_iter_ = int(r.n_iter)
            self.converged_ = (True if isinstance(r, gd.SVRGDResult)
                               else bool(r.converged))
            self.beta_ = _host(r.beta)
            self.alpha_raw_ = _host(r.alpha)  # (2n,) [alpha; alpha*]
        self.b_ = float(r.b)
        # serving state: compacted support-vector set only
        sv = np.abs(self.beta_) > _sv_threshold(self.smo_cfg.C)
        self.support_ = np.where(sv)[0]
        self.n_support_ = int(sv.sum())
        self.support_vectors_ = x[sv]
        self.dual_coef_ = self.beta_[sv].astype(np.float32)
        self._predictors: dict = {}
        self._fitted = True
        return self

    # ------------------------------------------------------------- predict
    def predictor(self):
        """The cached serving engine for this fit (see ``SVC.predictor``)."""
        return _predictor(self)

    def predict(self, xt: np.ndarray) -> np.ndarray:
        return self.predictor().predict(xt)

    def _predict_engine(self, xt: np.ndarray) -> np.ndarray:
        """Values by the pre-predictor path (``_engine_values``)."""
        return _engine_values(self, xt)

    def score(self, xt: np.ndarray, yt: np.ndarray) -> float:
        """Coefficient of determination R^2 (sklearn convention)."""
        yt = np.asarray(yt, np.float64)  # repro: noqa[R002] -- host-side R^2 accumulation, never on the device
        resid = yt - np.asarray(self.predict(xt), np.float64)  # repro: noqa[R002] -- host-side R^2 accumulation, never on the device
        ss_res = float(np.sum(resid ** 2))
        ss_tot = float(np.sum((yt - yt.mean()) ** 2))
        if ss_tot == 0.0:
            return 1.0 if ss_res == 0.0 else 0.0
        return 1.0 - ss_res / ss_tot
