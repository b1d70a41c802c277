"""Public SVM API of the port — binary ``SVC`` and epsilon-``SVR``.

    clf = SVC(kernel="rbf", C=1.0)                    # paper's CUDA path
    clf = SVC(engine="pallas", shrink_every=4)        # hand-written kernels
    clf = SVC(engine="rff", rank=1024)                # low-rank tier
    clf.fit(X, y); clf.predict(Xt); clf.score(Xt, yt)
    reg = SVR(epsilon=0.1, engine="pallas").fit(X, y); reg.score(Xt, yt)

Mirrors the binary SMO, low-rank and SVR paths of ``repro/core/svm.py``.
``fit`` runs on ``device`` ("cuda" by default; "cpu" must be asked for)
and keeps the reference's conventions: ``classes_[1]`` maps to +1, so a
positive margin predicts ``classes_[1]`` (sklearn orientation); a
multiplier counts as a support vector above ``1e-8 * C`` (``|beta|``
for SVR); a gamma <= 0 ("scale") is re-resolved from the data on every
fit; single-class input raises.

Exact engines train by SMO (``core/smo.py``); the low-rank engines
(``engine="nystrom" | "rff"`` with ``rank`` / ``landmarks`` / ``seed``)
train by dual coordinate descent on an explicit feature map
(``core/approx.py`` + ``core/linear.py``), with ``max_iter`` bounding
the epochs. After ``fit`` the model keeps only its serving state, and
``predict`` / ``decision_function`` answer through a cached
``serve.Predictor`` over ``serve.pack(self)`` — the same artifact
``serve.save`` writes.

Not ported yet, and raising NotImplementedError until their slice:
multiclass fits (ROADMAP A.6), the GD solver (A.7), the cascade (A.9)
and the sharded solver (A.11).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import approx
from repro_torch.core import kernel_engine as KE
from repro_torch.core import kernels as K
from repro_torch.core import linear
from repro_torch.core import smo
from repro_torch import serve

# Support threshold, RELATIVE to the box constraint: alpha > _SV_EPS * C
# counts as a support vector (an absolute cutoff would drop every SV
# once C < eps).
_SV_EPS = 1e-8


def _sv_threshold(C: float) -> float:
    return _SV_EPS * float(C)


def _check_solver(solver: str) -> None:
    if solver != "smo":
        raise NotImplementedError(
            f"solver {solver!r} is not ported yet; the GD baseline comes "
            "with ROADMAP A.7")


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
    ``engine="pallas"``)."""
    if not model._fitted:
        raise ValueError(f"{type(model).__name__} is not fitted yet (call "
                         ".fit first)")
    z = torch.from_numpy(np.asarray(xt, np.float32)).to(model.device)
    if model._feature_map is not None:
        w = torch.from_numpy(model.w_).to(model.device)
        return (model._feature_map.transform(z) @ w + model.b_).cpu().numpy()
    if model.n_support_ == 0:  # degenerate fit: constant decision
        return np.full(z.shape[0], model.b_, np.float32)
    eng = KE.make_engine(
        torch.from_numpy(model.support_vectors_).to(model.device),
        model.kernel_params, serve.serving_config(model.engine_cfg))
    coef = torch.from_numpy(model.dual_coef_).to(model.device)
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
                 solver: str = "smo",
                 engine: str | KE.EngineConfig = "auto",
                 rank: int = 256, landmarks: str = "uniform",
                 seed: int = 0,
                 shrink_every: int = 0,
                 device: str | torch.device = "cuda"):
        _check_solver(solver)
        self.device = resolve_device(device)
        # the constructor keeps the gamma<=0 "scale" sentinel; fit()
        # re-resolves from it each call (sklearn semantics)
        self._kernel_cfg = K.KernelParams(name=kernel, gamma=gamma,
                                          degree=degree, coef0=coef0)
        self.kernel_params = self._kernel_cfg
        self.smo_cfg = smo.SMOConfig(C=C, tol=tol, max_iter=max_iter,
                                     shrink_every=shrink_every)
        self.engine_cfg = _engine_config(engine, rank, landmarks, seed)
        # max_iter bounds both solvers: SMO pair updates and (as epochs)
        # the low-rank DCD sweeps
        self.dcd_cfg = linear.DCDConfig(C=C, tol=tol, max_epochs=max_iter)
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
        if len(classes) > 2:
            raise NotImplementedError(
                f"SVC.fit got {len(classes)} classes; multiclass (OvO/OvR) "
                "is not ported yet and comes with ROADMAP A.6")
        self.classes_ = classes
        self._predictors: dict = {}
        self._feature_map = None
        # sklearn orientation: classes_[1] maps to +1
        yy = np.where(y == classes[1], 1.0, -1.0).astype(np.float32)
        yt = torch.from_numpy(yy).to(self.device)
        if self.engine_cfg.backend in KE.LOWRANK_BACKENDS:
            self._fit_binary_lowrank(xt, yt)
        else:
            r = smo.binary_smo(xt, yt, cfg=self.smo_cfg,
                               kernel=self.kernel_params,
                               engine=self.engine_cfg)
            self.n_iter_ = int(r.n_iter)
            self.converged_ = bool(r.converged)
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
        (``core/linear.py``); no (n, n) object is ever formed."""
        fmap = approx.make_feature_map(xt, self.kernel_params,
                                       self.engine_cfg)
        r = linear.linear_svc(fmap.transform(xt), yt, cfg=self.dcd_cfg)
        self._feature_map = fmap
        self.alpha_ = r.alpha.cpu().numpy()
        self.b_ = float(r.b)
        self.w_ = r.w.cpu().numpy()
        self.n_iter_ = int(r.n_iter)
        self.converged_ = bool(r.converged)

    # ------------------------------------------------------------- predict
    def predictor(self):
        """The cached serving engine for this fit (see ``_predictor``)."""
        return _predictor(self)

    def decision_function(self, xt: np.ndarray) -> np.ndarray:
        """(n_test,) margins; positive => ``classes_[1]``."""
        return self.predictor().decision_function(xt)

    def _decision_function_engine(self, xt: np.ndarray) -> np.ndarray:
        """Margins by the pre-predictor path (``_engine_values``)."""
        return _engine_values(self, xt)

    def predict(self, xt: np.ndarray) -> np.ndarray:
        return self.predictor().predict(xt)

    def score(self, xt: np.ndarray, yt: np.ndarray) -> float:
        return float(np.mean(self.predict(xt) == np.asarray(yt)))


class SVR:
    """epsilon-insensitive Support Vector Regression: one doubled-variable
    QP through the same engine / shrinking stack as binary ``SVC``
    (``smo.svr_smo``), or, on a low-rank engine, the doubled DCD over the
    feature map (``linear.linear_svr``)."""

    def __init__(self, *, kernel: str = "rbf", C: float = 1.0,
                 epsilon: float = 0.1,
                 gamma: float = -1.0, degree: int = 3, coef0: float = 0.0,
                 tol: float = 1e-3, max_iter: int = 100_000,
                 solver: str = "smo",
                 engine: str | KE.EngineConfig = "auto",
                 rank: int = 256, landmarks: str = "uniform",
                 seed: int = 0,
                 shrink_every: int = 0,
                 device: str | torch.device = "cuda"):
        _check_solver(solver)
        self.device = resolve_device(device)
        # gamma "scale" sentinel kept; re-resolved per fit (see SVC)
        self._kernel_cfg = K.KernelParams(name=kernel, gamma=gamma,
                                          degree=degree, coef0=coef0)
        self.kernel_params = self._kernel_cfg
        self.smo_cfg = smo.SMOConfig(C=C, tol=tol, max_iter=max_iter,
                                     shrink_every=shrink_every)
        self.epsilon = float(epsilon)
        self.engine_cfg = _engine_config(engine, rank, landmarks, seed)
        self.dcd_cfg = linear.DCDConfig(C=C, tol=tol, max_epochs=max_iter)
        self._fitted = False

    # ------------------------------------------------------------------ fit
    def fit(self, x: np.ndarray, y: np.ndarray) -> "SVR":
        x, xt = _fit_inputs(self, x)
        yt = torch.from_numpy(np.asarray(y, np.float32)).to(self.device)
        self._feature_map = None
        if self.engine_cfg.backend in KE.LOWRANK_BACKENDS:
            fmap = approx.make_feature_map(xt, self.kernel_params,
                                           self.engine_cfg)
            r = linear.linear_svr(fmap.transform(xt), yt,
                                  epsilon=self.epsilon, cfg=self.dcd_cfg)
            self._feature_map = fmap
            self.w_ = r.w.cpu().numpy()
        else:
            r = smo.svr_smo(xt, yt, epsilon=self.epsilon, cfg=self.smo_cfg,
                            kernel=self.kernel_params,
                            engine=self.engine_cfg)
        self.n_iter_ = int(r.n_iter)
        self.converged_ = bool(r.converged)
        self.beta_ = r.beta.cpu().numpy()
        self.b_ = float(r.b)
        self.alpha_raw_ = r.alpha.cpu().numpy()  # (2n,) [alpha; alpha*]
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
