"""Public SVM API of the port — binary ``SVC`` over the SMO solver.

    clf = SVC(kernel="rbf", C=1.0)                    # paper's CUDA path
    clf = SVC(engine="pallas", shrink_every=4)        # hand-written kernels
    clf.fit(X, y); clf.predict(Xt); clf.score(Xt, yt)

Mirrors the binary SMO path of ``repro/core/svm.py``. ``fit`` runs on
``device`` ("cuda" by default; "cpu" must be asked for) and keeps the
reference's conventions: ``classes_[1]`` maps to +1, so a positive
margin predicts ``classes_[1]`` (sklearn orientation); a multiplier
counts as a support vector above ``1e-8 * C``; a gamma <= 0 ("scale")
is re-resolved from the data on every fit; single-class input raises.

After ``fit`` the model keeps only the support vectors, and
``predict`` / ``decision_function`` answer through a cached
``serve.Predictor`` over ``serve.pack(self)`` — the same artifact
``serve.save`` writes.

Not ported yet, and raising NotImplementedError until their slice:
multiclass fits (ROADMAP A.6), the GD solver (A.7), the low-rank
engines (A.8), the cascade (A.9) and the sharded solver (A.11). SVR
comes with the next slice.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import kernel_engine as KE
from repro_torch.core import kernels as K
from repro_torch.core import smo
from repro_torch import serve

# Support threshold, RELATIVE to the box constraint: alpha > _SV_EPS * C
# counts as a support vector (an absolute cutoff would drop every SV
# once C < eps).
_SV_EPS = 1e-8


def _sv_threshold(C: float) -> float:
    return _SV_EPS * float(C)


class SVC:
    def __init__(self, *, kernel: str = "rbf", C: float = 1.0,
                 gamma: float = -1.0, degree: int = 3, coef0: float = 0.0,
                 tol: float = 1e-3, max_iter: int = 100_000,
                 solver: str = "smo",
                 engine: str | KE.EngineConfig = "auto",
                 shrink_every: int = 0,
                 device: str | torch.device = "cuda"):
        if solver != "smo":
            raise NotImplementedError(
                f"solver {solver!r} is not ported yet; the GD baseline "
                "comes with ROADMAP A.7")
        self.device = resolve_device(device)
        # the constructor keeps the gamma<=0 "scale" sentinel; fit()
        # re-resolves from it each call (sklearn semantics)
        self._kernel_cfg = K.KernelParams(name=kernel, gamma=gamma,
                                          degree=degree, coef0=coef0)
        self.kernel_params = self._kernel_cfg
        self.smo_cfg = smo.SMOConfig(C=C, tol=tol, max_iter=max_iter,
                                     shrink_every=shrink_every)
        self.engine_cfg = (engine if isinstance(engine, KE.EngineConfig)
                           else KE.EngineConfig(backend=engine))
        KE.check_backend(self.engine_cfg.backend)
        self._fitted = False

    # ------------------------------------------------------------------ fit
    def fit(self, x: np.ndarray, y: np.ndarray) -> "SVC":
        x = np.asarray(x, np.float32)
        xt = torch.from_numpy(x).to(self.device)
        self.kernel_params = K.resolve_gamma(self._kernel_cfg, xt)
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
        # sklearn orientation: classes_[1] maps to +1
        yy = np.where(y == classes[1], 1.0, -1.0).astype(np.float32)
        r = smo.binary_smo(xt, torch.from_numpy(yy).to(self.device),
                           cfg=self.smo_cfg, kernel=self.kernel_params,
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

    # ------------------------------------------------------------- predict
    def predictor(self):
        """The cached serving engine for this fit (one per serving engine
        config; the SV bank stays resident on the device). Repacked on
        refit."""
        if not self._fitted:
            raise ValueError("SVC is not fitted yet (call .fit first)")
        scfg = serve.serving_config(self.engine_cfg)
        pred = self._predictors.get(scfg)
        if pred is None:
            pred = serve.Predictor(serve.pack(self), engine=scfg,
                                   device=self.device)
            self._predictors[scfg] = pred
        return pred

    def decision_function(self, xt: np.ndarray) -> np.ndarray:
        """(n_test,) margins; positive => ``classes_[1]``."""
        return self.predictor().decision_function(xt)

    def _decision_function_engine(self, xt: np.ndarray) -> np.ndarray:
        """Pre-predictor path: a ``KernelEngine`` over the support vectors
        and ``engine.decide`` (the ``decision`` kernel under
        ``engine="pallas"``)."""
        if not self._fitted:
            raise ValueError("SVC is not fitted yet (call .fit first)")
        z = torch.from_numpy(np.asarray(xt, np.float32)).to(self.device)
        if self.n_support_ == 0:  # degenerate fit: constant decision
            return np.full(z.shape[0], self.b_, np.float32)
        eng = KE.make_engine(
            torch.from_numpy(self.support_vectors_).to(self.device),
            self.kernel_params, serve.serving_config(self.engine_cfg))
        coef = torch.from_numpy(self.dual_coef_).to(self.device)
        return eng.decide(z, coef, self.b_).cpu().numpy()

    def predict(self, xt: np.ndarray) -> np.ndarray:
        return self.predictor().predict(xt)

    def score(self, xt: np.ndarray, yt: np.ndarray) -> float:
        return float(np.mean(self.predict(xt) == np.asarray(yt)))
