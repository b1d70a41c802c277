"""Low-rank kernel approximations: Nystrom landmarks and random Fourier
features, behind the KernelEngine interface.

Mirrors ``repro/core/approx.py``. Both approximations map the kernel
problem to an explicit feature space ``Phi (n, k)`` with
``K ~ Phi Phi^T``, after which training is a linear SVM solved by the
O(n k) dual coordinate descent of ``repro_torch.core.linear`` — nothing
of size (n, n) is ever formed.

Nystrom (any PSD kernel)
    k landmark rows L (uniform subsample or k-means++ D^2 seeding),
    ``Phi = K(X, L) U diag(clip(e)^{-1/2})`` from ``K(L, L) = U diag(e)
    U^T``; directions below ``e_max * EIG_CLIP_REL`` are dropped (the
    pseudo-inverse map). Its Gram runs through the plain
    ``kernels.make_gram_fn``, as in the reference.

RFF (RBF only; Rahimi & Recht 2007)
    ``phi(z) = sqrt(2/k) cos(z Omega + phase)`` with
    ``Omega ~ N(0, 2 gamma I)`` and ``phase ~ U[0, 2 pi)``. The transform
    goes through ``ops.rff_features``: the hand-written CUDA kernel for
    tensors on the card, its plain version for tensors on the CPU. The
    reference's ``fused`` switch is gone: the tensor's device decides,
    as in every ``ops`` wrapper, and the card has no plain route. The
    map honours ``gram_dtype`` on every device (the reference's CPU path
    computes RFF features in float32 whatever ``gram_dtype`` says).

Random draws (Omega, phase, landmarks) come from a ``torch.Generator``
seeded with ``EngineConfig.seed`` on the device of the data, so a fit
is reproducible on one device; they cannot match ``jax.random``'s, and
``engine_from_map`` / ``map_from_arrays`` carry a given map across.

``LowRankKernelEngine`` exposes Phi through every KernelEngine method
(O(n k) matmuls against the resident Phi), so the exact SMO solver and
the KKT certificate run unchanged against the APPROXIMATE Gram.
``diag()`` is the feature-space diagonal ``|phi_i|^2``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import kernel_engine as KE
from repro_torch.core import kernels as K
from repro_torch.kernels import ops

# spectral clip for the Nystrom eigenscale, relative to the largest
# eigenvalue of W: directions below it are dropped (pseudo-inverse)
EIG_CLIP_REL = 1e-6

LANDMARK_METHODS = ("uniform", "kmeans++")


def _tensor(a, device) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):  # numpy or any array-like
        a = torch.from_numpy(np.array(a, np.float32))
    return a.to(device=device if device is not None else a.device,
                dtype=torch.float32).contiguous()


# ---------------------------------------------------------- feature maps
class NystromMap:
    """``phi(z) = K(z, L) proj`` with ``proj = U diag(clip(e)^{-1/2})``."""

    kind = "nystrom"

    def __init__(self, kernel: K.KernelParams, landmarks, proj, *,
                 gram_dtype: str = "fp32", device=None):
        self.kernel = kernel
        self.landmarks = _tensor(landmarks, device)               # (k, d)
        self.proj = _tensor(proj, self.landmarks.device)          # (k, r)
        self._gram_fn = K.make_gram_fn(kernel, compute_dtype=gram_dtype)

    @property
    def rank(self) -> int:
        return self.proj.shape[1]

    @property
    def n_features(self) -> int:
        return self.landmarks.shape[1]

    @property
    def arrays(self):
        """(a, b) serialization pair — see ``serve.artifact``."""
        return self.landmarks, self.proj

    def transform(self, z: torch.Tensor) -> torch.Tensor:
        return self._gram_fn(z.to(torch.float32), self.landmarks) @ self.proj


class RFFMap:
    """``phi(z) = sqrt(2/k) cos(z Omega + phase)`` — RBF only."""

    kind = "rff"

    def __init__(self, kernel: K.KernelParams, omega, phase, *,
                 gram_dtype: str = "fp32", device=None):
        self.kernel = kernel
        self.omega = _tensor(omega, device)                       # (d, k)
        self.phase = _tensor(phase, self.omega.device)            # (k,)
        self.gram_dtype = gram_dtype

    @property
    def rank(self) -> int:
        return self.omega.shape[1]

    @property
    def n_features(self) -> int:
        return self.omega.shape[0]

    @property
    def arrays(self):
        return self.omega, self.phase

    @property
    def scale(self) -> float:
        return math.sqrt(2.0 / self.rank)

    def transform(self, z: torch.Tensor) -> torch.Tensor:
        return ops.rff_features(z.to(torch.float32).contiguous(), self.omega,
                                self.phase, scale=self.scale,
                                compute_dtype=self.gram_dtype)


def map_from_arrays(kind: str, kernel: K.KernelParams, a, b, *,
                    gram_dtype: str = "fp32", device=None):
    """Rebuild a feature map from its serialized ``(kind, a, b)`` triple
    (the ``serve.artifact`` low-rank payload; numpy arrays or tensors).
    ``device`` places the arrays (None: tensors stay where they are,
    numpy arrays go to the CPU)."""
    if kind == "nystrom":
        return NystromMap(kernel, a, b, gram_dtype=gram_dtype, device=device)
    if kind == "rff":
        return RFFMap(kernel, a, b, gram_dtype=gram_dtype, device=device)
    raise ValueError(f"unknown feature-map kind {kind!r}; "
                     f"expected 'nystrom' or 'rff'")


# ------------------------------------------------------------- landmarks
def _sqdist_to(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    d = x - c[None, :]
    return torch.sum(d * d, dim=1)


def select_landmarks(x: torch.Tensor, k: int, method: str,
                     gen: torch.Generator) -> torch.Tensor:
    """(k,) landmark row indices on ``x``'s device: "uniform" subsample
    or "kmeans++" D^2-weighted seeding (each next landmark drawn with
    probability proportional to its squared distance to the chosen
    set). Nothing is read on the host."""
    n, dev = x.shape[0], x.device
    if method == "uniform":
        return torch.randperm(n, generator=gen, device=dev)[:k]
    if method != "kmeans++":
        raise ValueError(f"unknown landmark method {method!r}; "
                         f"expected one of {LANDMARK_METHODS}")
    idx = torch.zeros((k,), dtype=torch.int64, device=dev)
    i0 = torch.randint(0, n, (1,), generator=gen, device=dev)
    idx[:1] = i0
    d2 = _sqdist_to(x, x.index_select(0, i0)[0])
    for j in range(1, k):
        # D^2 sampling via inverse CDF; an all-zero d2 (k >= #distinct
        # points) degrades to the last index — the spectral clip absorbs
        # duplicate landmarks
        cum = torch.cumsum(d2, dim=0)
        u = torch.rand((1,), generator=gen, device=dev) * cum[-1:]
        nxt = torch.clamp(torch.searchsorted(cum, u), 0, n - 1)
        idx[j:j + 1] = nxt
        d2 = torch.minimum(d2, _sqdist_to(x, x.index_select(0, nxt)[0]))
    return idx


# ---------------------------------------------------------- construction
def make_feature_map(x: torch.Tensor, kernel: K.KernelParams,
                     cfg: KE.EngineConfig):
    """Resolve ``EngineConfig(backend="nystrom"|"rff", rank, landmarks,
    seed)`` into a fitted feature map for the sample matrix ``x``, on
    ``x``'s device."""
    x = x.to(torch.float32)
    n, d = x.shape
    dev = x.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    if cfg.backend == "rff":
        if kernel.name != "rbf":
            raise ValueError(
                f"engine='rff' approximates the RBF kernel only, got "
                f"kernel={kernel.name!r}; use engine='nystrom' for "
                f"arbitrary PSD kernels")
        omega = math.sqrt(2.0 * kernel.gamma) * torch.randn(
            (d, cfg.rank), generator=gen, device=dev)
        phase = 2.0 * math.pi * torch.rand((cfg.rank,), generator=gen,
                                           device=dev)
        return RFFMap(kernel, omega, phase, gram_dtype=cfg.gram_dtype)
    if cfg.backend != "nystrom":
        raise ValueError(f"make_feature_map: not a low-rank backend "
                         f"{cfg.backend!r}; expected one of "
                         f"{KE.LOWRANK_BACKENDS}")
    k = min(cfg.rank, n)
    landmarks = x[select_landmarks(x, k, cfg.landmarks, gen)]
    gram_fn = K.make_gram_fn(kernel, compute_dtype=cfg.gram_dtype)
    e, u = torch.linalg.eigh(gram_fn(landmarks, landmarks))
    clip = torch.clamp_min(e[-1], 0.0) * EIG_CLIP_REL
    inv_sqrt = torch.where(e > clip,
                           1.0 / torch.sqrt(torch.maximum(e, clip)), 0.0)
    return NystromMap(kernel, landmarks, u * inv_sqrt[None, :],
                      gram_dtype=cfg.gram_dtype)


# ---------------------------------------------------------------- engine
class LowRankKernelEngine(KE.KernelEngine):
    """K~ = Phi Phi^T behind the full KernelEngine interface: every
    method is an O(n k) (or O(t k)) matmul against the resident feature
    matrix ``phi (n, k)``. The training fast path is
    ``repro_torch.core.linear`` directly on ``engine.phi``."""

    backend = "lowrank"

    def __init__(self, x, kernel, cfg: KE.EngineConfig = KE.EngineConfig(),
                 *, fmap=None):
        super().__init__(x, kernel, cfg)
        self.fmap = (make_feature_map(self.x, kernel, cfg) if fmap is None
                     else fmap)
        self.phi = self.fmap.transform(self.x)     # (n, k) resident

    @property
    def rank(self) -> int:
        return self.phi.shape[1]

    def full(self):
        if self.n > self.cfg.dense_limit:
            raise RuntimeError(
                f"LowRankKernelEngine.full(): refusing to materialize a "
                f"({self.n}, {self.n}) approximate Gram (dense_limit="
                f"{self.cfg.dense_limit}); use row()/block()/matvec()")
        return self.phi @ self.phi.T

    def diag(self):
        # the APPROXIMATE diagonal |phi_i|^2, not the exact K(x_i, x_i)
        return torch.sum(self.phi * self.phi, dim=1)

    def row(self, i, cache=None):
        return self.phi @ KE.take(self.phi, i), cache

    def block(self, rows, cols):
        return self.phi[rows] @ self.phi[cols].T

    def cross(self, z):
        return self.fmap.transform(z) @ self.phi.T

    def matvec(self, v):
        return self.phi @ (self.phi.T @ v)

    def decide(self, z, coef, b=0.0):
        return self.fmap.transform(z) @ (self.phi.T @ coef) + b


def engine_from_map(x: torch.Tensor, fmap,
                    cfg: KE.EngineConfig = KE.EngineConfig()
                    ) -> LowRankKernelEngine:
    """A ``LowRankKernelEngine`` over ``x`` with a GIVEN feature map
    instead of one drawn from ``cfg.seed``. ``fmap`` is any object with
    the map protocol (``kind``, ``kernel``, ``arrays``) — a map of this
    package or of the reference's, which is how the same Omega / phase
    or landmarks / proj are carried into the port; its arrays are
    copied to ``x``'s device."""
    kernel = K.KernelParams(**dataclasses.asdict(fmap.kernel))
    a, b = fmap.arrays
    fmap = map_from_arrays(fmap.kind, kernel, a, b,
                           gram_dtype=cfg.gram_dtype, device=x.device)
    return LowRankKernelEngine(x, kernel, cfg, fmap=fmap)
