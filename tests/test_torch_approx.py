"""The port's low-rank tier (``core/approx.py``, the ``rff_features``
kernel's plain version) against the JAX reference.

* ``rff_features``: the plain version against the reference's Pallas
  kernel run in interpret mode (as tests/test_approx.py:128 runs it), at
  atol 1e-5 in float32 and on the same bf16-rounded operands.
* Feature maps carried across: the reference's Omega / phase (RFF) or
  landmarks / proj (Nystrom), put into the port by ``engine_from_map``,
  give the reference's Phi to 1e-5 (RFF) and its Phi Phi^T to 1e-4
  (Nystrom; Phi itself is not compared, as an eigendecomposition may
  rotate eigenvectors within a degenerate eigenspace).
* The port's own maps (its random draws cannot match ``jax.random``):
  full-rank Nystrom reproduces the exact Gram, RFF error shrinks with
  rank, landmarks are valid, kmeans++ covers every cluster.
* ``SVC(engine="rff" | "nystrom")`` end to end within the reference's
  accuracy margin (tests/test_approx.py:190-200).
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import approx as japprox
from repro.core import kernel_engine as JKE
from repro.core import kernels as JK
from repro.core.svm import SVC as JSVC
from repro.kernels import ops as jops
from repro_torch.core import approx as tapprox
from repro_torch.core import kernel_engine as TKE
from repro_torch.core import kernels as TK
from repro_torch.core.svm import SVC as TSVC
from repro_torch.data import make_blobs, normalize
from repro_torch.kernels import feature_map as TFM
from repro_torch.kernels import ops as tops
from torch_helpers import np_, tt


def _blob_problem(n=240, d=6, seed=0):
    x, y = make_blobs(n // 2, 2, d, sep=3.0, seed=seed)
    return normalize(x), y


def _kernel(x):
    jkp = JK.resolve_gamma(JK.KernelParams(name="rbf", gamma=-1.0),
                           jnp.asarray(x))
    return jkp, TK.KernelParams(**dataclasses.asdict(jkp))


# ------------------------------------------------------------ the kernel
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(128, 128, 128), (200, 77, 13),
                                   (5, 300, 16), (1, 1, 1)])
def test_rff_features_plain_matches_pallas(shape, dtype):
    n, k, d = shape
    rng = np.random.default_rng(n + k + d)
    x = rng.normal(size=(n, d)).astype(np.float32)
    om = (0.3 * rng.normal(size=(d, k))).astype(np.float32)
    ph = rng.uniform(0, 2 * np.pi, size=k).astype(np.float32)
    scale = float(np.sqrt(2.0 / k))
    want = jops.rff_features(jnp.asarray(x), jnp.asarray(om),
                             jnp.asarray(ph), scale=scale,
                             compute_dtype=dtype, interpret=True)
    got = tops.rff_features(tt(x), tt(om), tt(ph), scale=scale,
                            compute_dtype=dtype)
    assert got.dtype == torch.float32 and got.shape == (n, k)
    np.testing.assert_allclose(np_(got), np_(want), rtol=0, atol=1e-5)
    # the plain version itself: scale * cos(x @ omega + phase)
    np.testing.assert_allclose(
        np_(TFM.rff_features_plain(tt(x), tt(om), tt(ph), scale=scale)),
        scale * np.cos(x.astype(np.float64) @ om + ph), atol=1e-5)


def test_rff_features_checks_its_operands():
    x, om, ph = torch.zeros(4, 3), torch.zeros(3, 5), torch.zeros(5)
    with pytest.raises(ValueError, match="phase"):
        tops.rff_features(x, om, torch.zeros(4), scale=1.0)
    with pytest.raises(ValueError, match="omega"):
        tops.rff_features(x, torch.zeros(2, 5), ph, scale=1.0)
    with pytest.raises(ValueError, match="compute_dtype"):
        tops.rff_features(x, om, ph, scale=1.0, compute_dtype="fp16")
    assert tops.rff_features(torch.zeros(0, 3), om, ph,
                             scale=1.0).shape == (0, 5)


# ------------------------------------------------ maps carried across
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_rff_map_carried_from_reference(dtype):
    x, _ = _blob_problem(200, d=12, seed=1)
    jkp, _ = _kernel(x)
    cfg = dict(backend="rff", rank=96, seed=3, gram_dtype=dtype)
    jeng = japprox.LowRankKernelEngine(jnp.asarray(x), jkp,
                                       JKE.EngineConfig(**cfg))
    teng = tapprox.engine_from_map(tt(x), jeng.fmap,
                                   TKE.EngineConfig(**cfg))
    assert teng.fmap.kind == "rff" and teng.rank == 96
    # the reference's fused path (its TPU path) honours gram_dtype
    jeng.fmap.fused = True
    want = jeng.fmap.transform(jnp.asarray(x))
    np.testing.assert_allclose(np_(teng.phi), np_(want), rtol=0, atol=1e-5)
    z = x[:17] * 1.3
    np.testing.assert_allclose(np_(teng.fmap.transform(tt(z))),
                               np_(jeng.fmap.transform(jnp.asarray(z))),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("method", ["uniform", "kmeans++"])
def test_nystrom_map_carried_from_reference(method):
    x, _ = _blob_problem(160, seed=2)
    jkp, _ = _kernel(x)
    cfg = dict(backend="nystrom", rank=48, landmarks=method, seed=5)
    jeng = japprox.LowRankKernelEngine(jnp.asarray(x), jkp,
                                       JKE.EngineConfig(**cfg))
    teng = tapprox.engine_from_map(tt(x), jeng.fmap,
                                   TKE.EngineConfig(**cfg))
    want = np_(jeng.phi) @ np_(jeng.phi).T
    got = np_(teng.phi) @ np_(teng.phi).T
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("backend", ["rff", "nystrom"])
def test_lowrank_engine_methods_match_reference(backend):
    x, _ = _blob_problem(96, seed=4)
    jkp, _ = _kernel(x)
    cfg = dict(backend=backend, rank=32, dense_limit=4096)
    jeng = japprox.LowRankKernelEngine(jnp.asarray(x), jkp,
                                       JKE.EngineConfig(**cfg))
    teng = tapprox.engine_from_map(tt(x), jeng.fmap,
                                   TKE.EngineConfig(**cfg))
    rng = np.random.default_rng(0)
    coef = rng.normal(size=96).astype(np.float32)
    z = x[:11] * 0.9
    rows, cols = np.array([3, 17, 40]), np.array([0, 9, 55, 80])
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np_(teng.full()), np_(jeng.full()), **tol)
    np.testing.assert_allclose(np_(teng.diag()), np_(jeng.diag()), **tol)
    np.testing.assert_allclose(np_(teng.row(torch.tensor(7))[0]),
                               np_(jeng.row(jnp.int32(7))[0]), **tol)
    np.testing.assert_allclose(
        np_(teng.block(torch.from_numpy(rows), torch.from_numpy(cols))),
        np_(jeng.block(jnp.asarray(rows), jnp.asarray(cols))), **tol)
    np.testing.assert_allclose(np_(teng.cross(tt(z))),
                               np_(jeng.cross(jnp.asarray(z))), **tol)
    np.testing.assert_allclose(np_(teng.matvec(tt(coef))),
                               np_(jeng.matvec(jnp.asarray(coef))), **tol)
    np.testing.assert_allclose(
        np_(teng.decide(tt(z), tt(coef), 0.25)),
        np_(jeng.decide(jnp.asarray(z), jnp.asarray(coef), 0.25)), **tol)
    assert teng.init_cache() is None


def test_map_from_arrays_roundtrip_and_errors():
    x, _ = _blob_problem(60)
    _, tkp = _kernel(x)
    fmap = tapprox.make_feature_map(
        tt(x), tkp, TKE.EngineConfig(backend="rff", rank=16))
    a, b = fmap.arrays
    again = tapprox.map_from_arrays("rff", tkp, np_(a), np_(b))
    assert torch.equal(again.transform(tt(x)), fmap.transform(tt(x)))
    assert (again.rank, again.n_features) == (16, x.shape[1])
    with pytest.raises(ValueError, match="feature-map kind"):
        tapprox.map_from_arrays("grid", tkp, np_(a), np_(b))
    with pytest.raises(ValueError, match="RBF kernel only"):
        tapprox.make_feature_map(tt(x), TK.KernelParams(name="linear"),
                                 TKE.EngineConfig(backend="rff", rank=8))
    with pytest.raises(ValueError, match="not a low-rank backend"):
        tapprox.make_feature_map(tt(x), tkp, TKE.EngineConfig())


# ---------------------------------------------------- the port's own maps
def test_nystrom_full_rank_reproduces_exact_gram():
    """landmarks == all points => Phi Phi^T == K up to the spectral clip."""
    x, _ = _blob_problem(160)
    _, tkp = _kernel(x)
    fmap = tapprox.make_feature_map(
        tt(x), tkp, TKE.EngineConfig(backend="nystrom", rank=160))
    phi = fmap.transform(tt(x))
    exact = TK.make_gram_fn(tkp)(tt(x), tt(x))
    assert float(torch.max(torch.abs(phi @ phi.T - exact))) < 1e-4
    assert tapprox.EIG_CLIP_REL == japprox.EIG_CLIP_REL


def test_rff_gram_error_shrinks_with_rank():
    x, _ = _blob_problem(120, seed=3)
    _, tkp = _kernel(x)
    exact = TK.make_gram_fn(tkp)(tt(x), tt(x))
    errs = []
    for rank in (16, 256, 4096):
        phi = tapprox.make_feature_map(
            tt(x), tkp, TKE.EngineConfig(backend="rff", rank=rank,
                                         seed=1)).transform(tt(x))
        errs.append(float(torch.mean(torch.abs(phi @ phi.T - exact))))
    assert errs[0] > errs[1] > errs[2], errs


@pytest.mark.parametrize("method", ["uniform", "kmeans++"])
def test_select_landmarks_valid(method):
    x, _ = _blob_problem(100)
    gen = torch.Generator().manual_seed(0)
    idx = tapprox.select_landmarks(tt(x), 20, method, gen)
    assert idx.shape == (20,) and idx.dtype == torch.int64
    assert int(idx.min()) >= 0 and int(idx.max()) < 100
    if method == "uniform":
        assert len(set(idx.tolist())) == 20


def test_kmeanspp_spreads_over_clusters():
    x, y = make_blobs(50, 4, 3, sep=8.0, seed=1)
    gen = torch.Generator().manual_seed(0)
    idx = tapprox.select_landmarks(tt(x), 8, "kmeans++", gen).numpy()
    assert set(y[idx]) == {0, 1, 2, 3}
    with pytest.raises(ValueError, match="landmark"):
        tapprox.select_landmarks(tt(x), 4, "grid", gen)


def test_lowrank_full_respects_dense_limit():
    x = torch.zeros((64, 3))
    eng = TKE.make_engine(x, TK.KernelParams(gamma=0.5),
                          TKE.EngineConfig(backend="rff", rank=8,
                                           dense_limit=32))
    assert isinstance(eng, tapprox.LowRankKernelEngine)
    with pytest.raises(RuntimeError, match="dense_limit"):
        eng.full()
    with pytest.raises(ValueError, match="nystrom"):
        TKE.make_engine(x, TK.KernelParams(gamma=0.5),
                        TKE.EngineConfig(backend="bogus"))


# ------------------------------------------------------------- end to end
@pytest.mark.parametrize("engine", ["nystrom", "rff"])
def test_svc_lowrank_matches_exact_accuracy(engine):
    x, y = _blob_problem(400, seed=5)
    xtr, ytr, xte, yte = x[:300], y[:300], x[300:], y[300:]
    exact = TSVC(engine="dense", device="cpu").fit(xtr, ytr)
    clf = TSVC(engine=engine, rank=128, device="cpu").fit(xtr, ytr)
    ref = JSVC(engine=engine, rank=128).fit(xtr, ytr)
    assert clf.converged_ and clf.w_.shape == (128,)
    acc_e = exact.score(xte, yte)
    acc_a = clf.score(xte, yte)
    assert acc_a >= acc_e - 0.02, (acc_a, acc_e)
    assert acc_a >= ref.score(xte, yte) - 0.02
    np.testing.assert_allclose(clf.decision_function(xte),
                               clf._decision_function_engine(xte),
                               atol=1e-5)
    assert clf.n_support_ == int(np.sum(clf.alpha_ > 1e-8))


def test_exact_engines_unchanged_by_lowrank_kwargs():
    """rank / landmarks / seed are inert for the exact backends."""
    x, y = _blob_problem(150, seed=4)
    base = TSVC(engine="dense", device="cpu").fit(x, y)
    knob = TSVC(engine="dense", rank=17, landmarks="kmeans++", seed=99,
                device="cpu").fit(x, y)
    assert np.array_equal(base.alpha_, knob.alpha_) and base.b_ == knob.b_
