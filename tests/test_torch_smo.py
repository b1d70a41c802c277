"""The port's engines and SMO solver against the JAX reference.

Engines: every interface method of the port's dense / chunked / pallas
backends against the same JAX backend (the port's pallas backend runs
its kernels' plain versions on the CPU), and the LRU row cache's
hit/miss bookkeeping replayed on both.

SMO: both solvers get the SAME Gram matrix (``DenseKernelEngine(gram=)``
in each package), so they solve the same QP. Held: converged, support
set and held-out labels equal; alphas within 1e-4 C and b within 1e-4;
the float64 KKT certificate of a recomputed gradient <= tol for both.
``n_iter`` is compared exactly where the trajectories agree, which they
do on these inputs; SMO trajectories are chaotic (the NOTE in
``repro/core/smo.py::_smo_iteration``), so a one-ulp difference in one
f update may change the pair sequence and the count without changing
the optimum — the test says so if it ever happens, by failing only the
n_iter comparison.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import kernel_engine as JKE
from repro.core import kernels as JK
from repro.core import smo as jsmo
from repro.data import load_iris as j_load_iris
from repro_torch.core import kernel_engine as TKE
from repro_torch.core import kernels as TK
from repro_torch.core import smo as tsmo
from repro_torch.data import (load_breast_cancer_like, load_iris, make_blobs,
                              normalize)
from torch_helpers import np_, tt


def _blobs(n_per=48, d=6, seed=3):
    x, y = make_blobs(n_per, 2, d, sep=1.5, seed=seed)
    return normalize(x), np.where(y == 0, 1.0, -1.0).astype(np.float32)


def test_data_helpers_are_copies_of_the_reference():
    from repro import data as jdata
    from repro_torch import data as tdata
    for name, args in [("make_blobs", (20, 3, 5)), ("load_pavia_like", (30,)),
                       ("load_breast_cancer_like", ())]:
        for a, b in zip(getattr(jdata, name)(*args),
                        getattr(tdata, name)(*args)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(j_load_iris()[0], load_iris()[0])
    x, y = load_iris()
    for a, b in zip(jdata.train_test_split(x, y, seed=4),
                    tdata.train_test_split(x, y, seed=4)):
        np.testing.assert_array_equal(a, b)
    for kind in ("standard", "minmax"):
        np.testing.assert_array_equal(jdata.normalize(x, kind=kind),
                                      tdata.normalize(x, kind=kind))


@pytest.mark.parametrize("scale", [1.0, 1e-7])
def test_resolve_gamma_uses_population_variance(scale):
    x, _ = _blobs()
    x = x * scale
    want = JK.resolve_gamma(JK.KernelParams(gamma=-1.0), jnp.asarray(x))
    got = TK.resolve_gamma(TK.KernelParams(gamma=-1.0), tt(x))
    assert got.gamma == pytest.approx(want.gamma, rel=1e-5)


@pytest.mark.parametrize("name", ["linear", "poly", "sigmoid", "rbf"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_gram_functions_match(name, dtype):
    x, _ = _blobs()
    kp = dict(name=name, gamma=0.3, degree=3, coef0=0.5)
    want = JK.make_gram_fn(JK.KernelParams(**kp), compute_dtype=dtype)(
        jnp.asarray(x[:40]), jnp.asarray(x))
    got = TK.make_gram_fn(TK.KernelParams(**kp), compute_dtype=dtype)(
        tt(x[:40]), tt(x))
    np.testing.assert_allclose(np_(got), np_(want), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------- engines
@pytest.mark.parametrize("kernel", ["rbf", "linear", "poly"])
@pytest.mark.parametrize("backend", ["dense", "chunked", "pallas"])
def test_engine_methods_match_reference(backend, kernel):
    x, _ = _blobs()
    kw = dict(name=kernel, gamma=0.2, coef0=1.0)
    cfg = dict(backend=backend, cache_slots=8, chunk=64, dense_limit=4096)
    jeng = JKE.make_engine(jnp.asarray(x), JK.KernelParams(**kw),
                           JKE.EngineConfig(**cfg))
    teng = TKE.make_engine(tt(x), TK.KernelParams(**kw),
                           TKE.EngineConfig(**cfg))
    assert teng.backend == backend
    rng = np.random.default_rng(0)
    coef = rng.normal(size=x.shape[0]).astype(np.float32)
    zt = x[:13] * 1.1
    rows, cols = np.array([3, 17, 40]), np.array([0, 9, 55, 80])
    tol = dict(rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(np_(teng.full()), np_(jeng.full()), **tol)
    np.testing.assert_allclose(np_(teng.diag()), np_(jeng.diag()), **tol)
    np.testing.assert_allclose(np_(teng.row(torch.tensor(7))[0]),
                               np_(jeng.row(jnp.int32(7))[0]), **tol)
    np.testing.assert_allclose(
        np_(teng.block(torch.from_numpy(rows), torch.from_numpy(cols))),
        np_(jeng.block(jnp.asarray(rows), jnp.asarray(cols))), **tol)
    np.testing.assert_allclose(np_(teng.cross(tt(zt))),
                               np_(jeng.cross(jnp.asarray(zt))), **tol)
    np.testing.assert_allclose(np_(teng.matvec(tt(coef))),
                               np_(jeng.matvec(jnp.asarray(coef))),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        np_(teng.decide(tt(zt), tt(coef), 0.25)),
        np_(jeng.decide(jnp.asarray(zt), jnp.asarray(coef), 0.25)),
        rtol=2e-4, atol=2e-4)


def test_engine_resolution_and_guards():
    x, _ = _blobs()
    kp = TK.KernelParams(gamma=0.5)
    assert isinstance(TKE.make_engine(tt(x), kp, TKE.EngineConfig(
        dense_limit=1000)), TKE.DenseKernelEngine)
    assert isinstance(TKE.make_engine(tt(x), kp, TKE.EngineConfig(
        dense_limit=10)), TKE.ChunkedKernelEngine)
    with pytest.raises(ValueError):
        TKE.make_engine(tt(x), kp, "no_such_backend")
    # the sharded backend (ROADMAP A.11): the reference's ValueError
    # without shard_axis, and without the mesh its ranks span
    with pytest.raises(ValueError, match="shard_axis"):
        TKE.make_engine(tt(x), kp, "sharded")
    with pytest.raises(ValueError, match="mesh"):
        TKE.make_engine(tt(x), kp, TKE.EngineConfig(backend="sharded",
                                                    shard_axis="shards"))
    for backend in TKE.LOWRANK_BACKENDS:   # ported with the low-rank tier
        eng = TKE.make_engine(tt(x), kp, TKE.EngineConfig(backend=backend,
                                                          rank=8))
        assert eng.backend == "lowrank" and eng.phi.shape == (len(x), 8)
    for cls in (TKE.ChunkedKernelEngine, TKE.PallasKernelEngine):
        eng = cls(tt(x), kp, TKE.EngineConfig(dense_limit=10))
        with pytest.raises(RuntimeError, match="refusing to materialize"):
            eng.full()
        assert cls(tt(x), kp, TKE.EngineConfig(cache_slots=0)
                   ).init_cache() is None


@pytest.mark.parametrize("backend", ["chunked", "pallas"])
def test_row_cache_hits_misses_match_reference(backend):
    x, _ = _blobs()
    kp = dict(gamma=0.5)
    cfg = dict(cache_slots=4)
    jeng = JKE.ChunkedKernelEngine(jnp.asarray(x), JK.KernelParams(**kp),
                                   JKE.EngineConfig(**cfg))
    teng = TKE.make_engine(tt(x), TK.KernelParams(**kp),
                           TKE.EngineConfig(backend=backend, **cfg))
    ref = np_(TKE.DenseKernelEngine(tt(x), TK.KernelParams(**kp)).full())
    jc, tc = jeng.init_cache(), teng.init_cache()
    for i in [3, 3, 10, 11, 12, 13, 3, 12, 40, 3, 3, 41, 10]:
        jr, jc = jeng.row(jnp.int32(i), jc)
        tr, tc = teng.row(torch.tensor(i), tc)
        np.testing.assert_allclose(np_(tr), ref[i], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np_(tr), np_(jr), rtol=1e-5, atol=1e-6)
        assert (int(tc.hits), int(tc.misses)) == (int(jc.hits),
                                                  int(jc.misses))
        np.testing.assert_array_equal(np_(tc.keys), np_(jc.keys))
        np.testing.assert_array_equal(np_(tc.stamp), np_(jc.stamp))
    assert (int(tc.hits), int(tc.misses)) == (4, 9)


# -------------------------------------------------------------------- SMO
def _problem(kind):
    if kind == "blobs":
        x, y = _blobs(n_per=60)
    elif kind == "breast":
        x, yl = load_breast_cancer_like(n_samples=260)
        x, y = normalize(x), np.where(yl == 1, 1.0, -1.0).astype(np.float32)
    else:  # iris versicolor vs virginica: overlapping classes
        x, yl = load_iris()
        keep = yl > 0
        x = normalize(x[keep])
        y = np.where(yl[keep] == 2, 1.0, -1.0).astype(np.float32)
    rng = np.random.default_rng(0)
    perm = rng.permutation(len(y))
    te, tr = perm[:len(y) // 5], perm[len(y) // 5:]
    return x[tr], y[tr], x[te]


def _certificate(gram, alpha, y, c, tol):
    f = gram.astype(np.float64) @ (alpha.astype(np.float64) * y) - y  # repro: noqa[R002] -- test-side f64 recompute of the gradient
    return float(tsmo.kkt_violation(alpha, y, f, 0.0, c))


@pytest.mark.parametrize("kind,C,selection,shrink", [
    ("blobs", 1.0, "first", 0), ("blobs", 10.0, "second", 0),
    ("breast", 1.0, "first", 4), ("breast", 0.5, "second", 4),
    ("iris", 1.0, "first", 0), ("iris", 10.0, "first", 4),
])
def test_smo_matches_reference_on_same_gram(kind, C, selection, shrink):
    x, y, xte = _problem(kind)
    gamma = 1.0 / x.shape[1]
    gram = np_(JK.rbf_gram(jnp.asarray(x), jnp.asarray(x), gamma=gamma))
    cfg = dict(C=C, tol=1e-3, selection=selection, shrink_every=shrink,
               check_every=16)
    jkp, tkp = JK.KernelParams(gamma=gamma), TK.KernelParams(gamma=gamma)
    jr = jsmo.binary_smo(
        jnp.asarray(x), jnp.asarray(y), cfg=jsmo.SMOConfig(**cfg),
        kernel=jkp, engine=JKE.DenseKernelEngine(jnp.asarray(x), jkp,
                                                 gram=jnp.asarray(gram)))
    tr = tsmo.binary_smo(
        tt(x), tt(y), cfg=tsmo.SMOConfig(**cfg), kernel=tkp,
        engine=TKE.DenseKernelEngine(tt(x), tkp, gram=tt(gram)))
    ja, ta = np_(jr.alpha), np_(tr.alpha)
    assert bool(jr.converged) and bool(tr.converged)
    np.testing.assert_array_equal(ja > 1e-8 * C, ta > 1e-8 * C)
    np.testing.assert_allclose(ta, ja, atol=1e-4 * C)
    assert float(tr.b) == pytest.approx(float(jr.b), abs=1e-4)
    assert int(tr.n_iter) == int(jr.n_iter), (
        f"n_iter port {int(tr.n_iter)} vs reference {int(jr.n_iter)}")
    assert int(tr.n_active) == int(jr.n_active)
    for a in (ja, ta):
        assert _certificate(gram, a, y, C, 1e-3) <= 1e-3
    jdf = jsmo.decision_function(jnp.asarray(x), jnp.asarray(y), jr.alpha,
                                 jr.b, jnp.asarray(xte), kernel=jkp)
    tdf = tsmo.decision_function(tt(x), tt(y), tr.alpha, tr.b, tt(xte),
                                 kernel=tkp)
    np.testing.assert_array_equal(np_(jdf) > 0, np_(tdf) > 0)
    np.testing.assert_allclose(np_(tdf), np_(jdf), rtol=2e-4, atol=1e-4)
    gj, gt = jnp.asarray(gram), tt(gram)
    assert float(tsmo.dual_objective(tt(y), tr.alpha, gt)) == pytest.approx(
        float(jsmo.dual_objective(jnp.asarray(y), jr.alpha, gj)), rel=1e-4)
    p = -np.ones_like(y)
    assert float(tsmo.qp_objective(tr.alpha, tt(y), tt(p), gt)) == \
        pytest.approx(float(jsmo.qp_objective(jr.alpha, jnp.asarray(y),
                                              jnp.asarray(p), gj)), rel=1e-4)


@pytest.mark.parametrize("backend", ["chunked", "pallas"])
def test_smo_warm_start_and_engines_match_reference(backend):
    """alpha0 warm start and the on-the-fly backends (the port's pallas
    backend runs its kernels' plain versions here)."""
    x, y, _ = _problem("breast")
    kw = dict(C=1.0, tol=1e-3, shrink_every=4)
    kp = dict(gamma=0.05)
    jr = jsmo.binary_smo(jnp.asarray(x), jnp.asarray(y),
                         cfg=jsmo.SMOConfig(**kw),
                         kernel=JK.KernelParams(**kp), engine="chunked")
    tr = tsmo.binary_smo(tt(x), tt(y), cfg=tsmo.SMOConfig(**kw),
                         kernel=TK.KernelParams(**kp), engine=backend)
    np.testing.assert_allclose(np_(tr.alpha), np_(jr.alpha), atol=1e-4)
    assert int(tr.n_iter) == int(jr.n_iter)
    warm = np_(jr.alpha)
    jw = jsmo.binary_smo(jnp.asarray(x), jnp.asarray(y),
                         cfg=jsmo.SMOConfig(**kw),
                         kernel=JK.KernelParams(**kp), engine="chunked",
                         alpha0=jnp.asarray(warm))
    tw = tsmo.binary_smo(tt(x), tt(y), cfg=tsmo.SMOConfig(**kw),
                         kernel=TK.KernelParams(**kp), engine=backend,
                         alpha0=tt(warm))
    assert int(tw.n_iter) == int(jw.n_iter)
    assert bool(tw.converged)
    np.testing.assert_allclose(np_(tw.alpha), np_(jw.alpha), atol=1e-4)


def test_solve_qp_rejects_box_excluding_zero():
    x, y = _blobs(n_per=8)
    with pytest.raises(ValueError, match="lo <= 0 <= hi"):
        tsmo.solve_qp(tt(x), tt(y), -torch.ones(16), 0.1, 1.0)


def test_solve_qp_per_sample_box_and_max_iter():
    """A per-sample box and the max_iter cap behave as the reference's
    (the cap is tested per check block, so n_iter may pass it by less
    than check_every)."""
    x, y = _blobs(n_per=30)
    n = len(y)
    rng = np.random.default_rng(1)
    hi = rng.uniform(0.2, 2.0, n).astype(np.float32)
    p = -np.ones(n, np.float32)
    for cfg in (dict(), dict(max_iter=10, check_every=4)):
        jr = jsmo.solve_qp(jnp.asarray(x), jnp.asarray(y), jnp.asarray(p),
                           0.0, jnp.asarray(hi), cfg=jsmo.SMOConfig(**cfg),
                           kernel=JK.KernelParams(gamma=0.3),
                           engine="dense")
        tr = tsmo.solve_qp(tt(x), tt(y), tt(p), 0.0, tt(hi),
                           cfg=tsmo.SMOConfig(**cfg),
                           kernel=TK.KernelParams(gamma=0.3),
                           engine="dense")
        assert int(tr.n_iter) == int(jr.n_iter)
        assert bool(tr.converged) == bool(jr.converged)
        np.testing.assert_allclose(np_(tr.alpha), np_(jr.alpha), atol=1e-4)


@pytest.mark.parametrize("tol,r", [(0.0, None), (1e-3, None), (0.0, 0.1)])
def test_kkt_violation_matches_reference(tol, r):
    rng = np.random.default_rng(2)
    n = 200
    alpha = rng.uniform(0, 1, n).astype(np.float32)
    alpha[rng.random(n) < 0.4] = 0.0
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    f = rng.normal(size=n).astype(np.float32) * 0.01
    mask = rng.random(n) < 0.95
    want = jsmo.kkt_violation(alpha, y, f, 0.0, 1.0, tol=tol, mask=mask, r=r)
    got = tsmo.kkt_violation(alpha, y, f, 0.0, 1.0, tol=tol, mask=mask, r=r)
    assert got.dtype == torch.float64
    assert float(got) == pytest.approx(float(want), rel=1e-6, abs=1e-9)
