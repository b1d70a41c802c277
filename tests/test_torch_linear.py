"""The port's dual coordinate descent (``core/linear.py``) against the
JAX reference.

* One epoch: the plain ``dcd_epoch`` (what ``ops.dcd_epoch`` runs on
  CPU tensors) fed the reference's own permutation and starting state
  gives the reference's epoch: beta to rtol 1e-4 (the dot products are
  summed in another order), the max projected gradient to 1e-5.
* Whole solves on one shared Phi: the two packages draw their
  per-epoch permutations from different generators, so they meet at
  the optimum, not step by step, and ``n_iter`` is not compared. Both
  converge, both certify ``kkt_violation(..., r=0) <= tol`` in float64
  (from a gradient recomputed from Phi, not the solver's w), ``w`` and
  ``b`` agree to 5 tol (both stop at a max projected gradient of tol/2,
  and the primal is 1-strongly convex in w; measured <= 2 tol), and
  held-out labels agree away from the boundary (|df| >= 1e-3).
* Warm start from the optimum re-certifies within 2 epochs (the
  reference's own behaviour; ROADMAP C.1), the mask freezes coordinates,
  ``max_iter`` bounds the epochs, refits are bit-identical.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import linear as JL
from repro_torch.core import linear as TL
from repro_torch.core import smo as tsmo
from repro_torch.core.svm import SVC as TSVC
from repro_torch.core.svm import SVR as TSVR
from repro_torch.data import make_blobs, make_synth_regression, normalize
from repro_torch.kernels import ops
from torch_helpers import np_, tt


def _problem(n=300, k=32, seed=3):
    rng = np.random.default_rng(seed)
    phi = (rng.normal(size=(n, k)) / np.sqrt(k)).astype(np.float32)
    y = np.sign(phi @ rng.normal(size=k)
                + 0.2 * rng.normal(size=n)).astype(np.float32)
    return phi, y, rng.normal(size=n).astype(np.float32)


def _certificate(phi, s, p, alpha, C, bias=1.0):
    """float64 KKT of the augmented-bias box QP, r pinned at 0."""
    phib = np.concatenate([np.asarray(phi, np.float64),
                           np.full((len(phi), 1), bias)], axis=1)
    a, s = np.asarray(alpha, np.float64), np.asarray(s, np.float64)
    f = phib @ (phib.T @ (a * s)) + s * np.asarray(p, np.float64)
    return float(tsmo.kkt_violation(a, s, f, 0.0, C, r=0.0))


def test_dcd_config_matches_reference():
    import dataclasses
    assert dataclasses.asdict(TL.DCDConfig()) == dataclasses.asdict(
        JL.DCDConfig())


@pytest.mark.parametrize("start", ["cold", "warm"])
def test_one_epoch_matches_reference_with_its_permutation(start):
    phi, y, _ = _problem(n=200, k=24, seed=1)
    n = len(y)
    rng = np.random.default_rng(0)
    beta0 = (np.zeros(n, np.float32) if start == "cold"
             else rng.uniform(0, 1, n).astype(np.float32))
    live = rng.random(n) < 0.9
    jr = JL.dcd_qp(jnp.asarray(phi), jnp.asarray(y), -1.0, 0.0, 1.0,
                   jnp.asarray(live), cfg=JL.DCDConfig(max_epochs=1),
                   alpha0=jnp.asarray(beta0))
    # the reference's first-epoch permutation (linear.py: fold_in(key, 0))
    perm = np.asarray(jax.random.permutation(
        jax.random.fold_in(jax.random.PRNGKey(0), 0), n))
    beta = tt(beta0 * live)
    coef = tt(np.where(live, y, 0.0)) * beta
    w = (tt(phi).T @ coef).contiguous()
    wb = torch.sum(coef).reshape(1)
    viol = ops.dcd_epoch(tt(phi), tt(y), -torch.ones(n), torch.zeros(n),
                         torch.ones(n), torch.sum(tt(phi) ** 2, dim=1) + 1.0,
                         tt(live, torch.bool), tt(perm, torch.int64), beta,
                         w, wb, bias=1.0)
    np.testing.assert_allclose(np_(beta), np_(jr.alpha), rtol=1e-4,
                               atol=1e-6)
    assert float(viol) == pytest.approx(float(jr.gap), abs=1e-5)
    ys = np.where(live, y, 0.0)
    np.testing.assert_allclose(phi.T @ (ys * np_(beta)), np_(jr.w),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n,k,tol", [(300, 32, 1e-3), (400, 64, 1e-3),
                                     (240, 16, 1e-4)])
def test_linear_svc_matches_reference_at_optimum(n, k, tol):
    phi, y, _ = _problem(n, k)
    cfg = dict(C=1.0, tol=tol)
    jr = JL.linear_svc(jnp.asarray(phi), jnp.asarray(y),
                       cfg=JL.DCDConfig(**cfg))
    tr = TL.linear_svc(tt(phi), tt(y), cfg=TL.DCDConfig(**cfg))
    assert bool(jr.converged) and bool(tr.converged)
    assert float(tr.gap) <= tol / 2
    for a in (np_(jr.alpha), np_(tr.alpha)):
        assert _certificate(phi, y, -np.ones(n), a, 1.0) <= tol
    np.testing.assert_allclose(np_(tr.w), np_(jr.w), rtol=0, atol=5 * tol)
    assert float(tr.b) == pytest.approx(float(jr.b), abs=5 * tol)
    # the served w is exact: Phi^T (y alpha), b = bias * sum(y alpha)
    np.testing.assert_allclose(np_(tr.w), phi.T @ (y * np_(tr.alpha)),
                               rtol=1e-5, atol=1e-5)
    zt = _problem(100, k, seed=9)[0]
    dj = zt @ np_(jr.w) + float(jr.b)
    dt = zt @ np_(tr.w) + float(tr.b)
    away = np.abs(dj) >= 1e-3
    np.testing.assert_array_equal(dt[away] > 0, dj[away] > 0)


@pytest.mark.parametrize("n,k,tol", [(300, 32, 1e-3), (240, 16, 1e-4)])
def test_linear_svr_matches_reference_at_optimum(n, k, tol):
    phi, _, t = _problem(n, k, seed=5)
    cfg = dict(C=1.0, tol=tol)
    jr = JL.linear_svr(jnp.asarray(phi), jnp.asarray(t), epsilon=0.1,
                       cfg=JL.DCDConfig(**cfg))
    tr = TL.linear_svr(tt(phi), tt(t), epsilon=0.1, cfg=TL.DCDConfig(**cfg))
    assert bool(jr.converged) and bool(tr.converged)
    s = np.r_[np.ones(n), -np.ones(n)]
    p = np.r_[0.1 - t, 0.1 + t]
    phi2 = np.concatenate([phi, phi])
    for a2 in (np_(jr.alpha), np_(tr.alpha)):
        assert _certificate(phi2, s, p, a2, 1.0) <= tol
    np.testing.assert_array_equal(np_(tr.beta),
                                  np_(tr.alpha)[:n] - np_(tr.alpha)[n:])
    np.testing.assert_allclose(np_(tr.w), np_(jr.w), rtol=0, atol=5 * tol)
    assert float(tr.b) == pytest.approx(float(jr.b), abs=5 * tol)


def test_dcd_mask_freezes_coordinates():
    phi, y, _ = _problem(60, 8, seed=0)
    mask = np.ones(60, bool)
    mask[40:] = False
    r = TL.linear_svc(tt(phi), tt(y), mask=torch.from_numpy(mask))
    ref = JL.linear_svc(jnp.asarray(phi), jnp.asarray(y),
                        mask=jnp.asarray(mask))
    assert np.all(np_(r.alpha)[40:] == 0.0) and bool(r.converged)
    np.testing.assert_allclose(np_(r.w), np_(ref.w), atol=5e-3)
    # a masked SVR sample freezes both of its doubled variables
    rs = TL.linear_svr(tt(phi), tt(y), epsilon=0.1,
                       mask=torch.from_numpy(mask))
    assert np.all(np_(rs.alpha)[40:60] == 0.0)
    assert np.all(np_(rs.alpha)[100:] == 0.0)


def test_dcd_warm_start_from_optimum_converges_within_two_epochs():
    """The reference takes 2 epochs here (ROADMAP C.1: its own test
    wants 1 and fails); the certifying epoch nudges free coordinates by
    tol-scale steps."""
    rng = np.random.default_rng(3)
    phi = rng.normal(size=(80, 12)).astype(np.float32)
    y = np.sign(rng.normal(size=80)).astype(np.float32)
    cfg = TL.DCDConfig(tol=1e-4)
    cold = TL.linear_svc(tt(phi), tt(y), cfg=cfg)
    assert bool(cold.converged)
    warm = TL.linear_svc(tt(phi), tt(y), cfg=cfg, alpha0=cold.alpha)
    assert bool(warm.converged) and int(warm.n_iter) <= 2
    np.testing.assert_allclose(np_(warm.alpha), np_(cold.alpha), atol=1e-4)
    ref_warm = JL.linear_svc(
        jnp.asarray(phi), jnp.asarray(y), cfg=JL.DCDConfig(tol=1e-4),
        alpha0=JL.linear_svc(jnp.asarray(phi), jnp.asarray(y),
                             cfg=JL.DCDConfig(tol=1e-4)).alpha)
    assert int(ref_warm.n_iter) <= 2
    # an SVR warm start from beta splits into [max(beta,0); max(-beta,0)]
    t = rng.normal(size=80).astype(np.float32)
    svr = TL.linear_svr(tt(phi), tt(t), epsilon=0.1, cfg=cfg)
    again = TL.linear_svr(tt(phi), tt(t), epsilon=0.1, cfg=cfg,
                          alpha0=svr.beta)
    assert bool(again.converged) and int(again.n_iter) <= 2


def test_max_iter_bounds_lowrank_epochs():
    x, y = make_blobs(80, 2, 6, sep=3.0, seed=5)
    x = normalize(x)
    clf = TSVC(engine="nystrom", rank=32, max_iter=2, device="cpu")
    assert clf.dcd_cfg.max_epochs == 2
    clf.fit(x, y)
    assert clf.n_iter_ == 2 and not clf.converged_
    free = TSVC(engine="nystrom", rank=32, device="cpu").fit(x, y)
    assert free.converged_ and free.n_iter_ > 2
    xr, yr = make_synth_regression(150, 5, seed=5)
    reg = TSVR(engine="rff", rank=32, max_iter=1, device="cpu")
    assert reg.dcd_cfg.max_epochs == 1
    reg.fit(normalize(xr), yr)
    assert reg.n_iter_ == 1 and not reg.converged_
    zero = TL.linear_svc(tt(x[:10]), tt(np.where(y[:10] == 0, 1.0, -1.0)),
                         cfg=TL.DCDConfig(max_epochs=0))
    assert int(zero.n_iter) == 0 and not bool(zero.converged)
    assert np.isinf(float(zero.gap))


def test_lowrank_fit_deterministic_and_seeded():
    x, y = make_blobs(100, 2, 6, sep=3.0, seed=7)
    x = normalize(x)
    a = TSVC(engine="rff", rank=64, seed=11, device="cpu").fit(x, y)
    b = TSVC(engine="rff", rank=64, seed=11, device="cpu").fit(x, y)
    assert np.array_equal(a.alpha_, b.alpha_) and np.array_equal(a.w_, b.w_)
    c = TSVC(engine="rff", rank=64, seed=12, device="cpu").fit(x, y)
    assert not np.array_equal(a.w_, c.w_)   # the seed draws the map


@pytest.mark.parametrize("engine", ["nystrom", "rff"])
def test_lowrank_fits_certify(engine):
    """The reference's low-rank certificates (tests/test_kkt_certificate
    .py): the SVC and SVR duals at r = 0 over the approximate Gram."""
    x, yc = make_blobs(90, 2, 6, sep=1.2, seed=4)
    x = normalize(x)
    clf = TSVC(engine=engine, rank=48, device="cpu").fit(x, yc)
    assert clf.converged_
    phi = np_(clf._feature_map.transform(tt(x)))
    yy = np.where(yc == clf.classes_[1], 1.0, -1.0)
    assert _certificate(phi, yy, -np.ones(len(x)), clf.alpha_,
                        1.0) <= clf.smo_cfg.tol
    xr, yr = make_synth_regression(120, 4, kind="sinc", noise=0.05, seed=2)
    reg = TSVR(engine=engine, rank=48, epsilon=0.1, device="cpu").fit(xr, yr)
    assert reg.converged_
    phi = np_(reg._feature_map.transform(tt(xr)))
    n = len(xr)
    assert _certificate(np.concatenate([phi, phi]),
                        np.r_[np.ones(n), -np.ones(n)],
                        np.r_[0.1 - yr, 0.1 + yr], reg.alpha_raw_,
                        1.0) <= reg.smo_cfg.tol
