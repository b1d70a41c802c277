"""The port's epsilon-SVR against the JAX reference.

* ``svr_smo``'s QP (the doubled spec over [x; x] on the ported
  ``solve_qp``) on one shared doubled Gram: without shrinking, raw
  alphas, beta, b and n_iter equal the reference's bit for bit. With
  shrinking they are not bitwise: the un-shrink re-check recomputes the
  gradient by a matvec that each package sums in its own order, so
  n_iter is equal but alphas agree to 1e-4 C and b to 1e-4 (the bounds
  of the binary SMO test, tests/test_torch_smo.py).
* ``SVR`` end to end, exact (dense / chunked / pallas engines, each
  package with its own Gram) and low-rank (rff / nystrom): both fits
  converge and certify at tol by a float64 KKT check of a recomputed
  gradient; predictions agree to 2 tol (the gap at which both solvers
  stop), held-out MSE within the reference's own low-rank margin
  (tests/test_approx.py:204-211).

The port runs on the CPU here (``device="cpu"``), so its kernels run
their plain versions.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import kernels as JK
from repro.core import smo as jsmo
from repro.core.svm import SVR as JSVR
from repro_torch.core import kernel_engine as TKE
from repro_torch.core import kernels as TK
from repro_torch.core import smo as tsmo
from repro_torch.core.svm import SVR as TSVR
from repro_torch.data import make_synth_regression
from torch_helpers import np_, tt


def _regression(n=160, d=4, seed=3, noise=0.05):
    x, y = make_synth_regression(n, d, kind="sinc", noise=noise, seed=seed)
    return x, y


def _doubled_certificate(gram2, a2, y, eps, C):
    """float64 KKT of the doubled epsilon-SVR QP, gradient from scratch."""
    n = len(y)
    s = np.r_[np.ones(n), -np.ones(n)]
    p = np.r_[eps - y, eps + y].astype(np.float64)
    f = np.asarray(gram2, np.float64) @ (np.asarray(a2, np.float64) * s) \
        + s * p
    return float(tsmo.kkt_violation(np.asarray(a2, np.float64), s, f, 0.0,
                                    C))


@pytest.mark.parametrize("shrink", [0, 4])
@pytest.mark.parametrize("eps,C", [(0.1, 1.0), (0.05, 10.0)])
def test_svr_qp_matches_reference_on_same_gram(eps, C, shrink):
    x, y = _regression()
    gamma = 0.5
    x2 = np.concatenate([x, x])
    gram2 = np_(JK.rbf_gram(jnp.asarray(x2), jnp.asarray(x2), gamma=gamma))
    cfg = dict(C=C, tol=1e-3, shrink_every=shrink, check_every=16)
    jkp, tkp = JK.KernelParams(gamma=gamma), TK.KernelParams(gamma=gamma)
    s, p, lo, hi = jsmo._svr_spec(jnp.asarray(y), eps, C)
    jr = jsmo.solve_qp(jnp.asarray(x2), s, p, lo, hi,
                       cfg=jsmo.SMOConfig(**cfg), kernel=jkp,
                       gram=jnp.asarray(gram2))
    ts, tp, tlo, thi = tsmo._svr_spec(tt(y), eps, C)
    for a, b in ((ts, s), (tp, p), (tlo, lo), (thi, hi)):
        np.testing.assert_array_equal(np_(a), np_(b))
    tr = tsmo.solve_qp(tt(x2), ts, tp, tlo, thi, cfg=tsmo.SMOConfig(**cfg),
                       kernel=tkp,
                       engine=TKE.DenseKernelEngine(tt(x2), tkp,
                                                    gram=tt(gram2)))
    jres, tres = jsmo._svr_result(jr, len(y)), tsmo._svr_result(tr, len(y))
    assert bool(jres.converged) and bool(tres.converged)
    assert int(tres.n_iter) == int(jres.n_iter)
    if shrink:
        # the un-shrink re-check recomputes f by a matvec summed in each
        # package's own order; the solve then goes on from gradients a
        # few ulp apart: alphas within 1e-4 C, b within 1e-4
        np.testing.assert_allclose(np_(tres.alpha), np_(jres.alpha),
                                   atol=1e-4 * C)
        assert float(tres.b) == pytest.approx(float(jres.b), abs=1e-4)
    else:
        # bit for bit: the same pair sequence to the same optimum
        np.testing.assert_array_equal(np_(tres.alpha), np_(jres.alpha))
        np.testing.assert_array_equal(np_(tres.beta), np_(jres.beta))
        assert float(tres.b) == float(jres.b)
    assert _doubled_certificate(gram2, np_(tres.alpha), y, eps, C) <= 1e-3


def test_svr_smo_own_grams_match_reference():
    """svr_smo itself, each package building its own doubled Gram: both
    certify, beta within 2 tol C-scale, predictions within 2 tol."""
    x, y = _regression(seed=5)
    gamma = 0.5
    kw = dict(epsilon=0.1)
    jr = jsmo.svr_smo(jnp.asarray(x), jnp.asarray(y), cfg=jsmo.SMOConfig(),
                      kernel=JK.KernelParams(gamma=gamma), engine="dense",
                      **kw)
    tr = tsmo.svr_smo(tt(x), tt(y), cfg=tsmo.SMOConfig(),
                      kernel=TK.KernelParams(gamma=gamma), engine="dense",
                      **kw)
    assert bool(jr.converged) and bool(tr.converged)
    x2 = np.concatenate([x, x])
    gram2 = np_(TK.rbf_gram(tt(x2), tt(x2), gamma=gamma))
    for a2 in (np_(jr.alpha), np_(tr.alpha)):
        assert _doubled_certificate(gram2, a2, y, 0.1, 1.0) <= 1e-3
    gram = gram2[:len(x), :len(x)]
    pj = gram @ np_(jr.beta) + float(jr.b)
    pt = gram @ np_(tr.beta) + float(tr.b)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=2e-3)


def test_svr_smo_rejects_a_bound_engine():
    x, y = _regression(40)
    eng = TKE.make_engine(tt(x), TK.KernelParams(gamma=0.5), "dense")
    with pytest.raises(ValueError, match="doubled"):
        tsmo.svr_smo(tt(x), tt(y), engine=eng)


@pytest.mark.parametrize("engine", ["dense", "chunked", "pallas"])
def test_svr_exact_matches_reference_end_to_end(engine):
    x, y = _regression(240, seed=7)
    xtr, ytr, xte, yte = x[:180], y[:180], x[180:], y[180:]
    kw = dict(C=1.0, epsilon=0.1, shrink_every=4 if engine != "dense" else 0)
    j = JSVR(engine="chunked" if engine == "pallas" else engine,
             **kw).fit(xtr, ytr)
    t = TSVR(engine=engine, device="cpu", **kw).fit(xtr, ytr)
    assert j.converged_ and t.converged_
    assert t.kernel_params.gamma == pytest.approx(j.kernel_params.gamma,
                                                  rel=1e-6)
    x2 = np.concatenate([xtr, xtr])
    gram2 = np_(TK.rbf_gram(tt(x2), tt(x2), gamma=t.kernel_params.gamma))
    for reg in (j, t):
        assert _doubled_certificate(gram2, reg.alpha_raw_, ytr, 0.1,
                                    1.0) <= 1e-3
    np.testing.assert_allclose(t.predict(xte), j.predict(xte), rtol=0,
                               atol=2e-3)
    np.testing.assert_allclose(t._predict_engine(xte), t.predict(xte),
                               rtol=2e-4, atol=1e-4)
    assert t.score(xte, yte) == pytest.approx(j.score(xte, yte), abs=1e-2)
    np.testing.assert_array_equal(
        t.support_, np.where(np.abs(t.beta_) > 1e-8 * 1.0)[0])


@pytest.mark.parametrize("engine", ["rff", "nystrom"])
def test_svr_lowrank_close_to_exact(engine):
    """The reference's own margin (tests/test_approx.py): low-rank MSE
    within 0.05 of the exact fit's; and within the same margin of the
    reference's low-rank fit of the same size."""
    x, y = make_synth_regression(300, 4, kind="sinc", noise=0.05, seed=3)
    reg_e = TSVR(engine="dense", epsilon=0.1, device="cpu").fit(x[:220],
                                                               y[:220])
    reg_a = TSVR(engine=engine, rank=128, epsilon=0.1,
                 device="cpu").fit(x[:220], y[:220])
    ref_a = JSVR(engine=engine, rank=128, epsilon=0.1).fit(x[:220], y[:220])
    assert reg_a.converged_ and reg_a.w_.shape == (128,)

    def mse(p):
        return float(np.mean((p - y[220:]) ** 2))
    mse_e, mse_a = mse(reg_e._predict_engine(x[220:])), mse(
        reg_a._predict_engine(x[220:]))
    assert mse_a <= mse_e + 0.05, (mse_a, mse_e)
    assert mse_a <= mse(ref_a._predict_engine(x[220:])) + 0.05
    np.testing.assert_allclose(reg_a.predict(x[220:]),
                               reg_a._predict_engine(x[220:]), atol=1e-5)


def test_svr_score_and_degenerate_tube():
    """All targets inside one 2 eps tube: beta = 0, the midpoint bias,
    constant predictions (the reference's analytic case); R^2 follows
    sklearn's convention."""
    x = np.array([[0.0], [0.3], [0.6], [1.0]], np.float32)
    y = np.array([0.0, 0.05, -0.05, 0.02], np.float32)
    reg = TSVR(kernel="rbf", gamma=0.5, epsilon=0.2, device="cpu").fit(x, y)
    ref = JSVR(kernel="rbf", gamma=0.5, epsilon=0.2).fit(x, y)
    assert reg.n_support_ == 0 == ref.n_support_
    assert reg.b_ == pytest.approx(ref.b_, abs=1e-6)
    np.testing.assert_allclose(reg.predict(x), np.full(4, reg.b_), atol=1e-6)
    assert reg.score(x, y) == pytest.approx(ref.score(x, y), abs=1e-6)
    assert reg.score(x, np.full(4, reg.b_, np.float32)) == 1.0


def test_svr_linear_kernel_two_point_exact():
    """x = [0, 1], y = [0, 2], eps = 0.5, linear kernel, large C: the
    unique dual beta = [-1, +1] and f(z) = z + 0.5 (the reference's
    analytic fixture)."""
    x = np.array([[0.0], [1.0]], np.float32)
    y = np.array([0.0, 2.0], np.float32)
    r = tsmo.svr_smo(tt(x), tt(y), epsilon=0.5, cfg=tsmo.SMOConfig(C=10.0),
                     kernel=TK.KernelParams(name="linear"))
    assert bool(r.converged)
    np.testing.assert_allclose(np_(r.beta), [-1.0, 1.0], atol=5e-3)
    assert abs(float(r.b) - 0.5) <= 5e-3
    assert torch.equal(r.alpha[:2] - r.alpha[2:], r.beta)
