"""The port's GD baseline (``repro_torch/core/gd.py``) against the JAX
reference (``repro/core/gd.py``), the paper's TensorFlow side.

* ``binary_gd`` / ``svr_gd`` on the same numpy inputs as the
  reference's, each package with its own Gram (the reference through
  its plain dense path): the port's closed-form gradient equals
  ``jax.grad``'s for a symmetric K, so alphas, beta and the loss curve
  agree to rtol 1e-4 / atol 1e-4, b to atol 1e-4, n_iter exactly.
* The trajectory properties of ``tests/test_gd.py``: the loss descends
  monotonically after 50 warm-up steps, the box holds at every sampled
  step, masked SVR samples stay inert.
* The dense, chunked and pallas engines (plain paths on the CPU) give
  the same fit, and ``svr_gd``'s ``[u; u]`` matvec equals the loop on
  the doubled engine over [x; x].
* The task layer: ``fit_taskset(solver="gd")`` and
  ``sequential_ovo_fit`` against the reference's; each task of a
  bucket equal bit for bit to its lone ``binary_gd`` on its row of the
  bucket (the task-axis matvec gives each task its lone bits, and the
  sums accumulate in float64).
* ``SVC`` / ``SVR(solver="gd")`` labels and R^2 against the reference's,
  and GD packs served across the two packages.

The port runs on the CPU here (``device="cpu"``).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro import serve as jserve
from repro.core import dist as jdist
from repro.core import gd as jgd
from repro.core import kernels as JK
from repro.core import multiclass as JMC
from repro.core import ovo as jovo
from repro.core.svm import SVC as JSVC, SVR as JSVR
from repro.data import load_iris, make_synth_regression, normalize
from repro_torch import serve as tserve
from repro_torch.core import dist as tdist
from repro_torch.core import gd as tgd
from repro_torch.core import kernel_engine as TKE
from repro_torch.core import kernels as TK
from repro_torch.core import multiclass as TMC
from repro_torch.core import ovo as tovo
from repro_torch.core.svm import SVC as TSVC, SVR as TSVR
from torch_helpers import np_, tt

TOL = dict(rtol=1e-4, atol=1e-4)
WARMUP = 50


def _binary_iris():
    x, y = load_iris()
    x = normalize(x)
    sel = y != 2
    return x[sel], np.where(y[sel] == 0, 1.0, -1.0).astype(np.float32)


def _gammas(x):
    jkp = JK.resolve_gamma(JK.KernelParams(), jnp.asarray(x))
    return jkp, TK.KernelParams(gamma=float(jkp.gamma))


def _assert_close(t, j, beta=False):
    for name in (("beta", "alpha") if beta else ("alpha",)) + ("loss_curve",):
        np.testing.assert_allclose(np_(getattr(t, name)),
                                   np_(getattr(j, name)), **TOL)
    np.testing.assert_allclose(float(t.b), float(j.b), rtol=0, atol=1e-4)
    assert int(t.n_iter) == int(j.n_iter)


# ------------------------------------------------------- against the reference
@pytest.mark.parametrize("C,lr,steps", [(1.0, 0.01, 400), (0.7, 0.05, 150)])
def test_binary_gd_matches_reference(C, lr, steps):
    x, y = _binary_iris()
    jkp, tkp = _gammas(x)
    j = jgd.binary_gd(jnp.asarray(x), jnp.asarray(y), kernel=jkp,
                      cfg=jgd.GDConfig(C=C, lr=lr, steps=steps))
    t = tgd.binary_gd(tt(x), tt(y), kernel=tkp,
                      cfg=tgd.GDConfig(C=C, lr=lr, steps=steps))
    _assert_close(t, j)


@pytest.mark.parametrize("C,lr,steps", [(1.0, 0.01, 400), (0.5, 0.05, 150)])
def test_svr_gd_matches_reference(C, lr, steps):
    x, y = make_synth_regression(100, 3, kind="sinc", noise=0.05, seed=0)
    jkp, tkp = _gammas(x)
    j = jgd.svr_gd(jnp.asarray(x), jnp.asarray(y), epsilon=0.1, kernel=jkp,
                   cfg=jgd.GDConfig(C=C, lr=lr, steps=steps))
    t = tgd.svr_gd(tt(x), tt(y), epsilon=0.1, kernel=tkp,
                   cfg=tgd.GDConfig(C=C, lr=lr, steps=steps))
    _assert_close(t, j, beta=True)


def test_binary_gd_masked_and_given_gram_match_reference():
    """A padded, masked problem (labels 0 on padding) and the ``gram=``
    shim, each on the same Gram in both packages."""
    x, y = _binary_iris()
    x = np.concatenate([x, x[:7]])
    y = np.concatenate([y, np.zeros(7, np.float32)])
    mask = np.arange(len(y)) < 96
    gram = np_(JK.rbf_gram(jnp.asarray(x), jnp.asarray(x), gamma=0.3))
    cfg = dict(lr=0.02, steps=120)
    j = jgd.binary_gd(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask),
                      gram=jnp.asarray(gram), cfg=jgd.GDConfig(**cfg))
    t = tgd.binary_gd(tt(x), tt(y), tt(mask, torch.bool), gram=tt(gram),
                      cfg=tgd.GDConfig(**cfg))
    _assert_close(t, j)
    assert not np_(t.alpha)[96:].any()


# ----------------------------------------------- trajectory (tests/test_gd.py)
def _monotone(losses):
    losses = np.asarray(losses, np.float64)
    diffs = np.diff(losses[WARMUP:])
    assert np.all(diffs <= 1e-5), f"max increase {diffs.max():.2e}"
    assert losses[-1] < losses[WARMUP]


def test_binary_loss_monotone_after_warmup():
    x, y = _binary_iris()
    _, kp = _gammas(x)
    r = tgd.binary_gd(tt(x), tt(y), cfg=tgd.GDConfig(lr=0.01, steps=400),
                      kernel=kp)
    _monotone(np_(r.loss_curve))


def test_svr_loss_monotone_after_warmup():
    x, y = make_synth_regression(100, 3, kind="sinc", noise=0.05, seed=0)
    _, kp = _gammas(x)
    r = tgd.svr_gd(tt(x), tt(y), epsilon=0.1, kernel=kp,
                   cfg=tgd.GDConfig(lr=0.01, steps=400))
    _monotone(np_(r.loss_curve))


@pytest.mark.parametrize("kind", ["svc", "svr"])
def test_projection_invariant_every_step(kind):
    """0 <= alpha <= C after every step: the state after k steps of the
    deterministic fixed-step loop is trajectory point k."""
    if kind == "svc":
        x, y = _binary_iris()
        c = 0.7
    else:
        x, y = make_synth_regression(80, 2, kind="sinc", noise=0.05,
                                     seed=1)
        c = 0.5
    _, kp = _gammas(x)
    for steps in (1, 2, 5, 13, 40, 150):
        cfg = tgd.GDConfig(C=c, lr=0.05, steps=steps)
        if kind == "svc":
            r = tgd.binary_gd(tt(x), tt(y), cfg=cfg, kernel=kp)
        else:
            r = tgd.svr_gd(tt(x), tt(y), epsilon=0.1, cfg=cfg, kernel=kp)
            np.testing.assert_array_equal(np_(r.beta),
                                          np_(r.alpha[:80] - r.alpha[80:]))
        a = np_(r.alpha)
        assert a.min() >= 0.0 and a.max() <= c, f"step {steps}"


def test_svr_gd_masked_samples_inert():
    x, y = make_synth_regression(60, 2, kind="sinc", noise=0.05, seed=2)
    _, kp = _gammas(x)
    cfg = tgd.GDConfig(lr=0.01, steps=200)
    r0 = tgd.svr_gd(tt(x[:50]), tt(y[:50]), epsilon=0.1, cfg=cfg, kernel=kp)
    mask = np.r_[np.ones(50, bool), np.zeros(10, bool)]
    r1 = tgd.svr_gd(tt(x), tt(y), tt(mask, torch.bool), epsilon=0.1,
                    cfg=cfg, kernel=kp)
    assert not np_(r1.alpha).reshape(2, 60)[:, 50:].any()
    np.testing.assert_allclose(np_(r1.beta[:50]), np_(r0.beta), rtol=1e-4,
                               atol=1e-5)


# ------------------------------------------------------------------ engines
def test_engines_give_the_same_fit():
    x, y = _binary_iris()
    _, kp = _gammas(x)
    cfg = tgd.GDConfig(lr=0.01, steps=200)
    want = tgd.binary_gd(tt(x), tt(y), cfg=cfg, kernel=kp)
    for engine in ("dense", "chunked", "pallas",
                   TKE.make_engine(tt(x), kp, "chunked")):
        got = tgd.binary_gd(tt(x), tt(y), cfg=cfg, kernel=kp, engine=engine)
        _assert_close(got, want)
    xr, yr = make_synth_regression(90, 3, kind="sinc", noise=0.05, seed=4)
    _, kp = _gammas(xr)
    want = tgd.svr_gd(tt(xr), tt(yr), cfg=cfg, kernel=kp)
    for engine in ("dense", "chunked", "pallas"):
        got = tgd.svr_gd(tt(xr), tt(yr), cfg=cfg, kernel=kp, engine=engine)
        _assert_close(got, want, beta=True)
    with pytest.raises(ValueError, match="bound engine"):
        tgd.svr_gd(tt(xr), tt(yr), engine=TKE.make_engine(tt(xr), kp))


def test_svr_fold_equals_the_doubled_engine():
    """``svr_gd``'s matvec [u; u], u = K(x)(alpha - alpha*), against the
    same loop on the doubled engine over [x; x] (the reference's)."""
    x, y = make_synth_regression(90, 3, kind="sinc", noise=0.05, seed=5)
    _, kp = _gammas(x)
    cfg = tgd.GDConfig(C=0.8, lr=0.02, steps=300)
    got = tgd.svr_gd(tt(x), tt(y), epsilon=0.1, cfg=cfg, kernel=kp)
    s = tt(np.r_[np.ones(90), -np.ones(90)])
    p = tt(np.r_[0.1 - y, 0.1 + y])
    doubled = TKE.make_engine(tt(np.concatenate([x, x])), kp, "dense")
    alpha, _, losses = tgd._descend(doubled.matvec, s, p,
                                    torch.ones(180, dtype=torch.bool), cfg)
    np.testing.assert_allclose(np_(got.alpha), np_(alpha), **TOL)
    np.testing.assert_allclose(np_(got.loss_curve), np_(losses), **TOL)


# --------------------------------------------------------------- task layer
def _iris_tasksets():
    x, y = load_iris()
    return (TMC.get_strategy("ovo").build_taskset(x, y),
            JMC.get_strategy("ovo").build_taskset(x, y))


@pytest.mark.parametrize("engine", ["dense", "pallas"])
def test_fit_taskset_gd_matches_reference(engine):
    ts, jts = _iris_tasksets()
    cfg = dict(lr=0.01, steps=300)
    t = tdist.fit_taskset(ts, solver="gd", gd_cfg=tgd.GDConfig(**cfg),
                          kernel=TK.KernelParams(gamma=0.25), engine=engine,
                          device="cpu")
    j = jdist.fit_taskset(jts, solver="gd", gd_cfg=jgd.GDConfig(**cfg),
                          kernel=JK.KernelParams(gamma=0.25), engine=engine)
    np.testing.assert_allclose(t.alpha, j.alpha, **TOL)
    np.testing.assert_allclose(t.b, j.b, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(t.n_iter, j.n_iter)
    assert t.converged.all() and j.converged.all()
    with pytest.raises(ValueError, match="solver='smo'"):
        tdist.fit_taskset(ts, solver="gd", svr_epsilon=0.1, device="cpu")


@pytest.mark.parametrize("engine", ["dense", "chunked", "pallas"])
def test_bucket_task_is_its_lone_binary_gd_bit_equal(engine):
    """Each task of a bucket stepped on the task axis equals its lone
    ``binary_gd`` on its row of the bucket (padded, masked), bit for
    bit, and ``fit_taskset`` returns those bits."""
    x, y = load_iris()
    ts = TMC.get_strategy("ovr").build_taskset(normalize(x), y)
    bucket = TMC.build_schedule(ts.sizes, TMC.ScheduleConfig(
        bucket_by="none", pad_width=160)).buckets[0]
    xt, yt, mk, _ = tdist._bucket_arrays(ts, bucket)
    kw = dict(cfg=tgd.GDConfig(lr=0.02, steps=150),
              kernel=TK.KernelParams(gamma=0.3), engine=engine)
    r = tgd.binary_gd_tasks(tt(xt), tt(yt), tt(mk, torch.bool), **kw)
    for s in range(len(xt)):
        lone = tgd.binary_gd(tt(xt[s]), tt(yt[s]), tt(mk[s], torch.bool),
                             **kw)
        assert torch.equal(lone.alpha, r.alpha[s])
        assert torch.equal(lone.b, r.b[s])
        assert torch.equal(lone.loss_curve, r.loss_curve[s])
    fit = tdist.fit_taskset(ts, TMC.build_schedule(ts.sizes, TMC.ScheduleConfig(
        bucket_by="none", pad_width=160)), solver="gd", gd_cfg=kw["cfg"],
        kernel=kw["kernel"], engine=engine, device="cpu")
    for s, t in enumerate(bucket.task_ids.reshape(-1)):
        k = ts.sizes[t]
        np.testing.assert_array_equal(fit.alpha[t, :k], np_(r.alpha[s, :k]))
        assert fit.b[t] == np_(r.b[s])


@pytest.mark.parametrize("solver", ["gd", "smo"])
def test_sequential_ovo_fit_matches_reference(solver):
    """The paper's "Multi-Tensorflow": one separately dispatched solve a
    task. GD within the tolerances; SMO on each package's own Gram may
    part at a one-ulp difference (tests/test_torch_multiclass.py), so it
    is held on its labels."""
    x, y = load_iris()
    x = normalize(x)
    kp = 0.25
    tk = tovo.build_tasks(x, y, pad_tasks_to=4)
    jk = jovo.build_tasks(x, y, pad_tasks_to=4)
    gcfg = dict(lr=0.01, steps=300)
    t = tdist.sequential_ovo_fit(tk, solver=solver, n_real_tasks=3,
                                 gd_cfg=tgd.GDConfig(**gcfg),
                                 kernel=TK.KernelParams(gamma=kp),
                                 device="cpu")
    j = jdist.sequential_ovo_fit(jk, solver=solver, n_real_tasks=3,
                                 gd_cfg=jgd.GDConfig(**gcfg),
                                 kernel=JK.KernelParams(gamma=kp))
    assert np_(t.converged).all() and np_(j.converged).all()
    if solver == "gd":
        np.testing.assert_allclose(np_(t.alpha), np_(j.alpha), **TOL)
        np.testing.assert_allclose(np_(t.b), np_(j.b), rtol=0, atol=1e-4)
        np.testing.assert_array_equal(np_(t.n_iter), np_(j.n_iter))
    for task in range(3):   # each pair's labels over all rows
        gram = np_(JK.rbf_gram(jnp.asarray(x), jnp.asarray(tk.x[task]),
                               gamma=kp))
        t_df, j_df = (gram @ (np_(f.alpha)[task] * tk.y[task])
                      + np_(f.b)[task] for f in (t, j))
        np.testing.assert_array_equal(t_df > 0, j_df > 0)


# --------------------------------------------------------------- entry points
def test_svc_gd_matches_reference():
    x, y = load_iris()
    x = normalize(x)
    for xx, yy in ((x[y != 2], y[y != 2]), (x, y)):   # binary, multiclass
        j = JSVC(solver="gd", gd_steps=300).fit(xx, yy)
        t = TSVC(solver="gd", gd_steps=300, device="cpu").fit(xx, yy)
        assert t.converged_ and j.converged_ and t.n_iter_ == j.n_iter_
        np.testing.assert_array_equal(t.predict(xx), j.predict(xx))


def test_svr_gd_matches_reference():
    x, y = make_synth_regression(200, 4, kind="sinc", noise=0.05, seed=3)
    j = JSVR(solver="gd", gd_steps=400).fit(x, y)
    t = TSVR(solver="gd", gd_steps=400, device="cpu").fit(x, y)
    assert t.converged_ and t.n_iter_ == j.n_iter_ == 400
    np.testing.assert_allclose(t.loss_curve_, j.loss_curve_, **TOL)
    np.testing.assert_allclose(t.beta_, j.beta_, **TOL)
    assert t.score(x, y) == pytest.approx(j.score(x, y), abs=1e-4)


@pytest.mark.parametrize("kind", ["svc", "svr", "ovo"])
def test_gd_packs_serve_across_packages(tmp_path, kind):
    """A GD fit packed by either package loads and serves in the other."""
    x, y = load_iris()
    x = normalize(x)
    if kind == "svc":
        x, y = x[y != 2], y[y != 2]
    if kind == "svr":
        x, y = make_synth_regression(120, 3, kind="sinc", noise=0.05,
                                     seed=6)
        j, t = (JSVR(solver="gd").fit(x, y),
                TSVR(solver="gd", device="cpu").fit(x, y))
    else:
        j, t = (JSVC(solver="gd").fit(x, y),
                TSVC(solver="gd", device="cpu").fit(x, y))
    jserve.save(tmp_path / "ref.npz", jserve.pack(j))
    tserve.save(tmp_path / "port.npz", tserve.pack(t))
    got = tserve.Predictor(tserve.load(tmp_path / "ref.npz"), device="cpu")
    want = jserve.Predictor(jserve.load(tmp_path / "ref.npz"))
    back = jserve.Predictor(jserve.load(tmp_path / "port.npz"))
    mine = tserve.Predictor(tserve.load(tmp_path / "port.npz"), device="cpu")
    tol = dict(rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got.decision_function(x),
                               want.decision_function(x), **tol)
    np.testing.assert_allclose(back.decision_function(x),
                               mine.decision_function(x), **tol)
    if kind != "svr":
        np.testing.assert_array_equal(got.predict(x), want.predict(x))
        np.testing.assert_array_equal(back.predict(x), mine.predict(x))
