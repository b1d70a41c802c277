"""The port's cascade SVM (``repro_torch/core/cascade.py``) against the JAX
reference (``repro/core/cascade.py``).

* The host numpy pieces — ``partition_indices``, ``_repair_equality``
  and ``_merge`` — equal the reference's bit for bit.
* A one-shard cascade IS the port's unsharded fit, bit for bit: exact
  SVC and SVR (the same ``binary_smo`` / ``svr_smo`` call ``SVC.fit`` /
  ``SVR.fit`` make), low-rank SVC and SVR (the same ``linear_svc`` /
  ``linear_svr``).
* S in {2, 4} passes the float64 KKT certificate at tol on every
  variant, recomputed here from scratch over the full dataset (never
  trusted from the model), for every task of a multiclass fit too.
  SMO trajectories are chaotic (ROADMAP C, "not faults"), so the
  reference's cascade is held on labels, and certificates by both being
  <= tol.
* A refit is bit-identical; a low-rank cascade level (one
  ``linear_svc_tasks`` / ``linear_svr_tasks`` over the nodes' rows of
  the shared Phi) equals its lone solves bit for bit; cascade fits pack
  and serve in both packages; the validation errors match the
  reference's, a mesh's worker-axis mismatch included (the cascade on
  a mesh is held against the one without in
  ``tests/test_torch_dist_mesh.py``).

The port runs on the CPU here (``device="cpu"``).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro import serve as jserve
from repro.core import cascade as jcascade
from repro.core import kernels as JK
from repro.core.svm import SVC as JSVC, SVR as JSVR
from repro_torch import serve as tserve
from repro_torch.core import cascade as tcascade
from repro_torch.core import linear as tlinear
from repro_torch.core import smo as tsmo
from repro_torch.core.svm import SVC as TSVC, SVR as TSVR
from repro_torch.data import make_blobs, make_synth_regression, normalize
from torch_helpers import np_, run_ranks, tt

TOL = 1e-3


def _binary_problem(n=160, d=6, seed=0):
    x, y = make_blobs(n // 2, 2, d, sep=2.5, seed=seed)
    return normalize(x), y


def _regression_problem(n=120, seed=0):
    x, y = make_synth_regression(n, 5, noise=0.05, seed=seed)
    return normalize(x), y


# --------------------------------------------- independent f64 certificates
def _gram64(model, x):
    return np.asarray(JK.rbf_gram(jnp.asarray(x), jnp.asarray(x),
                                  gamma=model.kernel_params.gamma),
                      np.float64)


def _phibar(model, x):
    phi = np_(model._feature_map.transform(tt(x))).astype(np.float64)
    return np.concatenate(
        [phi, np.full((len(x), 1), model.dcd_cfg.bias)], axis=1)


def _svc_violation(clf, x, y, lowrank=False):
    yy = np.where(np.asarray(y) == clf.classes_[1], 1.0, -1.0)
    a = clf.alpha_.astype(np.float64)
    if lowrank:
        pb = _phibar(clf, x)
        f = pb @ (pb.T @ (a * yy)) - yy
    else:
        f = _gram64(clf, x) @ (a * yy) - yy
    return float(tsmo.kkt_violation(clf.alpha_, yy, f, 0.0, clf.smo_cfg.C,
                                    r=0.0 if lowrank else None))


def _svr_violation(reg, x, y, lowrank=False):
    n = len(y)
    beta = reg.beta_.astype(np.float64)
    if lowrank:
        pb = _phibar(reg, x)
        g = pb @ (pb.T @ beta)
    else:
        g = _gram64(reg, x) @ beta
    y64 = np.asarray(y, np.float64)
    f = np.concatenate([g + reg.epsilon - y64, g - reg.epsilon - y64])
    s = np.concatenate([np.ones(n), -np.ones(n)])
    return float(tsmo.kkt_violation(reg.alpha_raw_, s, f, 0.0, reg.smo_cfg.C,
                                    r=0.0 if lowrank else None))


def _fit(kind, lowrank, **kw):
    """(model, x, y) of one cascade variant (or the plain fit)."""
    extra = (dict(engine="nystrom" if kind == "svc" else "rff", rank=48,
                  seed=3) if lowrank else {})
    if kind == "svc":
        x, y = _binary_problem()
        return TSVC(gamma=0.5, device="cpu", **extra, **kw).fit(x, y), x, y
    x, y = _regression_problem()
    return TSVR(gamma=0.5, device="cpu", **extra, **kw).fit(x, y), x, y


# ------------------------------------------------------- host numpy pieces
def test_host_pieces_equal_the_reference():
    for n, s in ((11, 4), (3, 8), (240, 1), (97, 5)):
        for a, b in zip(tcascade.partition_indices(n, s),
                        jcascade.partition_indices(n, s)):
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(0)
    for y, v in ((np.where(rng.random(50) > 0.5, 1.0, -1.0),
                  rng.uniform(0.0, 1.0, 50)),
                 (np.ones(30), rng.normal(size=30)),
                 (np.r_[1.0, -1.0, np.ones(8)], np.r_[0.5, 0.5, np.zeros(8)])):
        np.testing.assert_array_equal(tcascade._repair_equality(v, y),
                                      jcascade._repair_equality(v, y))
    yy = np.where(rng.random(40) > 0.5, 1.0, -1.0).astype(np.float32)

    class Adapter:   # the SVC adapters' is_sv / repair, over yy
        thr = 1e-8

        def is_sv(self, a):
            return a > self.thr

        def repair(self, idx, v):
            return tcascade._repair_equality(v, yy[idx])

    for seed in range(3):
        r = np.random.default_rng(seed)
        kids = []
        for lo in (0, 13):
            idx = np.sort(r.choice(40, 20, replace=False)) if seed else \
                np.arange(lo, lo + 20)
            a = np.where(r.random(20) > 0.5, r.random(20), 0.0)
            kids.append((idx, a.astype(np.float32)))
        tk = [tcascade._NodeFit(idx=i, alpha=a, b=0.0, n_iter=0,
                                converged=True) for i, a in kids]
        jk = [jcascade._NodeFit(idx=i, alpha=a, b=0.0, n_iter=0,
                                converged=True) for i, a in kids]
        got = tcascade._merge(*tk, Adapter())
        want = jcascade._merge(*jk, Adapter())
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


# ------------------------------------------------- single-shard bit-identity
@pytest.mark.parametrize("kind,lowrank", [("svc", False), ("svr", False),
                                          ("svc", True), ("svr", True)])
def test_single_shard_is_the_unsharded_fit(kind, lowrank):
    plain, _, _ = _fit(kind, lowrank)
    casc, _, _ = _fit(kind, lowrank, shard="cascade", cascade_shards=1)
    assert casc.cascade_rounds_ == 1 and casc.converged_
    assert casc.b_ == plain.b_
    names = ("alpha_",) if kind == "svc" else ("beta_", "alpha_raw_")
    for name in names + (("w_",) if lowrank else ("dual_coef_",)):
        np.testing.assert_array_equal(getattr(casc, name),
                                      getattr(plain, name))


# ------------------------------------------------- certified sharded solves
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("kind,lowrank", [("svc", False), ("svr", False),
                                          ("svc", True), ("svr", True)])
def test_sharded_cascade_certifies(kind, lowrank, shards):
    model, x, y = _fit(kind, lowrank, tol=TOL, shard="cascade",
                       cascade_shards=shards)
    assert model.converged_, model.cascade_history_
    assert model.cascade_kkt_ <= TOL
    check = _svc_violation if kind == "svc" else _svr_violation
    assert check(model, x, y, lowrank) <= TOL


def test_cascade_labels_match_the_reference():
    """The exact SVC cascade (S = 2, the pallas engine's plain path)
    against the reference's cascade on the same inputs: both certify,
    labels equal."""
    x, y = _binary_problem()
    kw = dict(gamma=0.5, shard="cascade", cascade_shards=2)
    t = TSVC(engine="pallas", device="cpu", **kw).fit(x, y)
    j = JSVC(**kw).fit(x, y)
    assert t.cascade_kkt_ <= TOL and j.cascade_kkt_ <= TOL
    np.testing.assert_array_equal(t.predict(x), j.predict(x))


@pytest.mark.parametrize("engine", ["auto", "rff"])
def test_multiclass_cascade_certifies_every_task(engine):
    x, y = make_blobs(40, 3, 5, sep=2.5, seed=2)
    x = normalize(x)
    kw = dict(gamma=0.5, engine=engine, rank=48, device="cpu")
    ref = TSVC(**kw).fit(x, y)
    clf = TSVC(shard="cascade", cascade_shards=2, **kw).fit(x, y)
    assert clf.converged_ and (clf.cascade_kkt_ <= TOL).all()
    assert clf.cascade_rounds_.shape == (3,)   # one cascade per OvO pair
    assert clf.score(x, y) == pytest.approx(ref.score(x, y), abs=0.02)
    for t, task in enumerate(clf._taskset.tasks):   # recomputed here
        k = task.size
        if engine == "rff":
            a = clf._task_alpha[t].astype(np.float64)
            phi = np_(clf._feature_map.transform(tt(task.x)))
            pb = np.concatenate([phi, np.ones((k, 1))], 1).astype(np.float64)
            f = pb @ (pb.T @ (a * task.y)) - task.y
            viol = tsmo.kkt_violation(a, task.y, f, 0.0, 1.0, r=0.0)
        else:
            a = clf._fit.alpha[t, :k].astype(np.float64)
            f = _gram64(clf, task.x) @ (a * task.y) - task.y
            viol = tsmo.kkt_violation(a, task.y, f, 0.0, 1.0)
        assert float(viol) <= TOL


# -------------------------------------------------------------- determinism
@pytest.mark.parametrize("lowrank", [False, True])
def test_cascade_refit_is_bit_identical(lowrank):
    a, _, _ = _fit("svc", lowrank, shard="cascade", cascade_shards=4)
    b, _, _ = _fit("svc", lowrank, shard="cascade", cascade_shards=4)
    np.testing.assert_array_equal(a.alpha_, b.alpha_)
    assert a.b_ == b.b_ and a.cascade_kkt_ == b.cascade_kkt_
    assert a.cascade_history_ == b.cascade_history_


@pytest.mark.parametrize("kind", ["svc", "svr"])
def test_lowrank_level_equals_lone_solves(kind):
    """One cascade level's nodes, solved together over their rows of
    the shared Phi, each equal to its lone solve bit for bit, warm
    starts included."""
    x, y = (_binary_problem() if kind == "svc" else _regression_problem())
    phi = torch.from_numpy(np.random.default_rng(1).normal(
        size=(len(x), 24)).astype(np.float32))
    yy = (np.where(y == y.max(), 1.0, -1.0) if kind == "svc"
          else y).astype(np.float32)
    cfg = tlinear.DCDConfig(C=1.0, max_epochs=60)
    parts = tcascade.partition_indices(len(x), 3)
    starts = [None, np.full(len(parts[1]), 0.25, np.float32), None]
    adapter = (tcascade._DCDSVCAdapter(phi, yy, dcd_cfg=cfg) if kind == "svc"
               else tcascade._DCDSVRAdapter(phi, yy, epsilon=0.1,
                                            dcd_cfg=cfg))
    level = adapter.solve_level(list(zip(parts, starts)))
    for node, idx, a0 in zip(level, parts, starts):
        lone = adapter.solve_level([(idx, a0)])[0]
        for name in ("alpha", "w", "raw"):
            if getattr(lone, name) is not None:
                np.testing.assert_array_equal(getattr(node, name),
                                              getattr(lone, name))
        assert node.b == lone.b and node.n_iter == lone.n_iter


# ----------------------------------------------------------------- serving
@pytest.mark.parametrize("kind", ["svc", "svr", "ovo"])
def test_cascade_packs_serve_across_packages(tmp_path, kind):
    """A cascade fit packs, serves through the Predictor as its engine
    path does, and its pack loads in the reference (and the reverse)."""
    kw = dict(gamma=0.5, shard="cascade", cascade_shards=2)
    if kind == "svr":
        x, y = _regression_problem()
        t, j = TSVR(device="cpu", **kw).fit(x, y), JSVR(**kw).fit(x, y)
        engine_values = t._predict_engine(x)
    else:
        x, y = (_binary_problem() if kind == "svc"
                else make_blobs(30, 3, 5, sep=2.5, seed=4))
        x = normalize(x)
        t, j = TSVC(device="cpu", **kw).fit(x, y), JSVC(**kw).fit(x, y)
        engine_values = t._decision_function_engine(x)
    tol = dict(rtol=2e-4, atol=2e-5)
    mine = tserve.Predictor(tserve.pack(t), device="cpu")
    np.testing.assert_allclose(mine.decision_function(x), engine_values,
                               **tol)
    tserve.save(tmp_path / "port.npz", tserve.pack(t))
    jserve.save(tmp_path / "ref.npz", jserve.pack(j))
    back = jserve.Predictor(jserve.load(tmp_path / "port.npz"))
    got = tserve.Predictor(tserve.load(tmp_path / "ref.npz"), device="cpu")
    want = jserve.Predictor(jserve.load(tmp_path / "ref.npz"))
    np.testing.assert_allclose(back.decision_function(x),
                               mine.decision_function(x), **tol)
    np.testing.assert_allclose(got.decision_function(x),
                               want.decision_function(x), **tol)
    if kind != "svr":
        np.testing.assert_array_equal(got.predict(x), want.predict(x))


# ------------------------------------------------------------- validation
def test_cascade_validation_matches_the_reference():
    """The reference's errors (tests/test_cascade.py), and on a mesh the
    reference's worker-axis check (``dist.resolve_worker_count``): a
    level's nodes go to ``fit_taskset`` over ``worker_axes``, which the
    mesh's "shards" axis does not name."""
    x, y = _binary_problem(n=60)
    for make, fit in (
            (lambda: TSVC(solver="gd", shard="cascade", device="cpu"),
             lambda m: m.fit(x, y)),
            (lambda: JSVC(solver="gd", shard="cascade"),
             lambda m: m.fit(x, y))):
        with pytest.raises(ValueError, match="solver='smo'"):
            fit(make())
    with pytest.raises(ValueError, match="cascade_shards"):
        TSVC(shard="cascade", cascade_shards=0, device="cpu").fit(x, y)
    with pytest.raises(ValueError, match="cascade_rounds"):
        TSVR(shard="cascade", cascade_rounds=0,
             device="cpu").fit(x, y.astype(float))
    with pytest.raises(ValueError, match="shard mode"):
        TSVC(shard="waterfall", device="cpu")
    for call in (lambda m: tcascade.cascade_binary(x, y, mesh=m),
                 lambda m: tcascade.cascade_svr(x, y, mesh=m),
                 lambda m: TSVC(shard="cascade", mesh=m,
                                device="cpu").fit(x, y)):
        with pytest.raises(ValueError, match="worker axes"):
            run_ranks(call, 2)
