"""The port's ``SVC`` and serving path against the JAX reference.

* ``SVC`` end to end on the paper's pipeline data (iris binary subset,
  breast-cancer-like, a Pavia-like pair): both fits certify, held-out
  labels equal; where the SMO trajectories coincide, alphas, b and
  decision values agree closely. Decision values are never compared
  bitwise (the packages sum Gram products in other orders; ROADMAP C.1).
* ``.npz`` artifacts (schema v1, and v2 for low-rank fits) written by
  either package load and serve in the other, with equal labels —
  binary, SVR and multiclass (``svc/ovo``, ``svc/ovr``, vote and margin
  decode, multiclass low-rank) packs; a reference artifact read and
  written again by the port is array for array the same.
* The ``Predictor``: pow2 batch ladder, ``max_batch`` rounding,
  ``n_programs`` ledger, ``warmup`` accounting, thread safety.

The port runs on the CPU here (``device="cpu"``), so its kernels run
their plain versions; ``chip_smoke.py`` holds the kernels themselves.
"""
import threading

import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.core.svm import SVC as JSVC
from repro_torch import serve as tserve
from repro_torch.core import kernels as TK
from repro_torch.core import smo as tsmo
from repro_torch.core.svm import SVC as TSVC
from repro_torch.data import (load_breast_cancer_like, load_iris,
                              load_pavia_like, normalize, train_test_split)

DF_TOL = dict(rtol=2e-4, atol=1e-4)


def _dataset(kind):
    if kind == "iris":  # the overlapping pair: versicolor vs virginica
        x, y = load_iris()
        keep = y > 0
        x, y = x[keep], y[keep]
    elif kind == "breast":
        x, y = load_breast_cancer_like(n_samples=300)
    else:
        x, y = load_pavia_like(n_per_class=120, n_classes=2, seed=7)
    return train_test_split(normalize(x), y, test_frac=0.25, seed=0)


def _certificate(x, y, clf):
    """float64 KKT certificate of a fit, from a gradient recomputed with
    the port's plain Gram (independent of either solver's bookkeeping)."""
    yy = np.where(y == clf.classes_[1], 1.0, -1.0)
    gram = TK.make_gram_fn(TK.KernelParams(gamma=clf.kernel_params.gamma))(
        torch.from_numpy(x), torch.from_numpy(x)).double().numpy()
    f = gram @ (clf.alpha_ * yy) - yy
    return float(tsmo.kkt_violation(clf.alpha_, yy, f, 0.0, 1.0))


CASES = [("iris", "dense"), ("breast", "pallas"), ("pavia", "pallas"),
         ("pavia", "chunked")]


def _fit_both(kind, engine):
    xtr, ytr, xte, yte = _dataset(kind)
    kw = dict(C=1.0, shrink_every=4 if engine != "dense" else 0)
    j = JSVC(engine="dense" if engine == "dense" else "chunked", **kw)
    t = TSVC(engine=engine, device="cpu", **kw)
    return j.fit(xtr, ytr), t.fit(xtr, ytr), (xtr, ytr, xte, yte)


@pytest.mark.parametrize("kind,engine", CASES)
def test_svc_matches_reference_end_to_end(kind, engine):
    """Both fits certify at tol and serve the same labels. Each package
    computes its own Gram and its own "scale" gamma (a float32 variance
    summed in another order), so the two QPs differ in the last bits;
    SMO trajectories are chaotic (the NOTE in repro/core/smo.py), and on
    the overlapping iris pair that gives another pair sequence (n_iter
    63 vs 62, alphas ~1e-3 apart). Decision values are therefore held
    to 2 tol, the gap at which both solvers stop."""
    j, t, (xtr, ytr, xte, yte) = _fit_both(kind, engine)
    assert j.converged_ and t.converged_
    assert t.kernel_params.gamma == pytest.approx(j.kernel_params.gamma,
                                                  rel=1e-6)
    np.testing.assert_array_equal(t.classes_, j.classes_)
    for clf in (j, t):
        assert _certificate(xtr, ytr, clf) <= 1e-3
    np.testing.assert_array_equal(t.predict(xte), j.predict(xte))
    np.testing.assert_allclose(t.decision_function(xte),
                               j.decision_function(xte), rtol=0, atol=2e-3)
    np.testing.assert_allclose(t._decision_function_engine(xte),
                               t.decision_function(xte), **DF_TOL)
    assert t.score(xte, yte) == j.score(xte, yte)


@pytest.mark.parametrize("kind,engine", CASES[1:])
def test_svc_follows_the_reference_trajectory(kind, engine):
    """On the well-separated problems the last-bit differences do not
    change the pair sequence: same n_iter, same support set, alphas
    within 1e-4 C, b within 1e-4, decision values at the kernel bound."""
    j, t, (_, _, xte, _) = _fit_both(kind, engine)
    assert t.n_iter_ == j.n_iter_
    np.testing.assert_array_equal(t.support_, j.support_)
    np.testing.assert_allclose(t.alpha_, j.alpha_, atol=1e-4)
    assert t.b_ == pytest.approx(j.b_, abs=1e-4)
    np.testing.assert_allclose(t.decision_function(xte),
                               j.decision_function(xte), **DF_TOL)


def test_svc_orientation_threshold_and_refit():
    xtr, ytr, xte, _ = _dataset("breast")
    t = TSVC(device="cpu", C=1e-9).fit(xtr, ytr)
    # tiny C: every multiplier is ~C, and the relative threshold keeps
    # them (an absolute 1e-8 cutoff would collapse to a constant model)
    assert t.n_support_ > 0
    clf = TSVC(device="cpu").fit(xtr, ytr)
    df = clf.decision_function(xte)
    np.testing.assert_array_equal(
        clf.predict(xte), np.where(df > 0, clf.classes_[1], clf.classes_[0]))
    gamma0 = clf.kernel_params.gamma
    clf.fit(xtr * 3.0, ytr)      # gamma "scale" re-resolved on refit
    assert clf.kernel_params.gamma == pytest.approx(gamma0 / 9.0, rel=1e-4)
    with pytest.raises(ValueError, match=">= 2 classes"):
        TSVC(device="cpu").fit(xtr, np.zeros(len(ytr)))


def _jax_fit(kind="breast"):
    xtr, ytr, xte, _ = _dataset(kind)
    return JSVC(engine="chunked").fit(xtr, ytr), xte


def test_reference_artifact_serves_in_port(tmp_path):
    j, xte = _jax_fit()
    path = tmp_path / "ref.npz"
    jserve.save(path, jserve.pack(j))
    packed = tserve.load(path)
    assert packed.n_support == j.n_support_
    want = jserve.Predictor(jserve.load(path), engine="chunked")
    for engine in ("pallas", "chunked"):
        pred = tserve.Predictor(packed, engine=engine, device="cpu")
        np.testing.assert_array_equal(pred.predict(xte), want.predict(xte))
        np.testing.assert_allclose(pred.decision_function(xte),
                                   want.decision_function(xte), **DF_TOL)


def test_port_artifact_serves_in_reference(tmp_path):
    xtr, ytr, xte, _ = _dataset("pavia")
    t = TSVC(engine="pallas", device="cpu").fit(xtr, ytr)
    path = tmp_path / "port.npz"
    tserve.save(path, tserve.pack(t))
    jpacked = jserve.load(path)
    assert jpacked.n_support == t.n_support_
    assert jpacked.kernel.gamma == t.kernel_params.gamma
    want = tserve.Predictor(tserve.pack(t), engine="pallas", device="cpu")
    got = jserve.Predictor(jpacked, engine="chunked")
    np.testing.assert_array_equal(got.predict(xte), want.predict(xte))
    np.testing.assert_allclose(got.decision_function(xte),
                               want.decision_function(xte), **DF_TOL)
    # and back again: the port reads its own file to the same arrays
    again = tserve.load(path)
    for a, b in zip(again.buckets[0], tserve.pack(t).buckets[0]):
        np.testing.assert_array_equal(a, b)


def test_from_numpy_builds_the_binary_pack():
    rng = np.random.default_rng(0)
    sv = rng.normal(size=(5, 3)).astype(np.float32)
    coef = rng.normal(size=5).astype(np.float32)
    p = tserve.PackedModel.from_numpy(kernel={"name": "rbf", "gamma": 0.5},
                                      sv_x=sv, sv_coef=coef, b=0.25,
                                      classes=np.array([3, 7]))
    assert (p.n_tasks, p.n_features, p.n_support) == (1, 3, 5)
    np.testing.assert_array_equal(p.pairs, [[1, 0]])
    z = rng.normal(size=(4, 3)).astype(np.float32)
    pred = tserve.Predictor(p, device="cpu")
    k = np.exp(-0.5 * ((z[:, None] - sv[None]) ** 2).sum(-1))
    np.testing.assert_allclose(pred.decision_function(z), k @ coef + 0.25,
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        tserve.PackedModel.from_numpy(kernel={}, sv_x=sv, sv_coef=coef[:3],
                                      b=0.0, classes=np.array([0, 1]))


def test_unported_artifacts_raise(tmp_path):
    j, _ = _jax_fit()
    path = tmp_path / "ref.npz"
    jserve.save(path, jserve.pack(j))
    with np.load(path) as z:
        arrays = dict(z)
    import json
    # what the reference's load refuses, the port refuses with its error:
    # an unknown bank dtype, a schema version past v3, an unknown kind
    for change, match in (
            ({"version": 3, "sv_dtype": "int8"}, "unsupported sv_dtype"),
            ({"version": 4}, "unsupported repro.svm-pack version 4"),
            ({"strategy": "cascade"}, "unknown pack kind/strategy"),
            ({"kind": "svr", "strategy": "ovo"},
             "unknown pack kind/strategy")):
        meta = json.loads(str(arrays["meta"]))
        meta.update(change)
        bad = tmp_path / "bad.npz"
        np.savez(bad, **{**arrays, "meta": np.array(json.dumps(meta))})
        if "sv_dtype" in change or "version" in change:
            with pytest.raises(ValueError, match=match):
                jserve.load(bad)
        with pytest.raises(ValueError, match=match):
            tserve.load(bad)
    meta = json.loads(str(arrays["meta"]))
    meta["schema"] = "something.else"
    np.savez(tmp_path / "bad2.npz",
             **{**arrays, "meta": np.array(json.dumps(meta))})
    with pytest.raises(ValueError, match="not a repro.svm-pack"):
        tserve.load(tmp_path / "bad2.npz")


@pytest.mark.parametrize("engine", ["pallas", "chunked"])
def test_predictor_ladder_programs_and_warmup(engine):
    xtr, ytr, xte, _ = _dataset("breast")
    t = TSVC(device="cpu").fit(xtr, ytr)
    packed = tserve.pack(t)
    pred = tserve.Predictor(packed, engine=engine, max_batch=100,
                            device="cpu")
    assert pred.max_batch == 64           # rounded DOWN onto the ladder
    assert [pred._batch_bucket(n) for n in (1, 2, 3, 37, 64, 65, 500)] == \
        [1, 2, 4, 64, 64, 64, 64]
    pred.warmup((1, 37))
    assert pred.n_requests == 0           # warmup rows are not counted
    assert pred.n_programs == 2           # buckets 1 and 64
    full = tserve.Predictor(packed, engine=engine, max_batch=1024,
                            device="cpu").decision_function(xte)
    for n in (3, 37, len(xte)):           # sliced + padded requests
        np.testing.assert_allclose(pred.decision_function(xte[:n]),
                                   full[:n], rtol=1e-6, atol=1e-6)
    assert pred.n_requests == 3 + 37 + len(xte)
    assert len(xte) % 64 == 11            # 75 rows: slices of 64 and 11
    assert pred.n_programs == 4           # + buckets 4 and 16
    with pytest.raises(ValueError):
        tserve.Predictor(packed, max_batch=0, device="cpu")
    with pytest.raises(ValueError, match="request batch"):
        pred.predict(xte[:, :3])
    assert pred.decode(np.array([[0.5, -0.5]]), "values").shape == (1, 2)
    with pytest.raises(ValueError, match="decode op"):
        pred.decode(np.zeros((1, 2)), "nope")


def test_predictor_counters_under_concurrency():
    xtr, ytr, xte, _ = _dataset("iris")
    pred = TSVC(device="cpu").fit(xtr, ytr).predictor()
    want = pred.decision_function(xte)
    errors = []

    def worker():
        try:
            for n in (1, 5, len(xte)):
                np.testing.assert_allclose(pred.decision_function(xte[:n]),
                                           want[:n], rtol=1e-6, atol=1e-6)
        except AssertionError as e:  # reported below, on the main thread
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(12)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads) and not errors
    assert pred.n_requests == len(xte) * 13 + 12 * 6


# ------------------------------------- SVR and low-rank (schema v2) packs
DECISION_TOL = dict(rtol=2e-4, atol=2e-5)   # tests/test_kernels_pallas.py


def _regression():
    from repro_torch.data import make_synth_regression
    x, y = make_synth_regression(260, 4, kind="sinc", noise=0.05, seed=8)
    return x[:200], y[:200], x[200:]


def _fit_pair(kind, engine):
    """(reference model, port model, held-out rows) of one kind."""
    from repro.core.svm import SVR as JSVR
    from repro_torch.core.svm import SVR as TSVR
    kw = dict(engine=engine, rank=48) if engine in ("rff", "nystrom") \
        else dict(engine=engine)
    if kind == "svr":
        xtr, ytr, xte = _regression()
        j = JSVR(epsilon=0.1, **kw).fit(xtr, ytr)
        t = TSVR(epsilon=0.1, device="cpu", **kw).fit(xtr, ytr)
    else:
        xtr, ytr, xte, _ = _dataset("pavia")
        j = JSVC(**kw).fit(xtr, ytr)
        t = TSVC(device="cpu", **kw).fit(xtr, ytr)
    return j, t, xte


PACKS = [("svc", "rff"), ("svc", "nystrom"), ("svr", "dense"),
         ("svr", "rff"), ("svr", "nystrom")]


@pytest.mark.parametrize("kind,engine", PACKS)
def test_reference_svr_and_lowrank_artifacts_serve_in_port(tmp_path, kind,
                                                           engine):
    j, _, xte = _fit_pair(kind, engine)
    path = tmp_path / "ref.npz"
    jserve.save(path, jserve.pack(j))
    packed = tserve.load(path)
    assert packed.kind == kind
    assert (packed.feature_map is not None) == (engine != "dense")
    want = jserve.Predictor(jserve.load(path))
    got = tserve.Predictor(packed, device="cpu")
    np.testing.assert_allclose(got.decision_function(xte),
                               want.decision_function(xte), **DECISION_TOL)
    if kind == "svc":
        np.testing.assert_array_equal(got.predict(xte), want.predict(xte))
    else:   # an SVR's predict is its decision values
        np.testing.assert_array_equal(got.predict(xte),
                                      got.decision_function(xte))


@pytest.mark.parametrize("kind,engine", PACKS)
def test_port_svr_and_lowrank_artifacts_serve_in_reference(tmp_path, kind,
                                                           engine):
    import json
    _, t, xte = _fit_pair(kind, engine)
    path = tmp_path / "port.npz"
    tserve.save(path, tserve.pack(t))
    with np.load(path) as z:
        meta = json.loads(str(z["meta"]))
    lowrank = engine != "dense"
    assert meta["version"] == (2 if lowrank else 1)
    assert meta.get("feature_map") == (engine if lowrank else None)
    jpacked = jserve.load(path)
    want = tserve.Predictor(tserve.pack(t), device="cpu")
    got = jserve.Predictor(jpacked)
    np.testing.assert_allclose(got.decision_function(xte),
                               want.decision_function(xte), **DECISION_TOL)
    np.testing.assert_allclose(want.decision_function(xte),
                               (t._predict_engine(xte) if kind == "svr"
                                else t._decision_function_engine(xte)),
                               **DECISION_TOL)
    if kind == "svc":
        np.testing.assert_array_equal(got.predict(xte), want.predict(xte))
    again = tserve.load(path)
    if lowrank:
        np.testing.assert_array_equal(again.linear_w, t.w_[None])
        np.testing.assert_array_equal(
            again.feature_map.a, t._feature_map.arrays[0].cpu().numpy())
    else:
        np.testing.assert_array_equal(again.buckets[0].sv_coef[0],
                                      t.dual_coef_)


def test_lowrank_predictor_ladder_and_ledger():
    xtr, ytr, xte, _ = _dataset("breast")
    t = TSVC(engine="rff", rank=32, device="cpu").fit(xtr, ytr)
    pred = tserve.Predictor(tserve.pack(t), max_batch=100, device="cpu")
    assert pred.max_batch == 64
    pred.warmup((1, 37))
    assert pred.n_requests == 0 and pred.n_programs == 2
    full = t._decision_function_engine(xte)
    for n in (3, 37, len(xte)):
        np.testing.assert_allclose(pred.decision_function(xte[:n]),
                                   full[:n], rtol=1e-5, atol=1e-5)
    assert pred.n_programs == 4           # buckets 1, 64, 4, 16
    assert ("lowrank", 64) in pred._program_sigs


def test_lowrank_pack_validation():
    kp = TK.KernelParams(gamma=0.5)
    fm = tserve.LowRankMap(kind="rff", a=np.zeros((3, 4), np.float32),
                           b=np.zeros((4,), np.float32))
    with pytest.raises(ValueError, match="linear_w"):
        tserve.PackedModel(kind="svc", kernel=kp, n_features=3, n_tasks=1,
                           buckets=(), feature_map=fm)
    with pytest.raises(ValueError, match="stack all"):
        tserve.PackedModel(kind="svr", kernel=kp, n_features=3, n_tasks=1,
                           buckets=(), strategy="svr", feature_map=fm,
                           linear_w=np.zeros((2, 4), np.float32),
                           linear_b=np.zeros((1,), np.float32))
    with pytest.raises(ValueError, match="classes"):
        tserve.PackedModel(kind="svc", kernel=kp, n_features=3, n_tasks=3,
                           buckets=(), strategy="ovo", feature_map=fm)
    ok = tserve.PackedModel(kind="svr", kernel=kp, n_features=3, n_tasks=1,
                            buckets=(), strategy="svr", feature_map=fm,
                            linear_w=np.ones((1, 4), np.float32),
                            linear_b=np.array([0.5], np.float32))
    pred = tserve.Predictor(ok, device="cpu")
    # phase 0, omega 0: every feature is sqrt(2/4) cos(0)
    np.testing.assert_allclose(pred.predict(np.zeros((2, 3), np.float32)),
                               [4 * np.sqrt(0.5) + 0.5] * 2, rtol=1e-6)


# ------------------------------------------------------ multiclass packs
MC_PACKS = [("ovo", "vote", "chunked"), ("ovo", "margin", "pallas"),
            ("ovr", "vote", "pallas"), ("ovo", "vote", "rff"),
            ("ovr", "vote", "nystrom")]


def _multiclass_pair(strategy, decision, engine):
    """(reference model, port model, held-out rows): Pavia-like 9-class
    for the exact engines, iris for the low-rank ones."""
    lowrank = engine in ("rff", "nystrom")
    if lowrank:
        x, y = load_iris()
    else:
        x, y = load_pavia_like(n_per_class=30, n_classes=9, seed=7)
    xtr, ytr, xte, _ = train_test_split(normalize(x), y, test_frac=0.25,
                                        seed=0)
    kw = dict(strategy=strategy, decision=decision, rank=24)
    j = JSVC(engine="chunked" if engine == "pallas" else engine,
             **kw).fit(xtr, ytr)
    t = TSVC(engine=engine, device="cpu", **kw).fit(xtr, ytr)
    return j, t, xte


@pytest.mark.parametrize("strategy,decision,engine", MC_PACKS)
def test_reference_multiclass_artifacts_serve_in_port(tmp_path, strategy,
                                                      decision, engine):
    import json
    j, _, xte = _multiclass_pair(strategy, decision, engine)
    path = tmp_path / "ref.npz"
    jserve.save(path, jserve.pack(j))
    packed = tserve.load(path)
    assert (packed.strategy, packed.decision) == (strategy, decision)
    assert packed.n_tasks == j._taskset.n_tasks
    want = jserve.Predictor(jserve.load(path))
    got = tserve.Predictor(packed, engine="pallas" if engine == "pallas"
                           else "auto", device="cpu")
    np.testing.assert_array_equal(got.predict(xte), want.predict(xte))
    np.testing.assert_allclose(got.decision_function(xte),
                               want.decision_function(xte), **DECISION_TOL)
    # read and written again by the port: the same arrays and meta
    again = tmp_path / "again.npz"
    tserve.save(again, packed)
    with np.load(path) as a, np.load(again) as b:
        assert sorted(a.files) == sorted(b.files)
        assert json.loads(str(a["meta"])) == json.loads(str(b["meta"]))
        for name in a.files:
            np.testing.assert_array_equal(a[name], b[name])


@pytest.mark.parametrize("strategy,decision,engine", MC_PACKS)
def test_port_multiclass_artifacts_serve_in_reference(tmp_path, strategy,
                                                      decision, engine):
    import json
    _, t, xte = _multiclass_pair(strategy, decision, engine)
    path = tmp_path / "port.npz"
    tserve.save(path, tserve.pack(t))
    with np.load(path) as z:
        meta = json.loads(str(z["meta"]))
    lowrank = engine in ("rff", "nystrom")
    assert meta["version"] == (2 if lowrank else 1)
    assert (meta["strategy"], meta["decision"]) == (strategy, decision)
    jpacked = jserve.load(path)
    assert jpacked.n_tasks == t._taskset.n_tasks
    if lowrank:
        np.testing.assert_array_equal(jpacked.linear_w, t.task_w_)
    else:
        assert len(jpacked.buckets) == len(t._serving_buckets)
    want = tserve.Predictor(tserve.pack(t), device="cpu")
    got = jserve.Predictor(jpacked)
    np.testing.assert_array_equal(got.predict(xte), want.predict(xte))
    np.testing.assert_array_equal(want.predict(xte), t.predict(xte))
    np.testing.assert_allclose(got.decision_function(xte),
                               want.decision_function(xte), **DECISION_TOL)
    np.testing.assert_allclose(want.decision_function(xte),
                               t._decision_function_engine(xte),
                               **DECISION_TOL)


def test_multiclass_predictor_ladder_and_decode():
    xtr, ytr, xte, _ = train_test_split(
        normalize(load_pavia_like(n_per_class=30, n_classes=9, seed=7)[0]),
        load_pavia_like(n_per_class=30, n_classes=9, seed=7)[1],
        test_frac=0.25, seed=0)
    t = TSVC(engine="pallas", device="cpu").fit(xtr, ytr)
    packed = tserve.pack(t)
    assert packed.strategy == "ovo" and packed.n_tasks == 36
    assert sum(len(g.task_ids) for g in packed.buckets) == 36
    assert max(g.sv_x.shape[0] for g in packed.buckets) > 1   # T > 1 banks
    pred = tserve.Predictor(packed, engine="pallas", max_batch=32,
                            device="cpu").warmup((1, 5))
    assert pred.n_requests == 0
    full = pred.predict(xte)
    for n in (1, 3, 17, 33):
        np.testing.assert_array_equal(pred.predict(xte[:n]), full[:n])
    df = pred.decision_values(xte[:7])
    np.testing.assert_array_equal(pred.decode(df, "values"), df)
    assert pred.decode(df, "decision_function").shape == (36, 7)
    np.testing.assert_array_equal(pred.decode(df), full[:7])
    with pytest.raises(ValueError, match="unknown decode op"):
        pred.decode(df, "proba")
