"""The port's multiclass layer against the JAX reference.

* Task sets (OvO / OvR, with the routing ``pairs`` and ``indices``),
  the size-bucketed LPT schedule with its ``schedule_stats``, and the
  vote / margin / OvR-argmax decode equal the reference's exactly.
* One batched SMO per bucket (``smo.solve_qp_tasks``): on a shared
  per-task Gram each task of a bucket equals its lone ``binary_smo`` bit
  for bit, and the reference's vmapped solve of the same bucket in
  n_iter (alphas within 1e-5 C). On each package's own Gram the SMO
  trajectories may part at a one-ulp difference (the NOTE in
  ``repro/core/smo.py::_smo_iteration``), so ``fit_taskset`` and the
  paper pipeline are held on certified optima: labels equal, decision
  values within 2 tol.
* Bucketed and padded schedules predict alike; the multiclass low-rank
  fit on a map carried across from the reference matches it.

Inputs are made with numpy and handed to both packages; the port runs
on the CPU (``device="cpu"``), its kernels as their plain versions.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import dist as jdist
from repro.core import kernel_engine as JKE
from repro.core import kernels as JK
from repro.core import multiclass as JMC
from repro.core import ovo as jovo
from repro.core import smo as jsmo
from repro.core.svm import SVC as JSVC
from repro.data import make_imbalanced_blobs
from repro_torch.core import approx as tapprox
from repro_torch.core import dist as tdist
from repro_torch.core import kernel_engine as TKE
from repro_torch.core import kernels as TK
from repro_torch.core import multiclass as TMC
from repro_torch.core import ovo as tovo
from repro_torch.core import smo as tsmo
from repro_torch.core import svm as tsvm
from repro_torch.core.svm import SVC as TSVC
from repro_torch.data import (load_iris, load_pavia_like, normalize,
                              train_test_split)
from torch_helpers import np_, tt

IMBALANCED_SIZES = (64, 48, 24, 12, 7)   # tests/test_multiclass.py


def _problem(kind):
    if kind == "imbalanced":
        x, y = make_imbalanced_blobs(IMBALANCED_SIZES, 10, sep=4.0, seed=0)
    elif kind == "iris":
        x, y = load_iris()
    else:
        x, y = load_pavia_like(30)
    return normalize(np.asarray(x, np.float32)), y


# ------------------------------------------------------------- task sets
@pytest.mark.parametrize("kind", ["imbalanced", "iris", "pavia"])
@pytest.mark.parametrize("strategy", ["ovo", "ovr"])
def test_tasksets_match_reference(kind, strategy):
    x, y = _problem(kind)
    j = JMC.get_strategy(strategy).build_taskset(x, y)
    t = TMC.get_strategy(strategy).build_taskset(x, y)
    assert t.strategy == j.strategy == strategy
    np.testing.assert_array_equal(t.classes, j.classes)
    np.testing.assert_array_equal(t.pairs, j.pairs)
    np.testing.assert_array_equal(t.sizes, j.sizes)
    for a, b in zip(t.tasks, j.tasks):
        for field in ("x", "y", "indices"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field))
        assert (a.pos, a.neg) == (b.pos, b.neg)
        np.testing.assert_array_equal(a.x, x[a.indices])


def test_strategy_errors_match_reference():
    with pytest.raises(ValueError, match="unknown multiclass"):
        TMC.get_strategy("ova")
    with pytest.raises(ValueError, match="at least 2 classes"):
        TMC.get_strategy("ovo").build_taskset(np.zeros((3, 2)), np.ones(3))
    s = TMC.OneVsRestStrategy()
    assert TMC.get_strategy(s) is s


# -------------------------------------------------------------- schedule
SCHEDULE_CASES = [
    ([300, 40, 37, 150, 8, 8, 8], dict(n_workers=2)),
    ([16, 16, 16], dict()),
    ([10, 20, 30], dict(bucket_by="none")),
    ([10, 20, 30], dict(bucket_by="none", pad_width=64, n_workers=2)),
    ([256, 256, 256, 256, 16, 16, 16, 16], dict(n_workers=2, min_width=16)),
    ([5, 900, 33, 64, 65, 1, 128, 129, 7, 7], dict(n_workers=3,
                                                    min_width=8)),
    ([3], dict(n_workers=4)),
]


@pytest.mark.parametrize("sizes,cfg", SCHEDULE_CASES)
def test_schedule_and_stats_match_reference(sizes, cfg):
    j = JMC.build_schedule(sizes, JMC.ScheduleConfig(**cfg))
    t = TMC.build_schedule(sizes, TMC.ScheduleConfig(**cfg))
    assert t.n_workers == j.n_workers
    assert [b.width for b in t.buckets] == [b.width for b in j.buckets]
    for a, b in zip(t.buckets, j.buckets):
        np.testing.assert_array_equal(a.task_ids, b.task_ids)
        assert a.n_slots == b.n_slots
    assert TMC.schedule_stats(sizes, t) == JMC.schedule_stats(sizes, j)


def test_schedule_of_imbalanced_ovo_and_errors_match_reference():
    x, y = _problem("imbalanced")
    sizes = TMC.get_strategy("ovo").build_taskset(x, y).sizes
    for cfg in (dict(), dict(bucket_by="none"), dict(n_workers=4)):
        assert (TMC.schedule_stats(sizes, TMC.build_schedule(
            sizes, TMC.ScheduleConfig(**cfg)))
            == JMC.schedule_stats(sizes, JMC.build_schedule(
                sizes, JMC.ScheduleConfig(**cfg))))
    for bad in (dict(bucket_by="none", pad_width=10), dict(bucket_by="x")):
        with pytest.raises(ValueError):
            TMC.build_schedule([5, 20], TMC.ScheduleConfig(**bad))
    with pytest.raises(ValueError, match="non-empty"):
        TMC.build_schedule([])
    for size in (1, 7, 32, 33, 1000):
        cfg = TMC.ScheduleConfig(min_width=8)
        assert TMC.bucket_width(size, cfg) == JMC.bucket_width(
            size, JMC.ScheduleConfig(min_width=8))
        assert TMC.task_cost(size) == JMC.task_cost(size)


# ---------------------------------------------------------------- decode
def _decisions(rng, c, t):
    df = rng.normal(size=(c, t)).astype(np.float32)
    df[:, :t // 4] = 0.0            # exact zeros: vote ties, no margins
    return df


def _ambiguous(df, pairs, m, decision):
    """Columns whose decision rests on a float tie: the leading classes'
    scores (tanh-margin sums among the top vote count, or summed
    margins) within 1e-6 of each other, computed in float64. There the
    answer depends on the last ulp of tanh and on the summation order,
    which differ between XLA and PyTorch."""
    pos = np.zeros((len(pairs), m))
    neg = np.zeros((len(pairs), m))
    for c, (a, b) in enumerate(pairs):
        pos[c, a] = 1.0
        if b >= 0:
            neg[c, b] = 1.0
    th = np.tanh(df.astype(np.float64))
    score = th.T @ (pos - neg)
    if decision == "vote":
        votes = (df > 0).T @ pos + (df <= 0).T @ neg
        score = np.where(votes >= votes.max(1, keepdims=True) - 0.5, score,
                         -np.inf)
    top2 = np.sort(score, axis=1)[:, -2:]
    return np.abs(top2[:, 1] - top2[:, 0]) < 1e-6


@pytest.mark.parametrize("strategy,m", [("ovo", 3), ("ovo", 5), ("ovo", 9),
                                        ("ovr", 4), ("ovr", 9)])
@pytest.mark.parametrize("decision", ["vote", "margin"])
def test_decode_matches_reference(strategy, m, decision):
    y = np.repeat(np.arange(m), 3)
    x = np.random.default_rng(m).normal(size=(len(y), 2)).astype(np.float32)
    pairs = TMC.get_strategy(strategy).build_taskset(x, y).pairs
    df = _decisions(np.random.default_rng(m + 7), len(pairs), 400)
    got = TMC.decide_from_pairs(torch.from_numpy(df), pairs, m, strategy,
                                decision)
    want = JMC.decide_from_pairs(jnp.asarray(df), pairs, m, strategy,
                                 decision)
    np.testing.assert_array_equal(np_(got), np_(want))
    if strategy == "ovo":
        np.testing.assert_array_equal(
            np_(TMC.vote_decision(df, pairs, m)),
            np_(JMC.vote_decision(jnp.asarray(df), pairs, m)))
        np.testing.assert_array_equal(
            np_(TMC.margin_decision(df, pairs, m)),
            np_(JMC.margin_decision(jnp.asarray(df), pairs, m)))
    with pytest.raises(ValueError, match="unknown OvO decision"):
        TMC.decide_from_pairs(df, pairs, m, "ovo", "majority")


@pytest.mark.parametrize("m", [5, 9])
@pytest.mark.parametrize("decision", ["vote", "margin"])
def test_decode_of_rounded_ties_matches_reference(m, decision):
    """Decision values rounded to integers make exact vote ties whose
    tanh-margin sums are equal in exact arithmetic: the two packages
    agree on every column that is not such a float tie."""
    y = np.repeat(np.arange(m), 3)
    x = np.zeros((len(y), 2), np.float32)
    pairs = TMC.get_strategy("ovo").build_taskset(x, y).pairs
    df = np.round(np.random.default_rng(m).normal(
        size=(len(pairs), 400))).astype(np.float32)
    got = np_(TMC.decide_from_pairs(df, pairs, m, "ovo", decision))
    want = np_(JMC.decide_from_pairs(jnp.asarray(df), pairs, m, "ovo",
                                     decision))
    tie = _ambiguous(df, pairs, m, decision)
    np.testing.assert_array_equal(got[~tie], want[~tie])
    assert tie.mean() < 0.5


def test_vote_ties_go_to_the_lowest_class():
    # 3 classes, every pair undecided at 0: each class gets one vote and
    # no tie-break margin, so class 0 (LIBSVM order)
    pairs = np.array([[0, 1], [0, 2], [1, 2]])
    df = np.array([[1.0, 0.0], [-1.0, 0.0], [1.0, 0.0]], np.float32)
    got = np_(TMC.vote_decision(df, pairs, 3))
    np.testing.assert_array_equal(got, np_(JMC.vote_decision(
        jnp.asarray(df), pairs, 3)))
    assert got[1] == 2      # votes (0, 0, ..): all-negative -> neg classes


@pytest.mark.parametrize("pad", [None, 4])
def test_ovo_build_tasks_and_vote_match_reference(pad):
    x, y = _problem("iris")
    j = jovo.build_tasks(x, y, pad_tasks_to=pad)
    t = tovo.build_tasks(x, y, pad_tasks_to=pad)
    for field in j._fields:
        np.testing.assert_array_equal(getattr(t, field), getattr(j, field))
    assert tovo.n_binary_tasks(9) == jovo.n_binary_tasks(9) == 36
    df = _decisions(np.random.default_rng(1), t.x.shape[0], 50)
    np.testing.assert_array_equal(
        np_(tovo.vote(torch.from_numpy(df), t.pairs, t.classes, 3)),
        np_(jovo.vote(jnp.asarray(df), j.pairs, j.classes, 3)))


# ------------------------------------------------- one batched SMO / bucket
def _bucket(kind, strategy, cfg=None):
    x, y = _problem(kind)
    ts = TMC.get_strategy(strategy).build_taskset(x, y)
    sched = TMC.build_schedule(ts.sizes, cfg or TMC.ScheduleConfig())
    return x, ts, sched


def _shared_grams(xt, gamma):
    return np.stack([np_(JK.rbf_gram(jnp.asarray(a), jnp.asarray(a),
                                     gamma=gamma)) for a in xt])


@pytest.mark.parametrize("kind,strategy,selection", [
    ("imbalanced", "ovo", "first"), ("imbalanced", "ovr", "second"),
    ("iris", "ovo", "first"), ("pavia", "ovo", "first"),
    ("pavia", "ovr", "first"), ("pavia", "ovo", "second")])
def test_bucket_equals_lone_solves_and_reference_vmap(kind, strategy,
                                                      selection):
    """Shared per-task Grams: the port's bucket solve against (a) each
    task's lone port ``binary_smo`` (bit for bit) and (b) the
    reference's vmapped ``binary_smo`` over the same bucket (the program
    ``repro/core/dist.py::_fit_many_smo`` runs) in n_iter and alphas."""
    x, ts, sched = _bucket(kind, strategy)
    gamma = 1.0 / x.shape[1]
    kw = dict(C=1.0, tol=1e-3, selection=selection, check_every=16)
    jkp, tkp = JK.KernelParams(gamma=gamma), TK.KernelParams(gamma=gamma)
    jcfg = jsmo.SMOConfig(**kw)

    def jone(xt, yt, mt, g):
        r = jsmo.binary_smo(xt, yt, mt, cfg=jcfg, kernel=jkp,
                            engine=JKE.DenseKernelEngine(xt, jkp, gram=g))
        return r.alpha, r.b, r.n_iter, r.converged

    jfit = jax.jit(jax.vmap(jone))
    for bucket in sched.buckets:
        xt, yt, mk, _ = tdist._bucket_arrays(ts, bucket)
        grams = _shared_grams(xt, gamma)
        eng = TKE.TaskKernelEngine(tt(xt), tkp, gram=tt(grams))
        r = tsmo.binary_smo_tasks(tt(xt), tt(yt), torch.from_numpy(mk),
                                  cfg=tsmo.SMOConfig(**kw), kernel=tkp,
                                  engine=eng)
        ja, jb, jn, jc = (np.asarray(v) for v in jfit(
            jnp.asarray(xt), jnp.asarray(yt), jnp.asarray(mk),
            jnp.asarray(grams)))
        np.testing.assert_array_equal(np_(r.n_iter), jn)
        np.testing.assert_allclose(np_(r.alpha), ja, rtol=0, atol=1e-5)
        np.testing.assert_allclose(np_(r.b), jb, rtol=0, atol=1e-5)
        assert bool(r.converged.all()) and bool(jc.all())
        for s in range(xt.shape[0]):
            lone = tsmo.binary_smo(
                tt(xt[s]), tt(yt[s]), torch.from_numpy(mk[s]),
                cfg=tsmo.SMOConfig(**kw), kernel=tkp,
                engine=TKE.DenseKernelEngine(tt(xt[s]), tkp,
                                             gram=tt(grams[s])))
            assert torch.equal(lone.alpha, r.alpha[s])
            assert torch.equal(lone.b, r.b[s])
            assert int(lone.n_iter) == int(r.n_iter[s])


@pytest.mark.parametrize("engine", ["dense", "chunked", "pallas"])
def test_bucket_engines_equal_lone_solves(engine):
    """Each engine's bucket solve equals its own lone solves bit for bit
    (the pallas rows are one task-axis call; here its plain version)."""
    x, ts, sched = _bucket("pavia", "ovo")
    kp = TK.KernelParams(gamma=0.02)
    cfg = tsmo.SMOConfig(C=1.0, check_every=8)
    xt, yt, mk, _ = tdist._bucket_arrays(ts, sched.buckets[0])
    xt, yt, mk = xt[:6], yt[:6], mk[:6]
    r = tsmo.binary_smo_tasks(tt(xt), tt(yt), torch.from_numpy(mk), cfg=cfg,
                              kernel=kp, engine=engine)
    for s in range(len(xt)):
        lone = tsmo.binary_smo(tt(xt[s]), tt(yt[s]), torch.from_numpy(mk[s]),
                               cfg=cfg, kernel=kp, engine=engine)
        assert torch.equal(lone.alpha, r.alpha[s])
        assert int(lone.n_iter) == int(r.n_iter[s])


def test_bucket_freezes_each_task_at_max_iter_and_warm_starts():
    """max_iter stops each task at its own check, as the lone solve does;
    an alpha0 warm start from the optimum converges at once."""
    x, ts, sched = _bucket("iris", "ovr")
    kp = TK.KernelParams(gamma=0.25)
    xt, yt, mk, _ = tdist._bucket_arrays(ts, sched.buckets[0])
    for cfg in (tsmo.SMOConfig(max_iter=20, check_every=8),
                tsmo.SMOConfig(max_iter=0)):
        r = tsmo.binary_smo_tasks(tt(xt), tt(yt), torch.from_numpy(mk),
                                  cfg=cfg, kernel=kp, engine="dense")
        for s in range(len(xt)):
            lone = tsmo.binary_smo(tt(xt[s]), tt(yt[s]),
                                   torch.from_numpy(mk[s]), cfg=cfg,
                                   kernel=kp, engine="dense")
            assert torch.equal(lone.alpha, r.alpha[s])
            assert int(lone.n_iter) == int(r.n_iter[s])
    full = tsmo.binary_smo_tasks(tt(xt), tt(yt), torch.from_numpy(mk),
                                 kernel=kp, engine="dense")
    warm = tsmo.binary_smo_tasks(tt(xt), tt(yt), torch.from_numpy(mk),
                                 kernel=kp, engine="dense",
                                 alpha0=full.alpha)
    assert bool(warm.converged.all()) and int(warm.n_iter.max()) <= 2
    with pytest.raises(ValueError, match=r"\(T, w, d\)"):
        tsmo.binary_smo_tasks(tt(xt[0]), tt(yt[0]))
    with pytest.raises(ValueError, match="no task-batched form"):
        TKE.TaskKernelEngine(tt(xt), kp, "rff")


# ----------------------------------------------------------- fit_taskset
def _gram_certificate(xk, yk, alpha, gamma, c):
    gram = TK.make_gram_fn(TK.KernelParams(gamma=gamma))(
        torch.from_numpy(xk), torch.from_numpy(xk)).double().numpy()
    f = gram @ (alpha.astype(np.float64) * yk) - yk  # repro: noqa[R002] -- test-side f64 recompute of the gradient
    return float(tsmo.kkt_violation(alpha, yk, f, 0.0, c))


@pytest.mark.parametrize("kind,strategy,engine", [
    ("imbalanced", "ovo", "dense"), ("imbalanced", "ovr", "pallas"),
    ("pavia", "ovo", "pallas"), ("pavia", "ovr", "chunked")])
def test_fit_taskset_matches_reference(kind, strategy, engine):
    """Each package on its own Gram: every task converged and certified
    (f64 KKT of a recomputed gradient <= tol), b within 2 tol and the
    training-set decision signs equal."""
    x, y = _problem(kind)
    gamma = 1.0 / x.shape[1]
    jts = JMC.get_strategy(strategy).build_taskset(x, y)
    tts = TMC.get_strategy(strategy).build_taskset(x, y)
    jf = jdist.fit_taskset(jts, kernel=JK.KernelParams(gamma=gamma),
                           engine="chunked" if engine == "pallas" else engine)
    tf = tdist.fit_taskset(tts, kernel=TK.KernelParams(gamma=gamma),
                           engine=engine, device="cpu")
    np.testing.assert_array_equal(tf.sizes, jf.sizes)
    assert tf.converged.all() and jf.converged.all()
    np.testing.assert_allclose(tf.b, jf.b, rtol=0, atol=2e-3)
    for t, task in enumerate(tts.tasks):
        k = task.size
        for fit in (tf, jf):
            assert _gram_certificate(task.x, task.y, fit.alpha[t, :k],
                                     gamma, 1.0) <= 1e-3
    tsv = TSVC(strategy=strategy, engine=engine, device="cpu").fit(x, y)
    jsv = JSVC(strategy=strategy,
               engine="chunked" if engine == "pallas" else engine).fit(x, y)
    np.testing.assert_array_equal(tsv.predict(x), jsv.predict(x))


def test_fit_taskset_warm_start_and_svr_tasks_match_reference():
    """``alpha0`` (the TaskSetFit layout) and ``svr_epsilon`` (the
    doubled spec per task, alpha out = beta) against the reference: a
    warm start from the reference's optimum converges within one block
    at it; the regression tasks (target = the first feature) certify in
    both packages with b within 2 tol."""
    x, y = _problem("iris")
    jts = JMC.get_strategy("ovo").build_taskset(x, y)
    tts = TMC.get_strategy("ovo").build_taskset(x, y)
    jkp, tkp = JK.KernelParams(gamma=0.25), TK.KernelParams(gamma=0.25)
    jf = jdist.fit_taskset(jts, kernel=jkp, engine="dense")
    tw = tdist.fit_taskset(tts, kernel=tkp, engine="dense", device="cpu",
                           alpha0=jf.alpha)
    jw = jdist.fit_taskset(jts, kernel=jkp, engine="dense", alpha0=jf.alpha)
    assert tw.converged.all() and int(tw.n_iter.max()) <= 32
    np.testing.assert_allclose(tw.alpha, jw.alpha, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tw.b, jw.b, rtol=0, atol=1e-5)
    treg = tts._replace(tasks=tuple(t._replace(y=t.x[:, 0].copy())
                                    for t in tts.tasks))
    jreg = jts._replace(tasks=tuple(t._replace(y=t.x[:, 0].copy())
                                    for t in jts.tasks))
    tr = tdist.fit_taskset(treg, kernel=tkp, engine="dense", device="cpu",
                           svr_epsilon=0.1)
    jr = jdist.fit_taskset(jreg, kernel=jkp, engine="dense", svr_epsilon=0.1)
    assert tr.converged.all() and jr.converged.all()
    np.testing.assert_allclose(tr.b, jr.b, rtol=0, atol=2e-3)
    np.testing.assert_allclose(tr.alpha, jr.alpha, rtol=0, atol=2e-2)


def test_vmapped_ovo_shim_matches_reference():
    x, y = _problem("iris")
    kp = 0.25
    j = jdist.vmapped_ovo_fit(jovo.build_tasks(x, y, pad_tasks_to=4),
                              kernel=JK.KernelParams(gamma=kp))
    t = tdist.vmapped_ovo_fit(tovo.build_tasks(x, y, pad_tasks_to=4),
                              kernel=TK.KernelParams(gamma=kp), device="cpu")
    assert t.alpha.shape == j.alpha.shape
    np.testing.assert_array_equal(np_(t.converged), np_(j.converged))
    np.testing.assert_allclose(np_(t.b), np_(j.b), rtol=0, atol=2e-3)
    assert not np_(t.alpha)[3:].any()    # the padding task


def test_fit_taskset_gd_runs():
    """solver="gd" (ROADMAP A.7) runs: every task for its fixed steps,
    reported converged, as in the reference (held against it in
    tests/test_torch_gd.py)."""
    _, ts, _ = _bucket("iris", "ovo")
    fit = tdist.fit_taskset(ts, solver="gd", device="cpu")
    assert fit.converged.all() and (fit.n_iter == 2000).all()
    assert fit.alpha.shape == (ts.n_tasks, int(ts.sizes.max()))


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(shard="cascade"), ValueError, "shard mode"),
    (dict(shard="data"), NotImplementedError, "A.11"),
    (dict(shard="auto"), NotImplementedError, "A.11"),
    (dict(mesh=object()), NotImplementedError, "A.11")])
def test_fit_taskset_unported_options_raise(kwargs, error, match):
    _, ts, _ = _bucket("iris", "ovo")
    with pytest.raises(error, match=match):
        tdist.fit_taskset(ts, device="cpu", **kwargs)
    with pytest.raises(ValueError):
        tdist.fit_taskset(ts, device="cpu", shard="rows")


# --------------------------------------------------------------- SVC
@pytest.mark.parametrize("kind", ["iris", "pavia"])
@pytest.mark.parametrize("strategy", ["ovo", "ovr"])
def test_paper_pipeline_multiclass_matches_reference(kind, strategy):
    """The paper's multiclass pipelines (iris, 3 classes; Pavia-like,
    9 classes): both packages converge, certify every task and predict
    the same held-out labels."""
    x, y = _problem(kind)
    xtr, ytr, xte, yte = train_test_split(x, y, test_frac=0.25, seed=0)
    j = JSVC(strategy=strategy, engine="chunked").fit(xtr, ytr)
    t = TSVC(strategy=strategy, engine="pallas", device="cpu").fit(xtr, ytr)
    assert t.converged_ and j.converged_
    np.testing.assert_array_equal(t.classes_, j.classes_)
    np.testing.assert_array_equal(t.predict(xte), j.predict(xte))
    assert t.score(xte, yte) == pytest.approx(j.score(xte, yte))
    assert t.score(xte, yte) >= (0.85 if kind == "iris" else 0.99)
    df = t.decision_function(xte)
    assert df.shape == (t._taskset.n_tasks, len(xte))
    np.testing.assert_allclose(df, j.decision_function(xte), rtol=0,
                               atol=2e-2)
    np.testing.assert_allclose(df, t._decision_function_engine(xte),
                               rtol=2e-4, atol=1e-4)
    assert t.n_support_.shape == (t._taskset.n_tasks,)
    gamma = t.kernel_params.gamma
    for k, task in enumerate(t._taskset.tasks):
        assert _gram_certificate(task.x, task.y,
                                 t._fit.alpha[k, :task.size], gamma,
                                 1.0) <= 1e-3


def test_bucketed_and_padded_schedules_predict_alike():
    x, y = _problem("imbalanced")
    b = TSVC(schedule="bucketed", device="cpu").fit(x, y)
    p = TSVC(schedule="padded", device="cpu").fit(x, y)
    assert len(b._schedule.buckets) > 1 and len(p._schedule.buckets) == 1
    np.testing.assert_array_equal(b.n_support_, p.n_support_)
    np.testing.assert_allclose(b._fit.alpha, p._fit.alpha, rtol=0,
                               atol=1e-5)
    xq = normalize(make_imbalanced_blobs(IMBALANCED_SIZES, 10, sep=4.0,
                                         seed=9)[0].astype(np.float32))
    np.testing.assert_array_equal(b.predict(xq), p.predict(xq))


def test_margin_decision_and_serving_buckets():
    x, y = _problem("pavia")
    clf = TSVC(decision="margin", device="cpu").fit(x, y)
    jclf = JSVC(decision="margin", engine="chunked").fit(x, y)
    np.testing.assert_array_equal(clf.predict(x), jclf.predict(x))
    widths = [g.sv_x.shape[1] for g in clf._serving_buckets]
    ids = np.sort(np.concatenate([g.task_ids for g in clf._serving_buckets]))
    np.testing.assert_array_equal(ids, np.arange(clf._taskset.n_tasks))
    for g in clf._serving_buckets:   # each as wide as its largest task
        assert g.sv_x.shape[1] == clf.n_support_[g.task_ids].max()
    assert min(widths) >= 1


@pytest.mark.parametrize("kwargs", [dict(strategy="ova"),
                                    dict(decision="majority"),
                                    dict(schedule="striped")])
def test_svc_multiclass_validation(kwargs):
    with pytest.raises(ValueError):
        TSVC(device="cpu", **kwargs)


# ------------------------------------------------------------- low rank
@pytest.mark.parametrize("strategy", ["ovo", "ovr"])
@pytest.mark.parametrize("backend", ["rff", "nystrom"])
def test_multiclass_lowrank_on_carried_map_matches_reference(
        strategy, backend, monkeypatch):
    """One shared feature map: the reference's map is carried into the
    port (``approx.engine_from_map``), and each task's DCD fit meets the
    reference's at the optimum (the two draw their coordinate orders
    from different generators): converged, task_w within 5 tol, labels
    equal away from the boundary."""
    x, y = _problem("iris")
    xtr, ytr, xte, _ = train_test_split(x, y, test_frac=0.25, seed=0)
    kw = dict(strategy=strategy, engine=backend, rank=24)
    j = JSVC(**kw).fit(xtr, ytr)
    carried = tapprox.engine_from_map(tt(xtr), j._feature_map).fmap
    monkeypatch.setattr(tsvm.approx, "make_feature_map",
                        lambda *a, **k: carried)
    t = TSVC(**kw, device="cpu").fit(xtr, ytr)
    assert t.converged_ and j.converged_
    assert t.task_w_.shape == j.task_w_.shape == (t._taskset.n_tasks, 24)
    np.testing.assert_allclose(t.task_w_, j.task_w_, rtol=0, atol=5e-3)
    np.testing.assert_allclose(t.task_b_, j.task_b_, rtol=0, atol=5e-3)
    dt, dj = t.decision_function(xte), j.decision_function(xte)
    np.testing.assert_allclose(dt, dj, rtol=0, atol=2e-2)
    away = np.abs(dj) > 2e-2
    np.testing.assert_array_equal(dt[away] > 0, dj[away] > 0)
    np.testing.assert_array_equal(t.predict(xte), j.predict(xte))
    assert len(t._task_alpha) == t._taskset.n_tasks


def test_multiclass_lowrank_tasks_certify():
    """Every task of a multiclass low-rank fit certifies: the float64 KKT
    violation of the augmented-bias dual (r = 0) of its returned state
    <= tol. The DCD epoch rule alone (max projected gradient over an
    epoch <= tol / 2, measured before later coordinates move) stopped two
    of these 36 tasks at 1.05e-3 and 1.09e-3; the solver now also
    certifies the state it returns before it stops."""
    x, y = load_pavia_like(n_per_class=40, n_classes=9, seed=7)
    xtr, ytr, _, _ = train_test_split(normalize(x), y, test_frac=0.1,
                                      seed=7)
    clf = TSVC(strategy="ovo", engine="rff", rank=128, device="cpu").fit(
        xtr, ytr)
    assert clf.converged_
    phi = np_(clf._feature_map.transform(tt(xtr))).astype(np.float64)  # repro: noqa[R002] -- test-side f64 certificate
    for t, task in enumerate(clf._taskset.tasks):
        pb = np.concatenate([phi[task.indices],
                             np.ones((task.size, 1))], axis=1)
        a = clf._task_alpha[t].astype(np.float64)  # repro: noqa[R002] -- test-side f64 certificate
        f = pb @ (pb.T @ (a * task.y)) - task.y
        assert float(tsmo.kkt_violation(a, task.y, f, 0.0, 1.0,
                                        r=0.0)) <= 1e-3, t
