"""The exact SMO solve as a device program: one CUDA graph a check block.

``smo.solve_qp`` and ``smo.solve_qp_tasks`` keep their state in buffers
allocated once a solve and written in place, and on the card replay each
check block after the first as one CUDA graph captured once a solve
(``smo._Block``). A graph replays on the tensors it captured, so a state
tensor rebound to a new one anywhere (in the iteration, or between
blocks by the shrink, the un-shrink, the certify restart, a bucket's
freeze) gives a solve that replays on stale state and returns wrong
numbers without raising.

CPU part (runs everywhere; nothing is captured on the CPU):

* every state buffer, the row cache's and a bucket's ``live`` flags keep
  their storage (``data_ptr``) over every iteration of a solve that
  shrinks and un-shrinks, that restarts from a failed certificate (the
  drifted-row problems of ``tests/test_torch_certify.py``), and of a
  bucket whose tasks freeze at different checks and restart;
* at the reference parity cases (first and second selection, SVR with
  shrinking, an OvO bucket, a warm start) the solve gives the JAX
  reference's alphas, b, n_iter and support set bit for bit. The
  reference's and the port's Gram matvecs sum in their own orders, so
  where a matvec feeds the trajectory (the un-shrink, a warm start's f)
  the port's engine here takes the reference's matvec: the loop is
  what is held. These cases import JAX inside the test, and skip where
  it is missing or where torch sees a card (the reference runs on the
  CPU only).

Card part (``requires_cuda``; skips here with a reason). Graph and eager
(``smo.CUDA_GRAPHS`` off) give equal bits in alpha, b, n_iter, n_active
and the row cache's hits and misses, and equal ``ops.launches``: binary
RBF SVC with first and second selection, SVR with shrinking and unshrunk
(and a drifted-row restart), an OvO bucket and a warm-started cascade.
``CompileGuard`` counts one capture for a solve of several blocks and
none for a solve that stops in its first block. On the machine with the
card::

    PYTHONPATH=src python -m pytest -q tests/test_torch_smo_graph.py
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.analysis import CompileGuard
from repro_torch.core import dist
from repro_torch.core import kernel_engine as KE
from repro_torch.core import kernels as K
from repro_torch.core import multiclass as MC
from repro_torch.core import smo
from repro_torch.core.svm import SVC
from repro_torch.data import (load_breast_cancer_like, load_iris,
                              load_pavia_like, make_blobs,
                              make_synth_regression, normalize)
from repro_torch.kernels import ops
from test_torch_certify import DriftEngine, DriftTaskEngine
from test_torch_certify import _problem as drift_problem
from torch_helpers import cuda, np_, tt  # noqa: F401  (cuda: fixture)

TOL = 1e-3


# ------------------------------------------------------------- problems
def _binary(kind):
    if kind == "blobs":
        x, yl = make_blobs(60, 2, 6, sep=1.5, seed=3)
        x, y = normalize(x), np.where(yl == 0, 1.0, -1.0)
    elif kind == "breast":
        x, yl = load_breast_cancer_like(n_samples=260)
        x, y = normalize(x), np.where(yl == 1, 1.0, -1.0)
    else:   # iris versicolor against virginica: overlapping classes
        x, yl = load_iris()
        keep = yl > 0
        x, y = normalize(x[keep]), np.where(yl[keep] == 2, 1.0, -1.0)
    return x.astype(np.float32), y.astype(np.float32)


def _regression(n=160):
    x, y = make_synth_regression(n, 4, kind="sinc", noise=0.05, seed=3)
    return x.astype(np.float32), y.astype(np.float32)


def _ovo_bucket(n_per=30, noise=1.0):
    x, y = load_pavia_like(n_per_class=n_per, n_classes=4, n_bands=12,
                           seed=7, noise=noise)
    ts = MC.get_strategy("ovo").build_taskset(normalize(x), y)
    bucket = MC.build_schedule(ts.sizes).buckets[0]
    return dist._bucket_arrays(ts, bucket)[:3]


def _svr_qp(x, y, eps=0.1, C=1.0):
    """The doubled epsilon-SVR QP of ``svr_smo``: (x2, s, p, lo, hi)."""
    xt, yt = tt(x), tt(y)
    s, p, lo, hi = smo._svr_spec(yt, eps, C)
    return torch.cat([xt, xt]), s, p, lo, hi


# ---------------------------------------------------- the storage spy
class StateSpy:
    """Wraps ``smo._smo_iteration``: at every iteration, the data_ptr of
    each state buffer, of the row cache's tensors and of the tensors the
    iteration reads (``live`` included), and how many samples are active
    and tasks live. Wraps ``smo._certified`` to count failed
    certificates."""

    def __init__(self, monkeypatch):
        self.ptrs, self.active, self.live, self.failed = [], [], [], 0
        self.state = None
        iterate, certified = smo._smo_iteration, smo._certified

        def spy_iteration(st, **kw):
            self.state = st
            self.ptrs.append(self.pointers(st, kw))
            self.active.append(int(st.active.sum()))
            if kw.get("live") is not None:
                self.live.append(tuple(kw["live"].tolist()))
            return iterate(st, **kw)

        def spy_certified(*args, **kw):
            ok, f = certified(*args, **kw)
            self.failed += not ok
            return ok, f

        monkeypatch.setattr(smo, "_smo_iteration", spy_iteration)
        monkeypatch.setattr(smo, "_certified", spy_certified)

    @staticmethod
    def pointers(st, kw) -> tuple:
        ts = [st.alpha, st.f, st.n_iter, st.b_up, st.b_low, st.active]
        if st.cache is not None:
            c = st.cache
            ts += [c.keys, c.stamp, c.rows, c.clock, c.hits, c.misses]
        ts += [kw[k] for k in ("y", "mask", "lo", "hi", "diag", "live")
               if kw.get(k) is not None]
        return tuple(t.data_ptr() for t in ts)

    def assert_fixed(self, blocks_at_least: int, check_every: int):
        assert len(self.ptrs) >= blocks_at_least * check_every
        assert len(set(self.ptrs)) == 1, "a state tensor was rebound"
        st = self.state   # and still the same storage after the loop
        assert (st.alpha.data_ptr(), st.f.data_ptr(),
                st.active.data_ptr()) == self.ptrs[0][:2] + (
                    self.ptrs[0][5],)


# ------------------------------------------------------------ CPU part
@pytest.mark.parametrize("engine", ["dense", "chunked", "pallas"])
@pytest.mark.parametrize("selection", ["first", "second"])
def test_buffers_keep_their_storage_through_shrink_and_unshrink(
        monkeypatch, engine, selection):
    x, y = _binary("breast")
    spy = StateSpy(monkeypatch)
    cfg = smo.SMOConfig(C=1.0, tol=TOL, selection=selection,
                        shrink_every=2, check_every=8)
    r = smo.binary_smo(tt(x), tt(y), cfg=cfg,
                       kernel=K.KernelParams(gamma=0.05), engine=engine)
    assert bool(r.converged)
    spy.assert_fixed(4, cfg.check_every)
    n = len(y)
    assert min(spy.active) < n, "the solve never shrank"
    # the un-shrink at the converged check put every sample back, in
    # place: the final state's active set is the mask
    assert int(r.n_active) == n and bool(spy.state.active.all())


def test_buffers_keep_their_storage_through_the_certify_restart(
        monkeypatch):
    x, y = drift_problem()
    kp = K.KernelParams(gamma=0.5)
    rng = np.random.default_rng(0)
    eng = DriftEngine(x, kp, tt(rng.uniform(-1e-2, 1e-2, len(y))))
    spy = StateSpy(monkeypatch)
    cfg = smo.SMOConfig(C=1.0, tol=TOL)
    r = smo.binary_smo(x, y, cfg=cfg, kernel=kp, engine=eng)
    assert bool(r.converged)
    assert spy.failed >= 1, "no certificate failed: nothing restarted"
    spy.assert_fixed(2, cfg.check_every)
    # the restart wrote the recomputed f into f's buffer: the solve went
    # on from it and its state certifies
    f = eng.gram @ (r.alpha * y) - y
    assert float(smo.kkt_violation(r.alpha, y, f, 0.0, 1.0)) <= TOL


def test_svr_buffers_keep_their_storage_through_the_restart(monkeypatch):
    x, y = _regression(120)
    x2, s, p, lo, hi = _svr_qp(x, y)
    kp = K.KernelParams(gamma=0.5)
    rng = np.random.default_rng(5)
    eng = DriftEngine(x2, kp, tt(rng.uniform(-1e-2, 1e-2, len(s))))
    spy = StateSpy(monkeypatch)
    r = smo.solve_qp(x2, s, p, lo, hi, cfg=smo.SMOConfig(C=1.0, tol=TOL),
                     kernel=kp, engine=eng)
    assert bool(r.converged) and spy.failed >= 1
    spy.assert_fixed(2, 32)


def test_bucket_buffers_keep_their_storage_through_freeze_and_restart(
        monkeypatch):
    rng = np.random.default_rng(3)
    xs, ys = zip(*(drift_problem(n_per=60, seed=10 + s) for s in range(3)))
    x, y = torch.stack(xs), torch.stack(ys)
    kp = K.KernelParams(gamma=0.5)
    eng = DriftTaskEngine(x, kp, tt(rng.uniform(-1e-2, 1e-2, (3, 120))))
    spy = StateSpy(monkeypatch)
    cfg = smo.SMOConfig(C=1.0, tol=TOL, check_every=16)
    r = smo.binary_smo_tasks(x, y, cfg=cfg, kernel=kp, engine=eng)
    assert bool(r.converged.all())
    assert spy.failed >= 1, "no task restarted from a failed certificate"
    assert any(0 < sum(v) < 3 for v in spy.live), (
        "no block ran with some tasks frozen and others live")
    spy.assert_fixed(3, cfg.check_every)


def test_cpu_solves_capture_nothing():
    x, y = _binary("breast")
    with CompileGuard(budget=0, note="a CPU solve") as g:
        r = smo.binary_smo(tt(x), tt(y), cfg=smo.SMOConfig(check_every=8),
                           kernel=K.KernelParams(gamma=0.05),
                           engine="pallas")
    assert g.count == 0 and int(r.n_iter) > 8


def test_take_and_add_launches_move_a_captured_blocks_count():
    before = dict(ops.launches)
    ops.launches["kkt_select"] += 3
    ops.launches["rbf_gram_row_cached"] += 6
    taken = ops.take_launches(before)
    assert taken == {"kkt_select": 3, "rbf_gram_row_cached": 6}
    assert ops.launches == before
    ops.add_launches(taken)
    ops.add_launches(taken)
    assert ops.launches["kkt_select"] == before["kkt_select"] + 6
    ops.launches.update(before)


# ---------------------------------------- the reference, bit for bit
@pytest.fixture
def ref():
    """The JAX reference's modules on the CPU, imported when a test runs.
    Where torch sees a card these tests skip: the reference is held on
    the CPU only, and a JAX installed beside a card would run on it."""
    if torch.cuda.is_available():
        pytest.skip("the reference parity cases run on a machine without "
                    "a card (JAX on the CPU)")
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import kernel_engine as JKE
    from repro.core import kernels as JK
    from repro.core import smo as jsmo

    class Ref:
        pass

    r = Ref()
    r.jax, r.jnp, r.JKE, r.JK, r.jsmo = jax, jnp, JKE, JK, jsmo
    return r


class RefMatvecEngine(KE.DenseKernelEngine):
    """The port's dense engine over a given Gram whose matvec is the
    reference's (jitted ``gram @ v``), so that an un-shrink or a warm
    start feeds the port's loop the reference's f bit for bit."""

    def __init__(self, x, kernel, gram, ref):
        super().__init__(x, kernel, gram=tt(gram))
        self._jgram = ref.jnp.asarray(gram)
        self._mv = ref.jax.jit(ref.jnp.matmul)

    def matvec(self, v):
        return tt(np.asarray(self._mv(self._jgram, np_(v))))


def _assert_bits(tr, jr):
    ta, ja = np_(tr.alpha), np_(jr.alpha)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(np_(tr.b), np_(jr.b))
    np.testing.assert_array_equal(np_(tr.n_iter), np_(jr.n_iter))
    np.testing.assert_array_equal(ta > 0, ja > 0)   # the support set


@pytest.mark.parametrize("kind,C,selection,shrink", [
    ("blobs", 1.0, "first", 0), ("blobs", 10.0, "second", 0),
    ("breast", 0.5, "second", 4), ("iris", 10.0, "first", 4)])
def test_binary_solve_gives_the_references_bits(ref, kind, C, selection,
                                                shrink):
    x, y = _binary(kind)
    gamma = 1.0 / x.shape[1]
    jx = ref.jnp.asarray(x)
    gram = np_(ref.JK.rbf_gram(jx, jx, gamma=gamma))
    cfg = dict(C=C, tol=TOL, selection=selection, shrink_every=shrink,
               check_every=16)
    jkp = ref.JK.KernelParams(gamma=gamma)
    jr = ref.jsmo.binary_smo(jx, ref.jnp.asarray(y),
                             cfg=ref.jsmo.SMOConfig(**cfg), kernel=jkp,
                             engine=ref.JKE.DenseKernelEngine(
                                 jx, jkp, gram=ref.jnp.asarray(gram)))
    tkp = K.KernelParams(gamma=gamma)
    tr = smo.binary_smo(tt(x), tt(y), cfg=smo.SMOConfig(**cfg), kernel=tkp,
                        engine=RefMatvecEngine(tt(x), tkp, gram, ref))
    _assert_bits(tr, jr)
    assert int(tr.n_active) == int(jr.n_active)


@pytest.mark.parametrize("shrink", [0, 4])
@pytest.mark.parametrize("eps,C", [(0.1, 1.0), (0.05, 10.0)])
def test_svr_solve_gives_the_references_bits(ref, eps, C, shrink):
    x, y = _regression()
    x2 = np.concatenate([x, x])
    jx2 = ref.jnp.asarray(x2)
    gram2 = np_(ref.JK.rbf_gram(jx2, jx2, gamma=0.5))
    cfg = dict(C=C, tol=TOL, shrink_every=shrink, check_every=16)
    s, p, lo, hi = ref.jsmo._svr_spec(ref.jnp.asarray(y), eps, C)
    jr = ref.jsmo.solve_qp(jx2, s, p, lo, hi,
                           cfg=ref.jsmo.SMOConfig(**cfg),
                           kernel=ref.JK.KernelParams(gamma=0.5),
                           gram=ref.jnp.asarray(gram2))
    tkp = K.KernelParams(gamma=0.5)
    ts, tp, tlo, thi = smo._svr_spec(tt(y), eps, C)
    tr = smo.solve_qp(tt(x2), ts, tp, tlo, thi, cfg=smo.SMOConfig(**cfg),
                      kernel=tkp,
                      engine=RefMatvecEngine(tt(x2), tkp, gram2, ref))
    _assert_bits(tr, jr)
    assert int(tr.n_active) == int(jr.n_active)


@pytest.mark.parametrize("selection", ["first", "second"])
def test_ovo_bucket_gives_the_references_vmapped_bits(ref, selection):
    xt, yt, mk = _ovo_bucket()
    gamma = 1.0 / xt.shape[2]
    grams = np.stack([np_(ref.JK.rbf_gram(ref.jnp.asarray(a),
                                          ref.jnp.asarray(a), gamma=gamma))
                      for a in xt])
    kw = dict(C=1.0, tol=TOL, selection=selection, check_every=16)
    jkp, jcfg = ref.JK.KernelParams(gamma=gamma), ref.jsmo.SMOConfig(**kw)

    def one(x_, y_, m_, g_):
        r = ref.jsmo.binary_smo(x_, y_, m_, cfg=jcfg, kernel=jkp,
                                engine=ref.JKE.DenseKernelEngine(
                                    x_, jkp, gram=g_))
        return r.alpha, r.b, r.n_iter

    ja, jb, jn = ref.jax.jit(ref.jax.vmap(one))(
        *(ref.jnp.asarray(a) for a in (xt, yt, mk, grams)))
    tkp = K.KernelParams(gamma=gamma)
    tr = smo.binary_smo_tasks(
        tt(xt), tt(yt), torch.from_numpy(mk), cfg=smo.SMOConfig(**kw),
        kernel=tkp, engine=KE.TaskKernelEngine(tt(xt), tkp, gram=tt(grams)))
    assert xt.shape[0] >= 3 and int(tr.n_iter.max()) > 16
    np.testing.assert_array_equal(np_(tr.alpha), np.asarray(ja))
    np.testing.assert_array_equal(np_(tr.b), np.asarray(jb))
    np.testing.assert_array_equal(np_(tr.n_iter), np.asarray(jn))
    np.testing.assert_array_equal(np_(tr.alpha) > 0, np.asarray(ja) > 0)


def test_warm_start_gives_the_references_bits(ref):
    x, y = _binary("breast")
    gamma = 0.05
    jx, jy = ref.jnp.asarray(x), ref.jnp.asarray(y)
    gram = np_(ref.JK.rbf_gram(jx, jx, gamma=gamma))
    jkp, tkp = ref.JK.KernelParams(gamma=gamma), K.KernelParams(gamma=gamma)
    cfg = dict(C=1.0, tol=TOL, check_every=16)

    def jsolve(**kw):
        return ref.jsmo.binary_smo(
            jx, jy, cfg=ref.jsmo.SMOConfig(**cfg, **kw), kernel=jkp,
            engine=ref.JKE.DenseKernelEngine(jx, jkp,
                                             gram=ref.jnp.asarray(gram)))

    # a start a few blocks short of the optimum: the warm solve then
    # runs blocks of its own, from the f the start's matvec gives
    start = np_(jsolve(max_iter=48).alpha)
    jr = ref.jsmo.binary_smo(
        jx, jy, cfg=ref.jsmo.SMOConfig(**cfg), kernel=jkp,
        engine=ref.JKE.DenseKernelEngine(jx, jkp, gram=ref.jnp.asarray(gram)),
        alpha0=ref.jnp.asarray(start))
    tr = smo.binary_smo(tt(x), tt(y), cfg=smo.SMOConfig(**cfg), kernel=tkp,
                        engine=RefMatvecEngine(tt(x), tkp, gram, ref),
                        alpha0=tt(start))
    assert int(tr.n_iter) > 16
    _assert_bits(tr, jr)


# ----------------------------------------------------------- card part
@contextlib.contextmanager
def _graphs(on: bool):
    saved = smo.CUDA_GRAPHS
    smo.CUDA_GRAPHS = on
    try:
        yield
    finally:
        smo.CUDA_GRAPHS = saved


def _captures(guard, solver=None) -> int:
    """Captures the guard counted, of ``solver`` (any, for None)."""
    want = "cuda graph capture" + ("" if solver is None else f" {solver} ")
    return sum(e.startswith(want) for e in guard.compiled)


class CacheTap:
    """A bound engine whose row caches are kept, to read their hits and
    misses after the solve."""

    def __init__(self, eng):
        self.caches = []
        init = eng.init_cache

        def tapped():
            self.caches.append(init())
            return self.caches[-1]

        eng.init_cache = tapped

    def counts(self) -> list:
        return [(int(c.hits), int(c.misses)) for c in self.caches
                if c is not None]


def _graph_and_eager(solve, solver=None):
    """``solve()`` with the capture on, then with the eager loop: each
    run's (result, launches, captures), the result on the host."""
    runs = []
    for on in (True, False):
        with _graphs(on):
            torch.cuda.synchronize()
            ops.reset_launches()
            with CompileGuard(budget=100) as g:
                out = solve()
            torch.cuda.synchronize()
            runs.append((out, dict(ops.launches), _captures(g, solver)))
    return runs


def _assert_equal_runs(runs, *, solves_with_blocks: int = 1):
    (a, la, ca), (b, lb, cb) = runs
    assert la == lb, "the graph run counts other launches than the eager"
    assert cb == 0 and ca == solves_with_blocks
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def _result(r, tap=None) -> dict:
    out = {k: np_(getattr(r, k)) for k in ("alpha", "b", "n_iter",
                                            "n_active", "converged")}
    if tap is not None:
        out["cache_hits_misses"] = tap.counts()
    return out


def _card_binary(dev, n_per=700):
    x, y = load_pavia_like(n_per_class=n_per, n_classes=2, n_bands=102,
                           seed=7, noise=1.0)
    return (tt(normalize(x), device=dev),
            tt(np.where(y == 1, 1.0, -1.0), device=dev))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("selection,shrink", [("first", 4), ("second", 4),
                                              ("first", 0)])
def test_card_svc_graph_equals_eager(cuda, selection, shrink):  # noqa: F811
    x, y = _card_binary(cuda)
    kp = K.resolve_gamma(K.KernelParams(gamma=-1.0), x)
    cfg = smo.SMOConfig(C=1.0, tol=TOL, selection=selection,
                        shrink_every=shrink)

    def solve():
        eng = KE.make_engine(x, kp, "pallas")
        tap = CacheTap(eng)
        return _result(smo.binary_smo(x, y, cfg=cfg, kernel=kp,
                                      engine=eng), tap)

    runs = _graph_and_eager(solve, "solve_qp")
    assert int(runs[0][0]["n_iter"]) > 2 * cfg.check_every
    assert runs[0][1]["rbf_gram_row_cached"] > 0
    _assert_equal_runs(runs)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shrink", [4, 0])
def test_card_svr_graph_equals_eager(cuda, shrink):  # noqa: F811
    x, y = _regression(600)
    x2, s, p, lo, hi = (t.to(cuda) for t in _svr_qp(x, y))
    kp = K.KernelParams(gamma=0.5)
    cfg = smo.SMOConfig(C=1.0, tol=TOL, shrink_every=shrink)

    def solve():
        eng = KE.make_engine(x2, kp, "pallas")
        tap = CacheTap(eng)
        return _result(smo.solve_qp(x2, s, p, lo, hi, cfg=cfg, kernel=kp,
                                    engine=eng), tap)

    runs = _graph_and_eager(solve, "solve_qp")
    assert int(runs[0][0]["n_iter"]) > 2 * cfg.check_every
    _assert_equal_runs(runs)


@pytest.mark.requires_cuda
def test_card_certify_restart_graph_equals_eager(cuda):  # noqa: F811
    x, y = (t.to(cuda) for t in drift_problem())
    kp = K.KernelParams(gamma=0.5)
    err = tt(np.random.default_rng(0).uniform(-1e-2, 1e-2, len(y)),
             device=cuda)
    restarts = []

    def solve():
        eng = DriftEngine(x, kp, err)
        r = smo.binary_smo(x, y, cfg=smo.SMOConfig(C=1.0, tol=TOL),
                           kernel=kp, engine=eng)
        restarts.append(eng.matvecs)
        return _result(r)

    runs = _graph_and_eager(solve, "solve_qp")
    assert min(restarts) >= 2, "no certificate failed"
    _assert_equal_runs(runs)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("selection", ["first", "second"])
def test_card_ovo_bucket_graph_equals_eager(cuda, selection):  # noqa: F811
    xt, yt, mk = _ovo_bucket(n_per=200, noise=5.0)
    x, y = tt(xt, device=cuda), tt(yt, device=cuda)
    mask = torch.from_numpy(mk).to(cuda)
    kp = K.KernelParams(gamma=1.0 / xt.shape[2])
    cfg = smo.SMOConfig(C=1.0, tol=TOL, selection=selection)

    def solve():
        eng = KE.TaskKernelEngine(x, kp, "pallas")
        return _result(smo.binary_smo_tasks(x, y, mask, cfg=cfg, kernel=kp,
                                            engine=eng))

    runs = _graph_and_eager(solve, "solve_qp_tasks")
    assert int(runs[0][0]["n_iter"].max()) > 2 * cfg.check_every
    assert runs[0][1]["kkt_select"] > 0
    _assert_equal_runs(runs)


@pytest.mark.requires_cuda
def test_card_warm_started_cascade_graph_equals_eager(cuda):  # noqa: F811
    x, y = _card_binary("cpu", n_per=600)
    xn, yn = np_(x), np.where(np_(y) > 0, 1, 0)
    solves = []

    def solve():
        before = smo.graph_stats["captures"]
        clf = SVC(engine="pallas", shard="cascade", cascade_shards=2,
                  device=cuda).fit(xn, yn)
        solves.append(smo.graph_stats["captures"] - before)
        return {"alpha": clf.alpha_, "b": clf.b_, "n_iter": clf.n_iter_,
                "kkt": clf.cascade_kkt_}

    runs = _graph_and_eager(solve)
    assert solves[0] >= 1, "no cascade solve ran more than one block"
    _assert_equal_runs(runs, solves_with_blocks=solves[0])
    assert runs[0][0]["kkt"] <= TOL


@pytest.mark.requires_cuda
def test_card_one_capture_a_solve_and_none_in_one_block(cuda):  # noqa: F811
    x, y = _card_binary(cuda)
    kp = K.resolve_gamma(K.KernelParams(gamma=-1.0), x)
    cfg = smo.SMOConfig(C=1.0, tol=TOL)
    with CompileGuard(budget=100) as g:
        r = smo.binary_smo(x, y, cfg=cfg, kernel=kp, engine="pallas")
    assert int(r.n_iter) > 2 * cfg.check_every
    assert _captures(g, "solve_qp") == 1
    # a warm start at the optimum stops in its first block: no capture
    with CompileGuard(budget=100) as g:
        w = smo.binary_smo(x, y, cfg=cfg, kernel=kp, engine="pallas",
                           alpha0=r.alpha)
    assert int(w.n_iter) < cfg.check_every and bool(w.converged)
    assert _captures(g, "solve_qp") == 0
