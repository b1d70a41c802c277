"""The port's task layer, ``SVC`` / ``SVR`` and the cascade on a mesh
(ROADMAP A.11), held against the same fits without one and against the
reference's rules (``tests/test_sharded_smo.py:293-420``,
``tests/test_ovo_dist.py:56-75``).

Ranks are threads with a gloo group each (``torch_helpers.run_ranks``,
every group timing out after at most 60 s); each mesh entry point is a
collective call that every rank makes with the same arguments and that
returns the same full result on every rank.

* ``fit_taskset`` with ``shard="task"`` on 4 workers (each rank solves
  the slots the LPT layout gave it, one all_reduce a bucket) equals the
  fit without a mesh bit for bit, by SMO and by GD, warm starts and SVR
  tasks included; ``distributed_ovo_fit`` equals ``vmapped_ovo_fit``.
* ``shard="data"`` (every task sample-sharded) and ``shard="auto"``
  (data-parallel for wide buckets with fewer tasks than workers) equal
  the ``engine="pallas"`` fit without a mesh bit for bit, and the
  default engine's fit at the reference's bounds.
* ``SVC`` / ``SVR(mesh=..., shard="data")``, binary and multiclass,
  equal their local fits; the cascade on a mesh equals the cascade
  without one.
* The reference's validation errors: ``shard="data"`` without a mesh,
  with GD, with warm starts; worker axes that the mesh lacks; a device
  that is not the mesh's.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import cascade as tcascade
from repro_torch.core import dist as tdist
from repro_torch.core import gd as tgd
from repro_torch.core import kernels as TK
from repro_torch.core import multiclass as TMC
from repro_torch.core import ovo as tovo
from repro_torch.core.svm import SVC, SVR
from repro_torch.data import (load_pavia_like, make_blobs,
                              make_synth_regression, normalize)
from torch_helpers import run_ranks, tt


def _classes(n_per=24, n_classes=3, seed=5):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(loc=m, size=(n_per, 4))
                        for m in np.linspace(-2.0, 2.0 * (n_classes - 2),
                                             n_classes)])
    return normalize(x.astype(np.float32)), np.repeat(np.arange(n_classes),
                                                      n_per)


def _taskset(n_per=24, n_classes=3):
    x, y = _classes(n_per, n_classes)
    kp = TK.resolve_gamma(TK.KernelParams(), tt(x))
    return TMC.get_strategy("ovo").build_taskset(x, y), kp


def _assert_same_fit(got, want):
    for g in got:
        np.testing.assert_array_equal(g.alpha, want.alpha)
        np.testing.assert_array_equal(g.b, want.b)
        np.testing.assert_array_equal(g.n_iter, want.n_iter)
        np.testing.assert_array_equal(g.converged, want.converged)


# -------------------------------------------------------- task parallel
@pytest.mark.parametrize("solver", ["smo", "gd"])
def test_fit_taskset_on_four_workers_equals_no_mesh(solver):
    ts, kp = _taskset(n_per=20, n_classes=4)    # 6 tasks on 4 workers
    kw = dict(solver=solver, kernel=kp, gd_cfg=tgd.GDConfig(steps=60),
              engine="pallas")
    want = tdist.fit_taskset(ts, device="cpu", **kw)
    got = run_ranks(lambda m: tdist.fit_taskset(
        ts, mesh=m, worker_axes=("workers",), **kw), 4, axis="workers")
    _assert_same_fit(got, want)


def test_fit_taskset_warm_and_svr_tasks_on_a_mesh():
    ts, kp = _taskset(n_per=16)
    rng = np.random.default_rng(1)
    a0 = rng.uniform(0, 0.5, (ts.n_tasks, int(ts.sizes.max()))).astype(
        np.float32)
    for kw in (dict(alpha0=a0), dict(svr_epsilon=0.1)):
        want = tdist.fit_taskset(ts, kernel=kp, device="cpu", **kw)
        got = run_ranks(lambda m: tdist.fit_taskset(
            ts, mesh=m, worker_axes=("w",), kernel=kp, **kw), 2, axis="w")
        _assert_same_fit(got, want)


def test_distributed_ovo_fit_equals_vmapped():
    x, y = load_pavia_like(n_per_class=12, n_classes=4)
    x = normalize(x)
    kp = TK.resolve_gamma(TK.KernelParams(), tt(x))
    tasks = tovo.build_tasks(x, y, pad_tasks_to=4)
    want = tdist.vmapped_ovo_fit(tasks, kernel=kp, device="cpu")
    got = run_ranks(lambda m: tdist.distributed_ovo_fit(
        tasks, m, ("workers",), kernel=kp), 4, axis="workers")
    for g in got:
        for f in want._fields:
            torch.testing.assert_close(getattr(g, f), getattr(want, f),
                                       rtol=0, atol=0)
    c = tovo.n_binary_tasks(4)
    assert bool(want.converged[:c].all())
    odd = tovo.build_tasks(x, y)   # 6 tasks on 4 workers
    with pytest.raises(ValueError, match="not divisible"):
        run_ranks(lambda m: tdist.distributed_ovo_fit(odd, m), 4,
                  axis="workers")


# -------------------------------------------------------- data parallel
def test_fit_taskset_data_parallel_matches_task_parallel():
    ts, kp = _taskset()
    pallas = tdist.fit_taskset(ts, kernel=kp, engine="pallas", device="cpu")
    dense = tdist.fit_taskset(ts, kernel=kp, device="cpu")
    got = run_ranks(lambda m: tdist.fit_taskset(
        ts, mesh=m, worker_axes=("workers",), kernel=kp, engine="pallas",
        shard="data"), 2, axis="workers")
    _assert_same_fit(got, pallas)
    # the reference's bounds against its local (dense) fit
    np.testing.assert_allclose(got[0].alpha, dense.alpha, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got[0].b, dense.b, atol=1e-2)
    assert got[0].converged.all()
    # auto with a low width threshold: 3 tasks < 4 workers, every bucket
    # data-parallel; at the default threshold, task-parallel: both equal
    for min_width in (16, tdist.DATA_PARALLEL_MIN_WIDTH):
        auto = run_ranks(lambda m: tdist.fit_taskset(
            ts, mesh=m, worker_axes=("workers",), kernel=kp,
            engine="pallas", shard="auto", data_min_width=min_width), 4,
            axis="workers")
        _assert_same_fit(auto, pallas)


def test_fit_taskset_mesh_validation():
    ts, kp = _taskset(n_per=8)
    a0 = np.zeros((ts.n_tasks, int(ts.sizes.max())), np.float32)
    with pytest.raises(ValueError, match="needs a mesh"):
        tdist.fit_taskset(ts, shard="data", device="cpu")
    for kw, match in ((dict(solver="gd", shard="data"), "solver='smo'"),
                      (dict(shard="bogus"), "shard mode"),
                      (dict(alpha0=a0, shard="data"), "task-parallel"),
                      (dict(svr_epsilon=0.1, shard="data"), "task-parallel"),
                      (dict(worker_axes=("rows",)), "worker axes"),
                      (dict(worker_axes=("workers", "rows"), shard="data"),
                       "worker axes")):
        with pytest.raises(ValueError, match=match):
            run_ranks(lambda m: tdist.fit_taskset(ts, mesh=m, kernel=kp,
                                                  **kw), 2, axis="workers")
    assert tdist.resolve_worker_count(None, ("workers",)) == 1
    assert run_ranks(lambda m: tdist.resolve_worker_count(m, ("shards",)),
                     2) == [2, 2]


# ----------------------------------------------------- SVC / SVR on a mesh
def _binary(n=60, seed=11):
    x, yc = make_blobs(n // 2, 2, 5, sep=2.0, seed=seed)
    return normalize(x), yc


def test_svc_shard_data_binary_and_multiclass():
    x, y = _binary()
    kw = dict(engine="pallas", device="cpu")
    local = SVC(**kw).fit(x, y)
    got = run_ranks(lambda m: SVC(mesh=m, worker_axes=("shards",),
                                  shard="data", **kw).fit(x, y), 3)
    for g in got:
        np.testing.assert_array_equal(g.alpha_, local.alpha_)
        assert g.b_ == local.b_ and g.n_iter_ == local.n_iter_
        assert g.converged_
        np.testing.assert_array_equal(g.predict(x), local.predict(x))
    xm, ym = _classes(n_per=20)
    local = SVC(**kw).fit(xm, ym)
    for shard in ("data", "auto"):
        got = run_ranks(lambda m: SVC(mesh=m, worker_axes=("shards",),
                                      shard=shard, **kw).fit(xm, ym), 2)
        for g in got:
            np.testing.assert_array_equal(g._fit.alpha, local._fit.alpha)
            np.testing.assert_array_equal(g.predict(xm), local.predict(xm))
        assert got[0].score(xm, ym) >= 0.95


def test_svr_shard_data():
    x, y = make_synth_regression(40, 3, kind="sinc", noise=0.05, seed=2)
    kw = dict(engine="pallas", device="cpu", epsilon=0.1)
    local = SVR(**kw).fit(x, y)
    got = run_ranks(lambda m: SVR(mesh=m, worker_axes=("shards",),
                                  shard="data", **kw).fit(x, y), 2)
    for g in got:
        np.testing.assert_array_equal(g.alpha_raw_, local.alpha_raw_)
        assert g.b_ == local.b_ and g.converged_
        np.testing.assert_array_equal(g.predict(x), local.predict(x))


def test_svc_svr_mesh_validation():
    x, y = _binary(40)
    with pytest.raises(ValueError, match="mesh"):
        SVC(shard="data", device="cpu").fit(x, y)
    with pytest.raises(ValueError, match="solver='smo'"):
        run_ranks(lambda m: SVC(mesh=m, worker_axes=("shards",),
                                shard="data", solver="gd",
                                device="cpu").fit(x, y), 2)
    # make_shard_mesh's axis is "shards", SVC's default worker_axes
    # ("workers",): the validators name the mesh's axes
    with pytest.raises(ValueError, match="axis"):
        run_ranks(lambda m: SVC(mesh=m, shard="data",
                                device="cpu").fit(x, y), 2)
    for fit in (lambda m: SVC(mesh=m, shard="auto", device="cpu").fit(x, y),
                lambda m: SVR(mesh=m, shard="auto",
                              device="cpu").fit(x, y.astype(np.float32)),
                lambda m: SVC(mesh=m, shard="task",
                              device="cpu").fit(x, np.arange(len(y)) % 3)):
        with pytest.raises(ValueError, match=r"mesh axes.*shards"):
            run_ranks(fit, 2)
    with pytest.raises(ValueError, match="mesh's ranks run on"):
        run_ranks(lambda m: SVC(mesh=m, device="cuda"), 1)


# ------------------------------------------------------ cascade on a mesh
def test_cascade_on_a_mesh_equals_no_mesh():
    x, y = _binary(64, seed=4)
    yy = np.where(y > 0, 1.0, -1.0).astype(np.float32)
    kp = TK.resolve_gamma(TK.KernelParams(), tt(x))
    kw = dict(kernel=kp, engine="pallas")
    want = tcascade.cascade_binary(x, yy, device="cpu", **kw)
    got = run_ranks(lambda m: tcascade.cascade_binary(
        x, yy, mesh=m, worker_axes=("shards",), **kw), 4)
    for g in got:
        np.testing.assert_array_equal(g.alpha, want.alpha)
        assert (g.b, g.n_iter, g.rounds, g.kkt) == (want.b, want.n_iter,
                                                    want.rounds, want.kkt)
    xr, yr = make_synth_regression(48, 3, kind="sinc", noise=0.05, seed=1)
    want = tcascade.cascade_svr(xr, yr, device="cpu", **kw)
    got = run_ranks(lambda m: tcascade.cascade_svr(
        xr, yr, mesh=m, worker_axes=("shards",), **kw), 2)
    for g in got:
        np.testing.assert_array_equal(g.alpha, want.alpha)
        np.testing.assert_array_equal(g.alpha_raw, want.alpha_raw)
        assert (g.b, g.rounds, g.kkt) == (want.b, want.rounds, want.kkt)
    # the SVC entry point passes its mesh through, multiclass included
    xm, ym = _classes(n_per=16)
    local = SVC(shard="cascade", engine="pallas", device="cpu").fit(xm, ym)
    got = run_ranks(lambda m: SVC(shard="cascade", engine="pallas",
                                  mesh=m, worker_axes=("shards",),
                                  device="cpu").fit(xm, ym), 2)
    for g in got:
        np.testing.assert_array_equal(g._fit.alpha, local._fit.alpha)
        np.testing.assert_array_equal(g.cascade_kkt_, local.cascade_kkt_)
