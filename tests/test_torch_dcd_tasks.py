"""The task axis of the port's dual coordinate descent: T problems over
rows of one shared Phi, solved together (``ops.dcd_epoch_tasks``,
``linear.dcd_qp_tasks`` / ``linear_svc_tasks``), held against the lone
solve and the JAX reference.

On the CPU the task epoch runs its plain version, a loop of
``dcd_epoch_plain`` over each task's gathered rows, so:

* one task epoch equals T lone plain epochs bit for bit;
* each task of the batched solve equals ``linear.linear_svc(phi[rows],
  y)`` bit for bit (alphas, w, b, n_iter, converged, gap), whatever the
  other tasks (ragged sizes, a one-row task, masked coordinates, warm
  starts, a task that stops long before the others);
* the reference's ``linear_svc`` on each task's rows meets the batched
  solve at the optimum (both certify; w and b within 5 tol, as
  tests/test_torch_linear.py holds the lone solve);
* a multiclass low-rank ``SVC`` fits all its tasks in one batched solve.

``dcd_plan`` (the kernel's launch plan) is plain Python and held here
too; the kernel itself runs in tests/test_torch_cuda.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import linear as JL
from repro_torch.core import linear as TL
from repro_torch.core import smo as tsmo
from repro_torch.core import svm as tsvm
from repro_torch.core.svm import SVC as TSVC
from repro_torch.data import load_pavia_like, normalize, train_test_split
from repro_torch.kernels import dcd as DCD
from repro_torch.kernels import ops
from torch_helpers import np_, tt

RESULT_FIELDS = ("alpha", "w", "b", "n_iter", "converged", "gap")


def _shared(n_rows=260, k=24, seed=0):
    rng = np.random.default_rng(seed)
    phi = (rng.normal(size=(n_rows, k)) / np.sqrt(k)).astype(np.float32)
    return rng, phi


def _labels(rng, phi, rows):
    z = phi[rows] @ rng.normal(size=phi.shape[1])
    return np.sign(z + 0.2 * rng.normal(size=len(rows)) + 1e-3).astype(
        np.float32)


def _tasks(rng, phi, sizes):
    rows = [np.sort(rng.choice(len(phi), size=s, replace=False))
            for s in sizes]
    return rows, [_labels(rng, phi, r) for r in rows]


def _certificate(phi, y, alpha, C=1.0, bias=1.0):
    phib = np.concatenate([np.asarray(phi, np.float64),  # repro: noqa[R002] -- test-side f64 certificate
                           np.full((len(phi), 1), bias)], axis=1)
    a = np.asarray(alpha, np.float64)  # repro: noqa[R002] -- test-side f64 certificate
    yy = np.asarray(y, np.float64)  # repro: noqa[R002] -- test-side f64 certificate
    f = phib @ (phib.T @ (a * yy)) - yy
    return float(tsmo.kkt_violation(a, yy, f, 0.0, C, r=0.0))


def _assert_same(got, want, what):
    for name in RESULT_FIELDS:
        assert torch.equal(getattr(got, name), getattr(want, name)), \
            (what, name)


# ------------------------------------------------------------- one epoch
def test_plain_task_epoch_equals_lone_plain_epochs():
    """One task epoch (some tasks listed, in any order) against each
    listed task's lone plain epoch on its gathered rows, bit for bit;
    the unlisted task is untouched."""
    rng, phi = _shared(300, 16, seed=1)
    sizes = [40, 1, 75, 9]
    rows = [rng.choice(300, size=s, replace=False) for s in sizes]
    m = sum(sizes)
    off = np.r_[0, np.cumsum(sizes)]
    y = np.where(rng.random(m) < 0.5, 1.0, -1.0)
    live = rng.random(m) < 0.85
    beta = np.where(live, rng.uniform(0, 1, m), 0.0)
    perm = np.concatenate([rng.permutation(s) for s in sizes])
    perm[off[2] + 3] = perm[off[2] + 2]   # a repeated index is allowed
    phit = tt(phi)
    q = torch.cat([torch.sum(phit[torch.from_numpy(r)] ** 2, dim=1) + 1.0
                   for r in rows])
    st = dict(rows=torch.from_numpy(np.concatenate(rows)),
              offsets=torch.from_numpy(off.astype(np.int64)), y=tt(y),
              p=-torch.ones(m), lo=torch.zeros(m), hi=torch.ones(m),
              q_diag=q.contiguous(), live=tt(live, torch.bool),
              perm=torch.from_numpy(perm.astype(np.int64)), beta=tt(beta),
              w=tt(rng.normal(size=(4, 16)) / 4), wb=tt(rng.normal(size=4)))
    before = {name: t.clone() for name, t in st.items()}
    tasks = torch.tensor([3, 0, 1])
    viols = ops.dcd_epoch_tasks(phit, **st, tasks=tasks, bias=1.0)
    assert viols.shape == (3,)
    for b, t in enumerate(tasks.tolist()):
        seg = slice(off[t], off[t + 1])
        lone = dict(phi=phit[torch.from_numpy(rows[t])].contiguous(),
                    **{name: before[name][seg].clone() for name in
                       ("y", "p", "lo", "hi", "q_diag", "live", "perm",
                        "beta")},
                    w=before["w"][t].clone(),
                    wb=before["wb"][t:t + 1].clone())
        viol = ops.dcd_epoch(**lone, bias=1.0)
        assert torch.equal(viols[b], viol)
        assert torch.equal(st["beta"][seg], lone["beta"])
        assert torch.equal(st["w"][t], lone["w"])
        assert torch.equal(st["wb"][t:t + 1], lone["wb"])
    seg = slice(off[2], off[3])
    assert torch.equal(st["beta"][seg], before["beta"][seg])
    assert torch.equal(st["w"][2], before["w"][2])


def test_task_epoch_checks_its_operands():
    rng, phi = _shared(20, 4)
    st = dict(rows=torch.arange(6), offsets=torch.tensor([0, 4, 6]),
              y=torch.ones(6), p=-torch.ones(6), lo=torch.zeros(6),
              hi=torch.ones(6), q_diag=torch.ones(6),
              live=torch.ones(6, dtype=torch.bool),
              perm=torch.tensor([0, 1, 2, 3, 0, 1]), beta=torch.zeros(6),
              w=torch.zeros((2, 4)), wb=torch.zeros(2))
    phit, tasks = tt(phi), torch.tensor([0, 1])
    ops.dcd_epoch_tasks(phit, **st, tasks=tasks, bias=1.0)
    for name, bad, match in (
            ("w", torch.zeros((3, 4)), "w must be"),
            ("wb", torch.zeros((2, 1)), "wb must be"),
            ("live", torch.ones(6), "live must be"),
            ("perm", torch.zeros(6, dtype=torch.int32), "perm must be"),
            ("offsets", torch.tensor([0]), "offsets must be")):
        with pytest.raises(ValueError, match=match):
            ops.dcd_epoch_tasks(phit, **{**st, name: bad}, tasks=tasks,
                                bias=1.0)
    with pytest.raises(ValueError, match="tasks must be"):
        ops.dcd_epoch_tasks(phit, **st, tasks=tasks.float(), bias=1.0)


# --------------------------------------------------------- batched solve
@pytest.mark.parametrize("sizes,tol", [([120, 1, 77, 200], 1e-3),
                                       ([60, 61], 1e-4), ([33], 1e-3)])
def test_each_task_equals_its_lone_linear_svc(sizes, tol):
    rng, phi = _shared(300, 24, seed=len(sizes))
    rows, ys = _tasks(rng, phi, sizes)
    cfg = TL.DCDConfig(tol=tol)
    batch = TL.linear_svc_tasks(tt(phi), [torch.from_numpy(r) for r in rows],
                                [tt(y) for y in ys], cfg=cfg)
    assert len(batch) == len(sizes)
    for t, (r, y) in enumerate(zip(rows, ys)):
        lone = TL.linear_svc(tt(phi[r]), tt(y), cfg=cfg)
        _assert_same(batch[t], lone, t)
        assert bool(batch[t].converged)
        assert _certificate(phi[r], y, np_(batch[t].alpha)) <= tol


def test_masked_and_warm_started_tasks_equal_lone_solves():
    """Per-task masks and warm starts (one from its optimum, which stops
    long before the others and stays frozen while they sweep on)."""
    rng, phi = _shared(280, 20, seed=5)
    rows, ys = _tasks(rng, phi, [90, 140, 70])
    masks = [rng.random(len(r)) < 0.8 for r in rows]
    cfg = TL.DCDConfig(tol=1e-4)
    optimum = TL.linear_svc(tt(phi[rows[2]]), tt(ys[2]), cfg=cfg,
                            mask=torch.from_numpy(masks[2])).alpha
    alpha0 = [None, tt(rng.uniform(0, 1, len(rows[1]))), optimum]
    batch = TL.linear_svc_tasks(
        tt(phi), rows, [tt(y) for y in ys], cfg=cfg,
        masks=[torch.from_numpy(m) for m in masks], alpha0=alpha0)
    iters = [int(r.n_iter) for r in batch]
    assert iters[2] <= 2 < min(iters[0], iters[1])
    for t in range(3):
        lone = TL.linear_svc(tt(phi[rows[t]]), tt(ys[t]), cfg=cfg,
                             mask=torch.from_numpy(masks[t]),
                             alpha0=alpha0[t])
        _assert_same(batch[t], lone, t)
        assert np.all(np_(batch[t].alpha)[~masks[t]] == 0.0)
    # the same task alone in the batched solve: the other tasks change
    # nothing
    alone = TL.linear_svc_tasks(tt(phi), rows[1:2], [tt(ys[1])], cfg=cfg,
                                masks=[torch.from_numpy(masks[1])],
                                alpha0=alpha0[1:2])[0]
    _assert_same(batch[1], alone, "alone")


def test_max_epochs_freezes_each_task():
    rng, phi = _shared(200, 16, seed=9)
    rows, ys = _tasks(rng, phi, [80, 3, 110])
    cfg = TL.DCDConfig(max_epochs=2)
    batch = TL.linear_svc_tasks(tt(phi), rows, [tt(y) for y in ys], cfg=cfg)
    for t in range(3):
        lone = TL.linear_svc(tt(phi[rows[t]]), tt(ys[t]), cfg=cfg)
        _assert_same(batch[t], lone, t)
        assert int(batch[t].n_iter) <= 2
    zero = TL.linear_svc_tasks(tt(phi), rows, [tt(y) for y in ys],
                               cfg=TL.DCDConfig(max_epochs=0))
    assert all(int(r.n_iter) == 0 and not bool(r.converged) for r in zero)


def test_dcd_qp_tasks_general_box_equals_lone_dcd_qp():
    """The general form: a box and linear term other than the hinge's,
    shared by two tasks, and an SVR-like doubled task (per-coordinate
    signs and p, rows used twice) swept through row indices; each task
    equals its lone dcd_qp, which sweeps its gathered Phi whole."""
    rng, phi = _shared(150, 12, seed=3)
    r0, r1 = np.arange(40), np.arange(60, 130)
    y0, y1 = _labels(rng, phi, r0), _labels(rng, phi, r1)
    cfg = TL.DCDConfig(tol=1e-3)
    batch = TL.dcd_qp_tasks(tt(phi), [r0, r1], [tt(y0), tt(y1)], -0.5,
                            0.0, 0.5, cfg=cfg)
    for t, (r, y) in enumerate(((r0, y0), (r1, y1))):
        lone = TL.dcd_qp(tt(phi[r]), tt(y), -0.5, 0.0, 0.5, cfg=cfg)
        _assert_same(batch[t], lone, t)
    r2 = np.r_[np.arange(50, 90), np.arange(50, 90)]   # rows used twice
    s2 = np.r_[np.ones(40), -np.ones(40)].astype(np.float32)
    t2 = rng.normal(size=40).astype(np.float32)
    p2 = np.r_[0.1 - t2, 0.1 + t2].astype(np.float32)
    (doubled,) = TL.dcd_qp_tasks(tt(phi), [r2], [tt(s2)], tt(p2), 0.0, 0.5,
                                 cfg=cfg)
    lone = TL.dcd_qp(tt(phi[r2]), tt(s2), tt(p2), 0.0, 0.5, cfg=cfg)
    _assert_same(doubled, lone, 2)
    assert int(lone.n_iter) > 1


def test_batched_solve_meets_the_reference_at_the_optimum():
    """Each task against the JAX reference's linear_svc on its rows: the
    two draw different permutations, so they meet at the optimum."""
    rng, phi = _shared(320, 24, seed=11)
    rows, ys = _tasks(rng, phi, [150, 90, 200])
    tol = 1e-3
    batch = TL.linear_svc_tasks(tt(phi), rows, [tt(y) for y in ys],
                                cfg=TL.DCDConfig(tol=tol))
    for t, (r, y) in enumerate(zip(rows, ys)):
        ref = JL.linear_svc(jnp.asarray(phi[r]), jnp.asarray(y),
                            cfg=JL.DCDConfig(tol=tol))
        assert bool(ref.converged) and bool(batch[t].converged)
        for a in (np_(ref.alpha), np_(batch[t].alpha)):
            assert _certificate(phi[r], y, a) <= tol
        np.testing.assert_allclose(np_(batch[t].w), np_(ref.w), rtol=0,
                                   atol=5 * tol)
        assert float(batch[t].b) == pytest.approx(float(ref.b), abs=5 * tol)


# -------------------------------------------------------- multiclass fit
@pytest.mark.parametrize("strategy", ["ovo", "ovr"])
def test_multiclass_lowrank_fit_is_one_batched_solve(strategy, monkeypatch):
    """SVC(engine="rff") fits every task in one batched solve: one task
    epoch launch a round, each task equal to its lone linear_svc on its
    rows of the shared map."""
    x, y = load_pavia_like(n_per_class=24, n_classes=4, seed=7)
    xtr, ytr, _, _ = train_test_split(normalize(x), y, test_frac=0.2,
                                      seed=7)
    calls = []
    real = ops.dcd_epoch_tasks

    def spy(*args, **kw):
        calls.append(int(kw["tasks"].shape[0]))
        return real(*args, **kw)

    monkeypatch.setattr(ops, "dcd_epoch_tasks", spy)
    clf = TSVC(strategy=strategy, engine="rff", rank=32, device="cpu").fit(
        xtr, ytr)
    n_tasks = clf._taskset.n_tasks
    assert calls[0] == n_tasks and max(calls) == n_tasks
    assert len(calls) == int(clf.task_n_iter_.max())
    phi = clf._feature_map.transform(tt(xtr))
    for t, task in enumerate(clf._taskset.tasks):
        lone = TL.linear_svc(phi[torch.from_numpy(task.indices)],
                             tt(task.y), cfg=clf.dcd_cfg)
        assert np.array_equal(clf._task_alpha[t], np_(lone.alpha))
        assert np.array_equal(clf.task_w_[t], np_(lone.w))
        assert clf.task_n_iter_[t] == int(lone.n_iter)
    assert clf.converged_


# ------------------------------------------------------------ launch plan
@pytest.mark.parametrize("k", [1, 4, 37, 1024, 1025, 4096, 9000, 19000,
                               20000, ops.DCD_MAX_RANK])
def test_dcd_plan_fits_shared_memory(k):
    plan = DCD.dcd_plan(k)
    if plan.route == "ring":
        assert plan.window in DCD.WINDOWS and plan.window <= DCD.WINDOW
        assert plan.depth % plan.window == 0
        assert 2 * plan.window <= plan.depth <= DCD.MAX_DEPTH
        assert plan.smem_bytes == DCD.ring_smem(k, plan.window, plan.depth)
        assert plan.smem_bytes <= DCD.SMEM_MAX
        # one more window of slots would not fit
        more = DCD.ring_smem(k, plan.window, plan.depth + plan.window)
        assert more > DCD.SMEM_MAX or plan.depth + plan.window > \
            DCD.MAX_DEPTH
    else:
        assert plan == DCD.DCDPlan("direct", 0, 0, 4 * k)
        assert DCD.ring_smem(k, 1, 2) > DCD.SMEM_MAX
    assert (plan.route == "ring") == (k < 20000)


def test_dcd_plan_windows_and_depths():
    """The tier's rank takes the full window and a deep ring; a larger
    rank a smaller window; every window the kernel instantiates can be
    asked for."""
    assert DCD.dcd_plan(1024) == DCD.DCDPlan(
        "ring", DCD.WINDOW, 48, DCD.ring_smem(1024, DCD.WINDOW, 48))
    assert DCD.dcd_plan(4096).window == 4 and DCD.dcd_plan(9000).window == 2
    for w in DCD.WINDOWS:
        assert DCD.dcd_plan(1024, window=w).window == w
    assert DCD.dcd_plan(1024, depth=16).depth == 16


def test_svm_module_uses_the_batched_solve():
    assert "linear_svc_tasks" in tsvm.SVC._fit_multiclass_lowrank.__code__\
        .co_names
