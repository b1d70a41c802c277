"""The unshrunk exact SMO certifies the state it returns.

Without shrinking, ``solve_qp`` used to stop on its own float32 gap, so
a float32 f cache that had drifted from the exact gradient (~60k
updates of an exact SVR fit on the H100) returned a state whose
float64 KKT certificate read past tol (ROADMAP C). Now a check whose
gap says converged recomputes f once and stops only if that f
certifies; otherwise the solve goes on from the recomputed f.

The drift is built on purpose here: an engine whose rows carry a fixed
relative error of up to 1e-2 while its matvec stays exact, so the
cached f and the recomputed f part. The parent's solver returned such
states with certificates of ~1e-2 against tol 1e-3. Where the cached
f is exact, the solver stops at the first converged check after one
matvec, on the state the reference returns
(``tests/test_torch_smo.py::test_smo_matches_reference_on_same_gram``).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import kernel_engine as KE
from repro_torch.core import kernels as K
from repro_torch.core import smo
from repro_torch.data import make_blobs, normalize
from torch_helpers import tt

TOL = 1e-3


class DriftEngine(KE.DenseKernelEngine):
    """Exact Gram and matvec; rows scaled column-wise by (1 + err)."""

    def __init__(self, x, kernel, err):
        super().__init__(x, kernel)
        self.err = err
        self.matvecs = 0

    def row(self, i, cache=None):
        return KE.take(self.gram, i) * (1.0 + self.err), cache

    def matvec(self, v):
        self.matvecs += 1
        return super().matvec(v)


def _problem(n_per=150, seed=1):
    x, yl = make_blobs(n_per, 2, 5, sep=0.8, seed=seed)
    return tt(normalize(x)), tt(np.where(yl == 0, 1.0, -1.0))


def _exact_certificate(eng, r, y, C, mask=None):
    f = eng.gram @ (r.alpha * y) - y
    return float(smo.kkt_violation(r.alpha, y, f, 0.0, C, mask=mask))


@pytest.mark.parametrize("C", [1.0, 10.0])
@pytest.mark.parametrize("scale", [1e-3, 1e-2, 3e-2])
def test_drifted_f_cache_does_not_stop_until_certified(C, scale):
    x, y = _problem()
    kp = K.KernelParams(gamma=0.5)
    rng = np.random.default_rng(0)
    eng = DriftEngine(x, kp, tt(rng.uniform(-scale, scale, len(y))))
    r = smo.binary_smo(x, y, cfg=smo.SMOConfig(C=C, tol=TOL), kernel=kp,
                       engine=eng)
    assert bool(r.converged)
    assert _exact_certificate(eng, r, y, C) <= TOL
    assert eng.matvecs >= 2        # a first check did not certify
    # once per converged check, not once an iteration
    assert eng.matvecs <= int(r.n_iter) // 32 + 1


def test_drifted_masked_solve_certifies_on_the_valid_entries():
    x, y = _problem(seed=4)
    mask = torch.ones(len(y), dtype=torch.bool)
    mask[::7] = False
    kp = K.KernelParams(gamma=0.5)
    rng = np.random.default_rng(2)
    eng = DriftEngine(x, kp, tt(rng.uniform(-1e-2, 1e-2, len(y))))
    r = smo.binary_smo(x, y, mask, cfg=smo.SMOConfig(C=1.0, tol=TOL),
                       kernel=kp, engine=eng)
    assert bool(r.converged) and not bool(r.alpha[~mask].any())
    assert _exact_certificate(eng, r, y, 1.0, mask) <= TOL


@pytest.mark.parametrize("selection", ["first", "second"])
def test_exact_f_cache_stops_at_the_first_converged_check(selection):
    """With exact rows the recomputed f certifies at once: one matvec,
    and the state of a solve that trusts its float32 gap."""
    x, y = _problem(seed=2)
    kp = K.KernelParams(gamma=0.5)
    eng = DriftEngine(x, kp, torch.zeros(len(y)))
    cfg = smo.SMOConfig(C=1.0, tol=TOL, selection=selection)
    r = smo.binary_smo(x, y, cfg=cfg, kernel=kp, engine=eng)
    assert eng.matvecs == 1
    plain = smo.binary_smo(x, y, cfg=cfg, kernel=kp,
                           engine=KE.DenseKernelEngine(x, kp,
                                                       gram=eng.gram))
    assert torch.equal(r.alpha, plain.alpha)
    assert float(r.b) == float(plain.b)
    assert int(r.n_iter) == int(plain.n_iter)
    assert _exact_certificate(eng, r, y, 1.0) <= TOL


def test_svr_unshrunk_fit_certifies_with_drifted_rows():
    """The doubled-variable SVR QP through ``solve_qp`` directly."""
    rng = np.random.default_rng(5)
    x = tt(rng.uniform(-3, 3, size=(120, 2)))
    t = torch.sinc(x[:, 0]) + 0.05 * tt(rng.normal(size=120))
    xx = torch.cat([x, x])
    s = torch.cat([torch.ones(120), -torch.ones(120)])
    p = torch.cat([0.1 - t, 0.1 + t])
    kp = K.KernelParams(gamma=0.5)
    eng = DriftEngine(xx, kp, tt(rng.uniform(-1e-2, 1e-2, 240)))
    r = smo.solve_qp(xx, s, p, 0.0, 1.0, cfg=smo.SMOConfig(C=1.0, tol=TOL),
                     kernel=kp, engine=eng)
    f = eng.gram @ (r.alpha * s) + s * p
    assert bool(r.converged)
    assert float(smo.kkt_violation(r.alpha, s, f, 0.0, 1.0)) <= TOL


class DriftTaskEngine(KE.TaskKernelEngine):
    """A bucket's engine over exact per-task Grams; rows scaled by
    (1 + err[t]) for task t, as DriftEngine scales a lone task's."""

    def __init__(self, x, kernel, err):
        super().__init__(x, kernel, "dense")
        self.err = err

    def row(self, i, cache=None):
        rows, cache = super().row(i, cache)
        return rows * (1.0 + self.err), cache


def test_bucket_certifies_each_task_as_its_lone_solve():
    """The batched bucket solve certifies each task as solve_qp does, so
    a task whose first converged check fails still ends exactly where it
    would alone (alphas, b, n_iter bit for bit)."""
    rng = np.random.default_rng(3)
    t_n, w = 3, 120
    xs, ys = [], []
    for s in range(t_n):
        x, y = _problem(n_per=w // 2, seed=10 + s)
        xs.append(x)
        ys.append(y)
    x, y = torch.stack(xs), torch.stack(ys)
    kp = K.KernelParams(gamma=0.5)
    err = tt(rng.uniform(-1e-2, 1e-2, (t_n, w)))
    eng = DriftTaskEngine(x, kp, err)
    cfg = smo.SMOConfig(C=1.0, tol=TOL)
    r = smo.binary_smo_tasks(x, y, cfg=cfg, kernel=kp, engine=eng)
    assert bool(r.converged.all())
    recomputed = 0
    for t in range(t_n):
        lone_eng = DriftEngine(x[t], kp, err[t])
        lone = smo.binary_smo(x[t], y[t], cfg=cfg, kernel=kp,
                              engine=lone_eng)
        recomputed += lone_eng.matvecs > 1
        assert torch.equal(lone.alpha, r.alpha[t])
        assert float(lone.b) == float(r.b[t])
        assert int(lone.n_iter) == int(r.n_iter[t])
        assert _exact_certificate(lone_eng, lone, y[t], 1.0) <= TOL
    assert recomputed >= 1
