"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and nvcc, is marked
``requires_cuda``, and skips with a reason elsewhere (a skip counts as
unverified, never as passed). This file imports no JAX, so it runs on
the machine with the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Bounds are the reference's (tests/test_kernels_pallas.py): Gram rtol
2e-5 / atol 2e-6, decisions rtol 2e-4 / atol 2e-5, kkt_select exact.
"""
import numpy as np
import pytest
import torch

from repro_torch import serve
from repro_torch.core import kernels as K
from repro_torch.core import smo
from repro_torch.core.svm import SVC
from repro_torch.data import (load_breast_cancer_like, load_pavia_like,
                              normalize, train_test_split)
from repro_torch.kernels import decision as D
from repro_torch.kernels import kkt_select as KS
from repro_torch.kernels import ops
from repro_torch.kernels import rbf_gram as G
from torch_helpers import cuda, tt  # noqa: F401  (cuda: fixture)

GRAM_TOL = dict(rtol=2e-5, atol=2e-6)
DECISION_TOL = dict(rtol=2e-4, atol=2e-5)

pytestmark = pytest.mark.requires_cuda


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_gram_kernels_match_plain(cuda, dtype):  # noqa: F811
    rng = np.random.default_rng(11)
    dt = ops.tile_dtype(dtype)
    for n, m, d in [(300, 257, 102), (37, 129, 7), (1, 1, 1)]:
        a = tt(rng.normal(size=(n, d)), device=cuda).to(dt)
        b = tt(rng.normal(size=(m, d)), device=cuda).to(dt)
        a2, b2 = K.sqnorms(a), K.sqnorms(b)
        for mode in ("rbf", "linear"):
            got = ops.rbf_gram(a, b, gamma=0.01, mode=mode, a2=a2, b2=b2)
            want = G.rbf_gram_plain(a, b, a2, b2, gamma=0.01, mode=mode)
            tol = GRAM_TOL if mode == "rbf" else dict(rtol=2e-5, atol=1e-4)
            torch.testing.assert_close(got, want, **tol)
        i = torch.tensor(n // 2, device=cuda)
        torch.testing.assert_close(ops.gram_row(a, a2, i, gamma=0.01),
                                   G.gram_row_plain(a, a2, i, gamma=0.01),
                                   **GRAM_TOL)
        rows = torch.zeros((3, n), device=cuda)
        ops.gram_row(a, a2, i, gamma=0.01, out=rows,
                     slot=torch.tensor(2, device=cuda),
                     skip=torch.tensor(True, device=cuda))
        assert not rows.any()                      # a hit writes nothing
        ops.gram_row(a, a2, i, gamma=0.01, out=rows,
                     slot=torch.tensor(2, device=cuda),
                     skip=torch.tensor(False, device=cuda))
        torch.testing.assert_close(rows[2], G.gram_row_plain(
            a, a2, i, gamma=0.01), **GRAM_TOL)


@pytest.mark.parametrize("n", [1, 255, 4099, 100_000])
def test_kkt_select_matches_plain_exactly(cuda, n):  # noqa: F811
    rng = np.random.default_rng(n)
    lo = -rng.uniform(0, 1, n)
    hi = rng.uniform(0, 2, n)
    alpha = np.where(rng.random(n) < 0.3, lo, rng.uniform(lo, hi))
    alpha[rng.random(n) < 0.2] = 0.0
    args = [tt(v, device=cuda) for v in (
        rng.normal(size=n), alpha, np.where(rng.random(n) < .5, 1., -1.))]
    mask = tt(rng.random(n) < 0.9, torch.bool, cuda)
    args = (*args, mask, tt(lo, device=cuda), tt(hi, device=cuda))
    got = [float(v) for v in ops.kkt_select(*args)]
    assert got == [float(v) for v in KS.kkt_select_plain(*args)]
    none = (*args[:3], torch.zeros_like(mask), *args[4:])
    assert [float(v) for v in ops.kkt_select(*none)] == [np.inf, 0, -np.inf, 0]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_decision_kernels_match_plain(cuda, dtype):  # noqa: F811
    rng = np.random.default_rng(5)
    dt = ops.tile_dtype(dtype)
    for t, nt, w, d in [(3, 129, 200, 102), (1, 1, 5, 3), (36, 70, 65, 4)]:
        z = tt(rng.normal(size=(nt, d)), device=cuda)
        sv = tt(rng.normal(size=(t, w, d)), device=cuda)
        cf = tt(rng.normal(size=(t, w)), device=cuda)
        for mode in ("rbf", "linear"):
            got = ops.multitask_decision(z, sv, cf, gamma=0.01, mode=mode,
                                         compute_dtype=dtype)
            want = D.multitask_decision_plain(z.to(dt), sv.to(dt), cf,
                                              gamma=0.01, mode=mode)
            torch.testing.assert_close(got, want, **DECISION_TOL)
        one = ops.multitask_decision(z, sv[:1], cf[:1], gamma=0.01,
                                     compute_dtype=dtype)
        single = ops.decision(z, sv[0], cf[0], gamma=0.01,
                              compute_dtype=dtype)
        assert torch.equal(one[0], single)        # one device function
        torch.testing.assert_close(single, D.decision_plain(
            z.to(dt), sv[0].to(dt), cf[0], gamma=0.01), **DECISION_TOL)


def test_launch_counts_and_no_cpu_fallback(cuda):  # noqa: F811
    ops.reset_launches()
    a = torch.randn(10, 4, device=cuda)
    ops.rbf_gram(a, a)
    ops.decision(a, a, torch.ones(10, device=cuda))
    assert ops.launches["rbf_gram"] == 1 and ops.launches["decision"] == 1
    with pytest.raises(ValueError, match="several devices"):
        ops.rbf_gram(a, a.cpu())


def test_fit_on_card_matches_fit_on_cpu(cuda):  # noqa: F811
    """The kernels drive SMO to the same optimum as the plain versions."""
    x, yl = load_breast_cancer_like(n_samples=260)
    x = normalize(x)
    y = np.where(yl == 1, 1.0, -1.0).astype(np.float32)
    kw = dict(cfg=smo.SMOConfig(C=1.0, shrink_every=4),
              kernel=K.KernelParams(gamma=0.05), engine="pallas")
    rc = smo.binary_smo(tt(x), tt(y), **kw)
    rg = smo.binary_smo(tt(x, device=cuda), tt(y, device=cuda), **kw)
    assert bool(rg.converged)
    np.testing.assert_allclose(rg.alpha.cpu().numpy(), rc.alpha.numpy(),
                               atol=1e-4)
    assert float(rg.b) == pytest.approx(float(rc.b), abs=1e-4)


def test_svc_and_predictor_on_card_match_cpu(cuda, tmp_path):  # noqa: F811
    """Fit on the card and on the CPU, serve the card's fit through a
    saved artifact. The kernels sum in another order than the plain
    versions, so the two SMO runs may take different pair sequences to
    equally certified optima: labels must be equal, decision values
    within 2 tol (the gap at which both stop)."""
    x, y = load_pavia_like(n_per_class=150, n_classes=2, seed=7)
    xtr, ytr, xte, _ = train_test_split(normalize(x), y, test_frac=0.25)
    g = SVC(engine="pallas", device=cuda).fit(xtr, ytr)
    c = SVC(engine="pallas", device="cpu").fit(xtr, ytr)
    np.testing.assert_array_equal(g.support_, c.support_)
    serve.save(tmp_path / "m.npz", serve.pack(g))
    pred = serve.Predictor(serve.load(tmp_path / "m.npz"), engine="pallas",
                           device=cuda).warmup((1, 37))
    np.testing.assert_array_equal(pred.predict(xte), c.predict(xte))
    np.testing.assert_allclose(pred.decision_function(xte),
                               c.decision_function(xte), rtol=0, atol=2e-3)
    np.testing.assert_allclose(pred.decision_function(xte),
                               g.decision_function(xte), **DECISION_TOL)
