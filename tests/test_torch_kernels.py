"""The port's four kernels: each plain PyTorch version against the JAX
Pallas kernel run in interpret mode (as tests/test_kernels_pallas.py
runs it). The CUDA kernels themselves are held against these plain
versions on the card by tests/test_torch_cuda.py and chip_smoke.py.

Tolerances are the reference's own (tests/test_kernels_pallas.py):
Gram rtol 2e-5 / atol 2e-6, decisions rtol 2e-4 / atol 2e-5, and
``kkt_select`` exact (values and indices). bf16 runs both packages on
the same bf16-rounded operands with f32 accumulation, so the same
bounds hold.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import smo as jsmo
from repro.kernels import ops as jops
from repro_torch.core import kernels as TK
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rbf_gram as TG
from torch_helpers import np_, tt

GRAM_TOL = dict(rtol=2e-5, atol=2e-6)
DECISION_TOL = dict(rtol=2e-4, atol=2e-5)
GRAM_SHAPES = [(64, 64, 4), (37, 129, 7), (100, 80, 32), (128, 256, 102),
               (1, 1, 1)]


# ------------------------------------------------------------ rbf_gram
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("n,m,d", GRAM_SHAPES)
def test_rbf_gram_plain_matches_pallas(n, m, d, dtype):
    rng = np.random.default_rng(n * 1000 + m + d)
    a = rng.normal(size=(n, d)).astype(np.float32)
    b = rng.normal(size=(m, d)).astype(np.float32)
    want = jops.rbf_gram(jnp.asarray(a), jnp.asarray(b), gamma=0.37,
                         compute_dtype=dtype, interpret=True)
    got = tops.rbf_gram(tt(a), tt(b), gamma=0.37, compute_dtype=dtype)
    np.testing.assert_allclose(np_(got), np_(want), **GRAM_TOL)


@pytest.mark.parametrize("n,m,d", [(64, 64, 16), (200, 100, 102)])
def test_linear_gram_plain_matches_pallas(n, m, d):
    rng = np.random.default_rng(n + m + d)
    a = rng.normal(size=(n, d)).astype(np.float32)
    b = rng.normal(size=(m, d)).astype(np.float32)
    want = jops.rbf_gram(jnp.asarray(a), jnp.asarray(b), mode="linear",
                         interpret=True)
    got = tops.rbf_gram(tt(a), tt(b), mode="linear")
    np.testing.assert_allclose(np_(got), np_(want), rtol=2e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("n,d", [(300, 102), (77, 4), (129, 33)])
def test_gram_row_plain_matches_pallas(n, d, dtype):
    rng = np.random.default_rng(n + d)
    x = rng.normal(size=(n, d)).astype(np.float32)
    row_fn = jops.gram_row_fn(gamma=0.05, compute_dtype=dtype,
                              interpret=True)
    xk = tt(x).to(tops.tile_dtype(dtype))
    x2 = TK.sqnorms(xk)
    for i in (0, n // 2, n - 1):
        want = row_fn(jnp.asarray(x), jnp.asarray(x[i]))
        got = tops.gram_row(xk, x2, torch.tensor(i), gamma=0.05)
        np.testing.assert_allclose(np_(got), np_(want), **GRAM_TOL)


def test_gram_row_cache_store_writes_slot_unless_hit():
    """The cached row entry (plain path here): a miss writes the row into
    the LRU victim's slot, a hit returns the slot's row and leaves the
    slot as is; keys, stamps, clock and counts move as the lookup says."""
    rng = np.random.default_rng(3)
    x = tt(rng.normal(size=(50, 6)))
    x2 = TK.sqnorms(x)
    keys, stamp = torch.tensor([4, -1, 9]), torch.tensor([3, 0, 5])
    rows = torch.zeros((3, 50))
    rows[2] = 1.0                             # what slot 2 holds for row 9
    clock, hits, misses = torch.tensor(5), torch.tensor(0), torch.tensor(0)
    state = (keys, stamp, rows, clock, hits, misses)
    want = TG.gram_row_plain(x, x2, torch.tensor(7), gamma=0.5)
    got = tops.gram_row_cached(x, x2, torch.tensor(7), *state, gamma=0.5)
    assert torch.equal(got, want)
    assert torch.equal(rows[1], want)         # the least stamp's slot
    assert keys.tolist() == [4, 7, 9] and stamp.tolist() == [3, 6, 5]
    assert (int(clock), int(hits), int(misses)) == (6, 0, 1)
    got = tops.gram_row_cached(x, x2, torch.tensor(9), *state, gamma=0.5)
    assert bool((got == 1.0).all()) and bool((rows[2] == 1.0).all())
    assert torch.equal(rows[1], want) and not rows[0].any()
    assert stamp.tolist() == [3, 6, 7]
    assert (int(clock), int(hits), int(misses)) == (7, 1, 1)
    got[0] = 5.0                              # a copy, not the slot
    assert float(rows[2, 0]) == 1.0


# ---------------------------------------------------------- kkt_select
def _kkt_inputs(n, seed):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(n,)).astype(np.float32)
    alpha = rng.uniform(0, 1, size=(n,)).astype(np.float32)
    alpha[rng.random(n) < 0.3] = 0.0
    alpha[rng.random(n) < 0.2] = 1.0
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    mask = rng.random(n) < 0.9
    return f, alpha, y, mask


def _scalars(sel):
    return (float(sel[0]), int(sel[1]), float(sel[2]), int(sel[3]))


@pytest.mark.parametrize("n", [64, 500, 1024, 4096])
def test_kkt_select_plain_matches_pallas_exactly(n):
    f, alpha, y, mask = _kkt_inputs(n, n)
    c = 1.0
    want = jops.kkt_select(jnp.asarray(f), jnp.asarray(alpha),
                           jnp.asarray(y), jnp.asarray(mask), c=c,
                           interpret=True)
    # the port's per-sample box at lo = 0, hi = C is the Pallas [0, C]
    got = tops.kkt_select(tt(f), tt(alpha), tt(y), tt(mask, torch.bool),
                          torch.zeros(n), torch.full((n,), c))
    assert _scalars(got) == _scalars(want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kkt_select_per_sample_box_matches_reference_selection(seed):
    n = 700
    rng = np.random.default_rng(seed)
    lo = -rng.uniform(0, 2, size=n).astype(np.float32)
    hi = rng.uniform(0, 2, size=n).astype(np.float32)
    alpha = rng.uniform(lo, hi).astype(np.float32)
    alpha[rng.random(n) < 0.3] = 0.0
    pin = rng.random(n) < 0.3
    alpha[pin] = np.where(rng.random(pin.sum()) < 0.5, lo[pin], hi[pin])
    f = rng.normal(size=n).astype(np.float32)
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    mask = rng.random(n) < 0.9
    want = jsmo._selection(*map(jnp.asarray, (f, alpha, y, mask, lo, hi)))
    got = tops.kkt_select(tt(f), tt(alpha), tt(y), tt(mask, torch.bool),
                          tt(lo), tt(hi))
    assert _scalars(got) == _scalars(want)


def test_kkt_select_all_masked_and_ties():
    n = 2048
    zeros, ones = torch.zeros(n), torch.ones(n)
    got = tops.kkt_select(zeros, zeros, ones, torch.zeros(n, dtype=bool),
                          zeros, ones)
    assert _scalars(got) == (np.inf, 0, -np.inf, 0)
    want = jops.kkt_select(jnp.zeros(n), jnp.zeros(n), jnp.ones(n),
                           jnp.zeros(n, bool), c=1.0, interpret=True)
    assert _scalars(got) == _scalars(want)
    # a tie across tiles resolves to the lowest index, as jnp.argmin
    f = np.zeros(n, np.float32)
    f[[1500, 300, 1999]] = -2.0
    f[[40, 1700]] = 3.0
    alpha = np.full(n, 0.5, np.float32)
    y = np.ones(n, np.float32)
    got = tops.kkt_select(tt(f), tt(alpha), tt(y), torch.ones(n, dtype=bool),
                          zeros, ones)
    assert _scalars(got) == (-2.0, 300, 3.0, 40)


# ------------------------------------------------------------ decision
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("nt,n,d", [(64, 64, 4), (200, 333, 102),
                                    (13, 1000, 32)])
def test_decision_plain_matches_pallas(nt, n, d, dtype):
    rng = np.random.default_rng(nt + n + d)
    xt = rng.normal(size=(nt, d)).astype(np.float32)
    xr = rng.normal(size=(n, d)).astype(np.float32)
    coef = rng.normal(size=(n,)).astype(np.float32)
    want = jops.decision(jnp.asarray(xt), jnp.asarray(xr),
                         jnp.asarray(coef), 0.73, gamma=0.21,
                         compute_dtype=dtype, interpret=True)
    got = tops.decision(tt(xt), tt(xr), tt(coef), 0.73, gamma=0.21,
                        compute_dtype=dtype)
    np.testing.assert_allclose(np_(got), np_(want), **DECISION_TOL)


@pytest.mark.parametrize("mode", ["rbf", "linear"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("t,nt,w,d", [(3, 50, 40, 4), (2, 129, 130, 102),
                                      (1, 7, 9, 13)])
def test_multitask_decision_plain_matches_pallas(t, nt, w, d, dtype, mode):
    rng = np.random.default_rng(t * 7 + nt + w + d)
    z = rng.normal(size=(nt, d)).astype(np.float32)
    sv = rng.normal(size=(t, w, d)).astype(np.float32)
    coef = rng.normal(size=(t, w)).astype(np.float32)
    b = rng.normal(size=(t,)).astype(np.float32)
    want = jops.multitask_decision(jnp.asarray(z), jnp.asarray(sv),
                                   jnp.asarray(coef), jnp.asarray(b),
                                   gamma=0.05, mode=mode,
                                   compute_dtype=dtype, interpret=True)
    got = tops.multitask_decision(tt(z), tt(sv), tt(coef), tt(b), gamma=0.05,
                                  mode=mode, compute_dtype=dtype)
    np.testing.assert_allclose(np_(got), np_(want), **DECISION_TOL)


def test_multitask_decision_empty_bank_is_bias():
    b = torch.tensor([0.5, -1.0])
    out = tops.multitask_decision(torch.zeros((5, 3)), torch.zeros((2, 0, 3)),
                                  torch.zeros((2, 0)), b)
    assert torch.equal(out, b[:, None].expand(2, 5))


# ------------------------------------------------------------ wrappers
def test_wrappers_check_inputs_and_count_no_cpu_launches():
    tops.reset_launches()
    a = torch.zeros((4, 3))
    with pytest.raises(ValueError):
        tops.rbf_gram(a, torch.zeros((4, 5)))
    with pytest.raises(ValueError):
        tops.kkt_select(torch.zeros(4), torch.zeros(4), torch.ones(4),
                        torch.ones(4), torch.zeros(4), torch.ones(4))
    with pytest.raises(ValueError):
        tops.rbf_gram(a, a, mode="poly")
    with pytest.raises(ValueError):
        tops.multitask_decision(torch.zeros((2, 3)), torch.zeros((1, 4, 3)),
                                torch.zeros((1, 5)))
    tops.rbf_gram(a, a)
    tops.decision(a, a, torch.zeros(4))
    assert all(v == 0 for v in tops.launches.values())  # plain path on CPU
