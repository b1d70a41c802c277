"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and nvcc, is marked
``requires_cuda``, and skips with a reason elsewhere (a skip counts as
unverified, never as passed). This file imports no JAX, so it runs on
the machine with the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Bounds are the reference's (tests/test_kernels_pallas.py): Gram rtol
2e-5 / atol 2e-6, decisions rtol 2e-4 / atol 2e-5, kkt_select exact;
the Gram matvec (``ops.gram_matvec``, which never writes K) against a
float64 sum over the same rounded operands, GRAM_TOL on each term of a
row's sum, summed: |got - Kv| <= 2e-5 sum |K v| + 2e-6 sum |v|;
rff_features atol 1e-5 against its plain version on the same operands
(bfloat16 operands are rounded before both, and both accumulate in
float32), and 5e-2 for the bfloat16 map against the float32 one
(tests/test_approx.py). ``dcd_epoch`` reduces each dot product in
another order than its plain version, so one epoch from the same state
agrees to rtol 1e-4 (atol 1e-4 of the largest entry) in w and beta and
to 1e-5 in the epoch's max projected gradient.

The task axis (one launch for a multiclass bucket) of the row, matvec
and selection kernels gives each task exactly what a T = 1 launch gives it,
so a bucket's batched SMO equals each task's lone solve bit for bit, and
so does a bucket's batched GD (its sums accumulate in float64). The
GD loop on the card follows the CPU's to rtol 1e-4 / atol 1e-4 at a
stable step; cascades certify at 1e-3 on the card, and one shard is the
unsharded fit bit for bit.
``flash_attention`` and ``ssd_diag`` hold rtol 2e-4 / atol 2e-5 against
their plain versions on the same operands (bfloat16 ones rounded before
both; the kernel's float32 output for that check, its bfloat16 output
equal to that float32 output rounded once), also with Sq != Sk, at
d = 8 and 72 in bfloat16, at N = 20 and 256 and Q = 300; their bits
depend on the inputs alone (two launches, both query tiles of
``flash_plan``, grouped kv heads against repeated ones, and each head of
an ``ssd_diag`` group against a one-head call).
"""
import numpy as np
import pytest
import torch

from repro_torch import serve
from repro_torch.core import kernels as K
from repro_torch.core import dist, gd, linear, smo
from repro_torch.core import multiclass as MC
from repro_torch.core.svm import SVC, SVR
from repro_torch.data import (load_breast_cancer_like, load_pavia_like,
                              make_synth_regression, normalize,
                              train_test_split)
from repro_torch.kernels import _build
from repro_torch.kernels import dcd as DCD
from repro_torch.kernels import decision as D
from repro_torch.kernels import feature_map as FM
from repro_torch.kernels import flash_attn as FA
from repro_torch.kernels import kkt_select as KS
from repro_torch.kernels import ops
from repro_torch.kernels import rbf_gram as G
from repro_torch.kernels import ssd_diag as SD
from repro_torch.kernels.tile_f32 import current_stream
from torch_helpers import cuda, tt  # noqa: F401  (cuda: fixture)

GRAM_TOL = dict(rtol=2e-5, atol=2e-6)
DECISION_TOL = dict(rtol=2e-4, atol=2e-5)
RFF_TOL = dict(rtol=0, atol=1e-5)
RFF_BF16_VS_FP32_TOL = dict(rtol=0, atol=5e-2)
LM_TOL = dict(rtol=2e-4, atol=2e-5)        # tests/test_kernels_pallas.py

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
        # the cached entry: a miss fills the victim slot, a hit reads it
        z64 = torch.zeros((), dtype=torch.int64, device=cuda)
        state = (torch.tensor([5, -1, 7], device=cuda),
                 torch.tensor([2, 0, 1], device=cuda),
                 torch.zeros((3, n), device=cuda), z64 + 2, z64.clone(),
                 z64.clone())
        row = ops.gram_row_cached(a, a2, i, *state, gamma=0.01)
        torch.testing.assert_close(row, G.gram_row_plain(
            a, a2, i, gamma=0.01), **GRAM_TOL)
        assert torch.equal(state[2][1], row) and not state[2][0].any()
        state[2][1] = 1.0
        again = ops.gram_row_cached(a, a2, i, *state, gamma=0.01)
        assert bool((again == 1.0).all())          # a hit reads the slot
        assert state[0].tolist() == [5, i.item(), 7]
        assert state[1].tolist() == [2, 4, 1]
        assert [int(v) for v in state[3:]] == [4, 1, 1]


# ------------------------------------------- the block route (tensor cores)
GRAM_SHAPES_TC = [(300, 257, 102), (37, 129, 7), (1, 1, 1), (2048, 4099, 102),
                  (129, 300, 300), (65, 33, 2)]


def _operands(rng, dev, dt, *shapes):
    out = []
    for shape in shapes:
        t = tt(rng.normal(size=shape), device=dev).to(dt)
        out += [t, K.sqnorms(t)]
    return out


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("n,m,d", GRAM_SHAPES_TC)
def test_gram_block_entry_matches_plain(cuda, dtype, n, m, d):  # noqa: F811
    """The block entry (3xTF32 / bf16 tensor cores) against its plain
    version: GRAM_TOL in rbf mode, atol 1e-4 in linear mode (dots of
    size ~sqrt(d), as test_gram_kernels_match_plain); ragged tiles, a
    depth past one staged chunk (d = 300), bf16 rows of odd d (loads,
    not copies) and a view one row into its matrix."""
    rng = np.random.default_rng(n + m + d)
    dt = ops.tile_dtype(dtype)
    a, a2, b, b2 = _operands(rng, cuda, dt, (n + 1, d), (m, d))
    for lhs, lhs2 in ((a[:n], a2[:n]), (a[1:], a2[1:])):
        for mode in ("rbf", "linear"):
            got = ops.rbf_gram(lhs, b, gamma=0.01, mode=mode, a2=lhs2, b2=b2)
            want = G.rbf_gram_plain(lhs, b, lhs2, b2, gamma=0.01, mode=mode)
            tol = GRAM_TOL if mode == "rbf" else dict(rtol=2e-5, atol=1e-4)
            torch.testing.assert_close(got, want, **tol)


def _matvec_f64(x, v, gamma, mode):
    """K(X, X) v and |K| |v| in float64 from the rounded operands."""
    x, v = x.double(), v.double()
    dot = x @ x.T
    if mode == "rbf":
        x2 = (x * x).sum(1)
        k = torch.exp(-gamma * torch.clamp_min(x2[:, None] + x2[None, :]
                                               - 2.0 * dot, 0.0))
    else:
        k = dot
    return k @ v, k.abs() @ v.abs()


def matvec_ok(got, x, v, gamma, mode):
    """|got - K v| <= 2e-5 sum_c |K_rc v_c| + 2e-6 sum_c |v_c| per row:
    GRAM_TOL on each term of the row's sum, summed."""
    want, mag = _matvec_f64(x, v, gamma, mode)
    bound = 2e-5 * mag + 2e-6 * v.double().abs().sum()
    err = (got.double() - want).abs()
    return bool((err <= bound).all()), float((err / bound).max())


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("mode", ["rbf", "linear"])
@pytest.mark.parametrize("n,d", [(1, 7), (255, 102), (4099, 102), (300, 3),
                                 (700, 300)])
def test_gram_matvec_matches_float64(cuda, dtype, mode, n, d):  # noqa: F811
    rng = np.random.default_rng(n * 7 + d)
    x = tt(rng.normal(size=(n, d)), device=cuda).to(ops.tile_dtype(dtype))
    x2 = K.sqnorms(x)
    v = tt(rng.normal(size=n), device=cuda)
    got = ops.gram_matvec(x, x2, v, gamma=0.01, mode=mode)
    ok, worst = matvec_ok(got, x, v, 0.01, mode)
    assert ok, worst


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_gram_matvec_task_axis_equals_lone_calls(cuda, dtype):  # noqa: F811
    """One task-axis launch over a ragged bucket (zero rows past each
    task, v 0 there) gives each task its lone call's bits, and holds the
    float64 bound on each task's own rows."""
    rng = np.random.default_rng(31)
    for widths, w, d in [((300, 17, 256), 300, 102), ((5,), 5, 3),
                         ((4000, 3999, 1, 2500), 4000, 7)]:
        x, _, mask = _ragged_bucket(rng, widths, w, d, cuda)
        xk = x.to(ops.tile_dtype(dtype))
        x2 = K.sqnorms(xk)
        v = tt(rng.normal(size=(len(widths), w)), device=cuda) * mask
        got = ops.gram_matvec(xk, x2, v, gamma=0.01)
        for t, k in enumerate(widths):
            assert torch.equal(got[t], ops.gram_matvec(xk[t], x2[t], v[t],
                                                       gamma=0.01))
            ok, worst = matvec_ok(got[t, :k], xk[t, :k], v[t, :k], 0.01,
                                  "rbf")
            assert ok, (t, worst)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("n,d", [(4099, 102), (300, 300), (77, 7)])
def test_gram_matvec_bits_do_not_depend_on_plan(cuda, dtype, n, d):  # noqa: F811
    """Every row tile the route takes (32, 64, 128 rows on mma.sync; the
    float32 wgmma route takes 128) gives the same bits: a row's sum
    order is fixed by n alone."""
    rng = np.random.default_rng(n + d)
    x = tt(rng.normal(size=(n, d)), device=cuda).to(ops.tile_dtype(dtype))
    x2 = K.sqnorms(x)
    v = tt(rng.normal(size=n), device=cuda)
    want = ops.gram_matvec(x, x2, v, gamma=0.01)
    lib, xs = _build.library(), G.staged(x)
    for rows in G.route_rows(d, x.dtype, "matvec"):
        plan = G.gram_plan(n, n, d, x.dtype, entry="matvec", rows=rows)
        out = torch.empty_like(want)
        assert G.launch_matvec(lib, xs, x2, v, out, gamma=0.01, mode="rbf",
                               plan=plan) == 0
        assert torch.equal(out, want), rows


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_gram_route_reads_nothing_past_d(cuda, dtype):  # noqa: F811
    """Rows that are a view into a wider matrix (16-byte strides, other
    data past d), with and without the task axis, give the bits of the
    same rows copied out (which the wrappers pad): the block route copies
    whole padded rows but zeroes every word past d as it loads it."""
    rng = np.random.default_rng(3)
    dt = ops.tile_dtype(dtype)
    for d in (102, 7, 300):
        width = -(-(d + 29) // 8) * 8
        wide = tt(rng.normal(size=(2, 700, width)), device=cuda).to(dt)
        x, xc = wide[..., :d], wide[..., :d].contiguous()
        x2 = K.sqnorms(xc)
        v = tt(rng.normal(size=(2, 700)), device=cuda)
        assert torch.equal(ops.gram_matvec(x, x2, v, gamma=0.01),
                           ops.gram_matvec(xc, x2, v, gamma=0.01))
        assert torch.equal(ops.gram_matvec(x[1], x2[1], v[1], gamma=0.01),
                           ops.gram_matvec(xc[1], x2[1], v[1], gamma=0.01))
        for mode in ("rbf", "linear"):
            assert torch.equal(
                ops.rbf_gram(x[0, :300], x[1], gamma=0.01, mode=mode,
                             a2=x2[0, :300], b2=x2[1]),
                ops.rbf_gram(xc[0, :300], xc[1], gamma=0.01, mode=mode,
                             a2=x2[0, :300], b2=x2[1]))


def test_gram_matvec_is_one_kernel(cuda):  # noqa: F811
    """Under the profiler: one device kernel a matvec, for T = 1, for a
    bucket and through both engines; the launch counted once each."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import kernel_engine as KE
    rng = np.random.default_rng(5)
    x = tt(rng.normal(size=(4099, 102)), device=cuda)
    xb = tt(rng.normal(size=(6, 1000, 102)), device=cuda)
    v, vb = torch.ones(4099, device=cuda), torch.ones((6, 1000), device=cuda)
    kp = K.KernelParams(gamma=0.01)
    eng = KE.make_engine(x, kp, "pallas")
    teng = KE.TaskKernelEngine(xb, kp, "pallas")
    calls = [lambda: eng.matvec(v), lambda: teng.matvec(vb)]
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    ops.reset_launches()
    best = 0
    for _ in range(3):   # the profiler can drop records, never add them
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                for fn in calls:
                    fn()
            torch.cuda.synchronize()
        best = max(best, sum(e.count for e in prof.key_averages()
                             if e.device_type
                             == torch.autograd.DeviceType.CUDA))
    assert best == 20, best
    assert ops.launches["rbf_gram_matvec"] == 60
    assert ops.launches["rbf_gram"] == 0


def test_engine_matvecs_on_card(cuda):  # noqa: F811
    """The pallas engine's matvec and the bucket engine's, against the
    float64 bound, and each bucket task equal to its lone engine's."""
    from repro_torch.core import kernel_engine as KE
    rng = np.random.default_rng(13)
    kp = K.KernelParams(gamma=0.02)
    for dtype in ("fp32", "bf16"):
        cfg = KE.EngineConfig(backend="pallas", gram_dtype=dtype)
        x = tt(rng.normal(size=(2500, 102)), device=cuda)
        v = tt(rng.normal(size=2500), device=cuda)
        eng = KE.make_engine(x, kp, cfg)
        ok, worst = matvec_ok(eng.matvec(v), eng._xk, v, 0.02, "rbf")
        assert ok, worst
        xb, _, mask = _ragged_bucket(rng, (700, 650, 1), 700, 102, cuda)
        vb = tt(rng.normal(size=(3, 700)), device=cuda) * mask
        teng = KE.TaskKernelEngine(xb, kp, cfg)
        got = teng.matvec(vb)
        for t in range(3):
            lone = KE.make_engine(xb[t], kp, cfg).matvec(vb[t])
            assert torch.equal(got[t], lone)


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


@pytest.mark.parametrize("shift", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [3, 29491, 70_001])
def test_kkt_select_on_unaligned_views(cuda, n, shift):  # noqa: F811
    """Inputs that start off a 16-byte boundary, alike (a scalar head,
    then float4 groups) or each at its own offset (scalar throughout):
    the same selection as the plain version, exactly."""
    rng = np.random.default_rng(n + shift)
    m = n + 8
    base = [tt(v, device=cuda) for v in (
        rng.normal(size=m), rng.uniform(0, 1, m),
        np.where(rng.random(m) < .5, 1., -1.), np.zeros(m), np.ones(m))]
    base[1][rng.random(m) < 0.3] = 0.0
    mask = tt(rng.random(m) < 0.9, torch.bool, cuda)
    for offs in ([shift] * 6, [shift, 0, 1, 2, 3, shift]):
        f, alpha, y, lo, hi = (t[o:o + n] for t, o in zip(base, offs))
        mk = mask[offs[5]:offs[5] + n]
        got = [float(v) for v in ops.kkt_select(f, alpha, y, mk, lo, hi)]
        want = [float(v) for v in KS.kkt_select_plain(f, alpha, y, mk, lo,
                                                      hi)]
        assert got == want


@pytest.mark.parametrize("tasks,n", [(1, 29491), (1, 5), (36, 7430),
                                     (9, 33178), (3, 1001)])
def test_kkt_select_any_block_count_equals_plain(cuda, tasks, n):  # noqa: F811
    """kkt_select's launch with the planned blocks a task, with one, and
    with threads that take several float4s: the plain version's
    selection exactly, over back-to-back launches (each leaves its
    tickets at 0 for the next)."""
    rng = np.random.default_rng(31 + n)
    lib = _build.library()
    shape = (tasks, n)
    f = tt(rng.normal(size=shape), device=cuda)
    alpha = tt(np.where(rng.random(shape) < 0.4, 0.0,
                        rng.uniform(0, 1, shape)), device=cuda)
    y = tt(np.where(rng.random(shape) < .5, 1., -1.), device=cuda)
    mask = tt(rng.random(shape) < 0.9, torch.bool, cuda)
    lo, hi = torch.zeros_like(f), torch.ones_like(f)
    want = KS.kkt_select_plain(f, alpha, y, mask, lo, hi)
    vals = torch.empty((2, tasks), device=cuda)
    idx = torch.empty((2, tasks), dtype=torch.int64, device=cuda)
    for blocks in (KS.n_blocks(n), 1, 3):
        for _ in range(3):
            assert KS.launch(lib, f, alpha, y, mask, lo, hi, vals, idx,
                             blocks=blocks) == 0
            assert torch.equal(vals[0], want[0])
            assert torch.equal(idx[0], want[1])
            assert torch.equal(vals[1], want[2])
            assert torch.equal(idx[1], want[3])


def test_selection_and_cached_row_are_one_kernel_each(cuda):  # noqa: F811
    """Under the profiler: one device kernel a kkt_select call and one a
    cached row call (the lookup folded in), for T = 1 and a bucket."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(9)
    n, d = 4099, 102
    x = tt(rng.normal(size=(n, d)), device=cuda)
    x2 = K.sqnorms(x)
    cache = _fresh_cache(32, n, cuda)
    f, alpha = (tt(rng.normal(size=(2, n)), device=cuda),
                tt(rng.uniform(0, 1, (2, n)), device=cuda))
    y = torch.ones((2, n), device=cuda)
    mask = torch.ones((2, n), dtype=torch.bool, device=cuda)
    lo, hi = torch.zeros_like(f), torch.ones_like(f)
    idx = [torch.tensor(int(v), device=cuda) for v in rng.integers(0, n, 40)]
    ops.gram_row_cached(x, x2, idx[0], *cache, gamma=0.01)
    ops.kkt_select(f, alpha, y, mask, lo, hi)
    torch.cuda.synchronize()
    best = {}
    for _ in range(3):   # the profiler can drop records, never add them
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for it in idx:
                ops.gram_row_cached(x, x2, it, *cache, gamma=0.01)
                ops.kkt_select(f[0], alpha[0], y[0], mask[0], lo[0], hi[0])
                ops.kkt_select(f, alpha, y, mask, lo, hi)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        counts = {"all": sum(e.count for e in events),
                  "row": sum(e.count for e in events if "gram_row" in e.key),
                  "kkt": sum(e.count for e in events if "kkt_" in e.key)}
        best = {k: max(v, best.get(k, 0)) for k, v in counts.items()}
    assert best == {"all": 3 * len(idx), "row": len(idx),
                    "kkt": 2 * len(idx)}, best


def _lookup_sequence(n, length=200, seed=0):
    """tests/test_torch_row_cache.py: a hot set and evictions."""
    rng = np.random.default_rng(seed)
    hot = rng.choice(n, 5, replace=False)
    cold = rng.integers(0, n, length)
    return np.where(rng.random(length) < 0.6, rng.choice(hot, length), cold)


def _fresh_cache(slots, n, device):
    def z():
        return torch.zeros((), dtype=torch.int64, device=device)
    return (torch.full((slots,), -1, dtype=torch.int64, device=device),
            torch.zeros(slots, dtype=torch.int64, device=device),
            torch.zeros((slots, n), device=device), z(), z(), z())


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("n,d,slots", [
    (1000, 102, 8),     # staged chunks, a ragged last one
    (333, 7, 32),       # odd rows of odd width: ordinary-load tails
    (129, 1500, 4),     # rows too wide for shared memory: direct reads
    (5, 3, 40)])        # fewer rows than slots
def test_cached_row_kernel_follows_the_plain_lru(cuda, dtype, n, d, slots):  # noqa: F811
    """A seeded sequence of 200 lookups through the kernel leaves keys,
    stamps, clock, hits and misses equal to the plain lookup's after
    every call; each row is the uncached entry's bits and within the
    Gram bound of the plain row; one launch a call. gamma is 1 / d, as
    gamma "scale" makes it for unit-variance features, so the rounding
    of |a|^2 + |b|^2 - 2 a.b, which grows with d, reaches K at the size
    the Gram bound was set for (d <= 102)."""
    rng = np.random.default_rng(n + d)
    x = tt(rng.normal(size=(n, d)), device=cuda).to(ops.tile_dtype(dtype))
    x2 = K.sqnorms(x)
    gamma = 1.0 / d
    kern, plain = _fresh_cache(slots, n, cuda), _fresh_cache(slots, n, cuda)
    ops.reset_launches()
    for t, i in enumerate(_lookup_sequence(n, seed=d)):
        it = torch.tensor(int(i), device=cuda)
        got = ops.gram_row_cached(x, x2, it, *kern, gamma=gamma)
        want = G.lru_row_plain(*plain, it, lambda j: G.gram_row_plain(
            x, x2, j, gamma=gamma))
        torch.testing.assert_close(got, want, **GRAM_TOL)
        assert torch.equal(got, ops.gram_row(x, x2, it, gamma=gamma))
        for u, v in zip(kern[:2] + kern[3:], plain[:2] + plain[3:]):
            assert torch.equal(u, v), t
    torch.testing.assert_close(kern[2], plain[2], **GRAM_TOL)
    assert ops.launches["rbf_gram_row_cached"] == 200


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_row_entries_give_the_same_bits(cuda, dtype):  # noqa: F811
    """A row from the cached entry (miss and hit), the uncached entry and
    row t of a task-axis launch: the same bits."""
    rng = np.random.default_rng(5)
    w, d = 1001, 102
    x = tt(rng.normal(size=(3, w, d)), device=cuda).to(ops.tile_dtype(dtype))
    x2 = K.sqnorms(x)
    i = torch.tensor([17, 1000, 0], device=cuda)
    batch = ops.gram_row(x, x2, i, gamma=0.05)
    for t in range(3):
        lone = ops.gram_row(x[t], x2[t], i[t], gamma=0.05)
        cache = _fresh_cache(4, w, cuda)
        miss = ops.gram_row_cached(x[t], x2[t], i[t], *cache, gamma=0.05)
        hit = ops.gram_row_cached(x[t], x2[t], i[t], *cache, gamma=0.05)
        assert [int(v) for v in cache[4:]] == [1, 1]
        for row in (lone, miss, hit):
            assert torch.equal(row, batch[t])


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


def _cancelling_bank(cuda, nt, w, d, gamma):  # noqa: F811
    """Decisions over 2 banks of w SVs whose coefficients are +1 for one
    class's rows, then -1 for the other's (as a compacted OvO task
    stores them): the kernel within DECISION_TOL of its plain version,
    and no further from a float64 evaluation than twice the plain
    version is."""
    rng = np.random.default_rng(9)
    z = tt(rng.normal(size=(nt, d)), device=cuda)
    sv = tt(rng.normal(size=(2, w, d)), device=cuda)
    cf = tt(np.repeat([[1.0] * (w // 2) + [-1.0] * (w - w // 2)], 2, 0),
            device=cuda)
    got = ops.multitask_decision(z, sv, cf, gamma=gamma)
    want = D.multitask_decision_plain(z, sv, cf, gamma=gamma)
    torch.testing.assert_close(got, want, **DECISION_TOL)
    z64, sv64 = z.double(), sv.double()
    d2 = (torch.sum(z64 * z64, 1)[None, :, None]
          + torch.sum(sv64 * sv64, 2)[:, None, :]
          - 2.0 * torch.einsum("nd,twd->tnw", z64, sv64))
    ref = (torch.exp(-gamma * d2) @ cf.double()[:, :, None])[..., 0]
    err = float((got.double() - ref).abs().max())
    plain_err = float((want.double() - ref).abs().max())
    assert err <= 2.0 * plain_err + 2e-6, (err, plain_err)


def test_decision_kernel_sums_cancelling_terms(cuda):  # noqa: F811
    """The terms sum to ~700 in magnitude and cancel to decisions of
    size ~1 (a 1,500-SV bank over 512 rows)."""
    _cancelling_bank(cuda, 512, 1500, 102, 0.005)


def test_decision_kernel_sums_cancelling_terms_ovr_bank(cuda):  # noqa: F811
    """The same at the width of the largest overlapping OvR bank (3,792
    SVs), with the SV axis split over blocks: one split holds only +1
    terms, another only -1 ones, and the partials still cancel."""
    assert D.decision_plan(512, 2, 3792, 102).splits > 1
    _cancelling_bank(cuda, 512, 3792, 102, 0.005)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("nt,tasks,w,d", [   # test_torch_kernel_plan.py
    (8448, 1, 17, 102),     # 132 row tiles: no split
    (3277, 1, 300, 102),    # 52 row tiles x 5 SV tiles
    (1024, 6, 986, 102),    # the overlapping OvO bank, 128-row tiles
    (1, 9, 3792, 102),      # one row against the OvR bank
    (65, 3, 700, 129),      # features in chunks of 64, 64 and 4
    (200, 2, 257, 300),     # five chunks
    (37, 4, 70, 3)])
def test_decision_split_and_unsplit_plans(cuda, dtype, nt, tasks, w, d):  # noqa: F811
    """Whatever the plan: two calls give equal bits (the split partials
    are added in segment order, not in the order blocks finish), T = 1 is
    ops.decision bit for bit, and both modes hold DECISION_TOL."""
    plan = D.decision_plan(nt, tasks, w, d)
    rng = np.random.default_rng(nt + w + d)
    dt = ops.tile_dtype(dtype)
    z = tt(rng.normal(size=(nt, d)), device=cuda)
    sv = tt(rng.normal(size=(tasks, w, d)), device=cuda)
    cf = tt(rng.normal(size=(tasks, w)), device=cuda)
    gamma = 1.0 / d
    for mode in ("rbf", "linear"):
        got = ops.multitask_decision(z, sv, cf, gamma=gamma, mode=mode,
                                     compute_dtype=dtype)
        again = ops.multitask_decision(z, sv, cf, gamma=gamma, mode=mode,
                                       compute_dtype=dtype)
        assert torch.equal(got, again), plan
        want = D.multitask_decision_plain(z.to(dt), sv.to(dt), cf,
                                          gamma=gamma, mode=mode)
        tol = (DECISION_TOL if mode == "rbf" else dict(
            rtol=2e-4, atol=2e-5 * float(want.abs().max())))
        torch.testing.assert_close(got, want, **tol)
    one = ops.multitask_decision(z, sv[:1], cf[:1], gamma=gamma,
                                 compute_dtype=dtype)
    assert torch.equal(one[0], ops.decision(z, sv[0], cf[0], gamma=gamma,
                                            compute_dtype=dtype))


@pytest.mark.parametrize("tasks,w,d", [
    (6, 986, 102),     # the overlapping OvO bank: one tile a segment
    (2, 3792, 102),    # the OvR bank's width
    (3, 700, 129),     # features in chunks
    (1, 5000, 17)])    # 79 SV tiles: two tiles a segment
def test_decision_bits_do_not_depend_on_plan_or_batch(cuda, tasks, w, d):  # noqa: F811
    """A row's sum is folded in an order fixed by the bank's width: the
    same bits whether the row comes alone or inside a 1,024-row batch,
    and whatever row tile and split the launch takes."""
    rng = np.random.default_rng(w + d)
    z = tt(rng.normal(size=(1024, d)), device=cuda)
    sv = tt(rng.normal(size=(tasks, w, d)), device=cuda)
    cf = tt(rng.normal(size=(tasks, w)), device=cuda)
    gamma = 1.0 / d
    batch = ops.multitask_decision(z, sv, cf, gamma=gamma)
    one, full = (D.decision_plan(n, tasks, w, d) for n in (1, 1024))
    assert (one.rows, one.splits) != (full.rows, full.splits)
    for i in (0, 1, 517, 1023):
        alone = ops.multitask_decision(z[i:i + 1], sv, cf, gamma=gamma)
        assert torch.equal(alone[:, 0], batch[:, i]), i
    lib = _build.library()
    for rows in (64, 128):
        for splits in sorted({1, 2, 3, full.segments}):
            plan = D.plan_with(1024, tasks, w, d, rows, splits)
            part, tick = D.scratch(plan, tasks, 1024, z.device,
                                   current_stream())
            out = torch.full_like(batch, float("nan"))
            assert D.launch_multitask(lib, z, sv, cf, out, gamma=gamma,
                                      mode="rbf", plan=plan, partial=part,
                                      ticket=tick) == 0
            assert torch.equal(out, batch), plan


def test_served_rows_alone_equal_the_batch(cuda, tmp_path):  # noqa: F811
    """Through the Predictor: rows served one at a time give the bits
    and labels they get inside a 1,024-row request (each padded to its
    own pow2 bucket, each launch with its own plan)."""
    x, y = load_pavia_like(n_per_class=600, n_classes=5, seed=7, noise=5.0)
    xtr, ytr, xte, _ = train_test_split(normalize(x), y, test_frac=0.25)
    clf = SVC(strategy="ovr", engine="pallas", device=cuda).fit(xtr, ytr)
    serve.save(tmp_path / "m.npz", serve.pack(clf))
    packed = serve.load(tmp_path / "m.npz")
    d = xte.shape[1]
    # a bank of several SV tiles, whose plans differ with the rows
    assert any(D.decision_plan(1, t, w, d)[:2] != D.decision_plan(
        1024, t, w, d)[:2] for t, w, _ in (g.sv_x.shape
                                           for g in packed.buckets))
    pred = serve.Predictor(packed, engine="pallas", device=cuda)
    z = np.resize(xte, (1024, d))
    df, labels = pred.decision_function(z), pred.predict(z)
    for i in (0, 5, 500, 1023):
        np.testing.assert_array_equal(pred.decision_function(z[i:i + 1]),
                                      df[..., i:i + 1])   # (T, rows)
        np.testing.assert_array_equal(pred.predict(z[i:i + 1]),
                                      labels[i:i + 1])


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


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_rff_features_kernel_matches_plain(cuda, dtype):  # noqa: F811
    rng = np.random.default_rng(17)
    dt = ops.tile_dtype(dtype)
    for n, k, d in [(300, 257, 102), (128, 128, 128), (5, 300, 13),
                    (1, 1, 1)]:
        x = tt(rng.normal(size=(n, d)), device=cuda)
        om = tt(rng.normal(scale=0.3, size=(d, k)), device=cuda)
        ph = tt(rng.uniform(0, 2 * np.pi, size=k), device=cuda)
        scale = float(np.sqrt(2.0 / k))
        got = ops.rff_features(x, om, ph, scale=scale, compute_dtype=dtype)
        want = FM.rff_features_plain(x.to(dt), om.to(dt), ph, scale=scale)
        torch.testing.assert_close(got, want, **RFF_TOL)
        if dtype == "bf16":   # against the float32 map, the bf16 bound
            torch.testing.assert_close(got, FM.rff_features_plain(
                x, om, ph, scale=scale), **RFF_BF16_VS_FP32_TOL)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("d", [4, 102, 128, 129, 300])
@pytest.mark.parametrize("n,k", [(1025, 1023), (2177, 1023)])
def test_rff_features_tiles_and_feature_chunks(cuda, dtype, d, n, k):  # noqa: F811
    """Both tiles (64 rows for 1,025 x 1,023, 128 for 2,177 x 1,023),
    the feature axis staged whole (d <= 128) and in chunks (129, 300),
    ragged n and k, against the plain version at RFF_TOL."""
    assert FM.rff_plan(n, k, d).rows == (64 if n == 1025 else 128)
    rng = np.random.default_rng(n + d)
    dt = ops.tile_dtype(dtype)
    x = tt(rng.normal(size=(n, d)), device=cuda)
    om = tt(rng.normal(scale=float(np.sqrt(2.0 / d)), size=(d, k)),
            device=cuda)
    ph = tt(rng.uniform(0, 2 * np.pi, size=k), device=cuda)
    scale = float(np.sqrt(2.0 / k))
    got = ops.rff_features(x, om, ph, scale=scale, compute_dtype=dtype)
    torch.testing.assert_close(got, FM.rff_features_plain(
        x.to(dt), om.to(dt), ph, scale=scale), **RFF_TOL)


def test_rff_features_unaligned_rows(cuda):  # noqa: F811
    """Operands whose rows are 4-byte aligned only (a view one float into
    its storage; d odd) take the 4-byte copies."""
    rng = np.random.default_rng(3)
    buf = tt(rng.normal(size=300 * 101 + 1), device=cuda)
    x = buf[1:].view(300, 101)
    om = tt(rng.normal(scale=0.1, size=(101, 257)), device=cuda)
    ph = tt(rng.uniform(0, 2 * np.pi, size=257), device=cuda)
    got = ops.rff_features(x, om, ph, scale=0.1)
    torch.testing.assert_close(got, FM.rff_features_plain(
        x, om, ph, scale=0.1), **RFF_TOL)
    z = buf[1:1 + 70 * 101].view(70, 101)
    sv = x[:200].reshape(2, 100, 101)
    cf = tt(rng.normal(size=(2, 100)), device=cuda)
    torch.testing.assert_close(
        ops.multitask_decision(z, sv, cf, gamma=0.01),
        D.multitask_decision_plain(z, sv, cf, gamma=0.01), **DECISION_TOL)


def _dcd_state(rng, n, k, device):
    phi = tt(rng.normal(scale=1 / np.sqrt(k), size=(n, k)), device=device)
    y = tt(np.where(rng.random(n) < 0.5, 1.0, -1.0), device=device)
    beta = np.where(rng.random(n) < 0.3, 0.0, rng.uniform(0, 1, n))
    beta[rng.random(n) < 0.2] = 1.0
    live = rng.random(n) < 0.9
    beta[~live] = 0.0
    state = dict(
        phi=phi, y=y, p=-torch.ones(n, device=device),
        lo=torch.zeros(n, device=device), hi=torch.ones(n, device=device),
        q_diag=torch.sum(phi * phi, dim=1) + 1.0,
        live=tt(live, torch.bool, device),
        perm=torch.from_numpy(rng.permutation(n)).to(device),
        beta=tt(beta, device=device))
    coef = state["y"] * state["beta"] * state["live"]
    state["w"] = (phi.T @ coef).contiguous()
    state["wb"] = torch.sum(coef).reshape(1)
    return state


@pytest.mark.parametrize("n,k", [(500, 1024), (300, 37), (200, 1025),
                                 (64, 9000), (1, 1)])
def test_dcd_epoch_kernel_matches_plain(cuda, n, k):  # noqa: F811
    """One epoch from the same state and permutation; k > 1024 takes the
    kernel's path that reads phi_i from memory instead of registers."""
    st = _dcd_state(np.random.default_rng(n + k), n, k, cuda)
    host = {name: t.cpu().clone() for name, t in st.items()}
    viol = ops.dcd_epoch(**st, bias=1.0)
    want = DCD.dcd_epoch_plain(*host.values(), bias=1.0)
    for name in ("beta", "w", "wb"):
        got, ref = st[name].cpu(), host[name]
        torch.testing.assert_close(
            got, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()) + 1e-7)
    assert float(viol) == pytest.approx(float(want), abs=1e-5)


def test_dcd_epoch_refuses_ranks_past_shared_memory(cuda):  # noqa: F811
    st = _dcd_state(np.random.default_rng(0), 4, ops.DCD_MAX_RANK + 1, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ops.dcd_epoch(**st, bias=1.0)


def _dcd_check(st, host, viol, want):
    """One epoch's kernel result against the plain loop's, at the bounds
    of test_dcd_epoch_kernel_matches_plain."""
    for name in ("beta", "w", "wb"):
        got, ref = st[name].cpu(), host[name]
        torch.testing.assert_close(
            got, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()) + 1e-7)
    assert float(viol) == pytest.approx(float(want), abs=1e-5)


def _dcd_with_plan(cuda, st, plan):  # noqa: F811
    """One launch of the kernel with the given plan (ops.dcd_epoch takes
    dcd_plan's)."""
    viol = torch.empty((1,), device=cuda)
    code = DCD.launch(_build.library(), st["phi"], st["y"], st["p"],
                      st["lo"], st["hi"], st["q_diag"], st["live"],
                      st["perm"], st["beta"], st["w"], st["wb"], viol,
                      bias=1.0, plan=plan)
    assert code == 0
    return viol[0]


@pytest.mark.parametrize("window", DCD.WINDOWS)
@pytest.mark.parametrize("n,k", [(700, 1024), (300, 37), (5, 1024)])
def test_dcd_epoch_every_window_matches_plain(cuda, window, n, k):  # noqa: F811
    """Each window the kernel instantiates holds the plain loop's bounds
    (a window past n, ragged last windows, unaligned rows by cp.async)."""
    plan = DCD.dcd_plan(k, window=window)
    assert plan.route == "ring" and plan.window == window
    st = _dcd_state(np.random.default_rng(n + window), n, k, cuda)
    host = {name: t.cpu().clone() for name, t in st.items()}
    viol = _dcd_with_plan(cuda, st, plan)
    _dcd_check(st, host, viol, DCD.dcd_epoch_plain(*host.values(), bias=1.0))


@pytest.mark.parametrize("n,k", [(400, 4096), (150, 9000), (1, 1024),
                                 (3, 1024), (7, 1024), (9, 1024)])
def test_dcd_epoch_fewer_slots_and_short_sweeps(cuda, n, k):  # noqa: F811
    """Large ranks leave fewer ring slots and a smaller window; n below a
    window, n = 1 and one past a window."""
    plan = DCD.dcd_plan(k)
    assert plan.route == "ring" and 2 * plan.window <= plan.depth
    if k > 1024:
        assert plan.depth < DCD.MAX_DEPTH and plan.window < DCD.WINDOW
    st = _dcd_state(np.random.default_rng(n * 7 + k), n, k, cuda)
    host = {name: t.cpu().clone() for name, t in st.items()}
    viol = ops.dcd_epoch(**st, bias=1.0)
    _dcd_check(st, host, viol, DCD.dcd_epoch_plain(*host.values(), bias=1.0))


def test_dcd_epoch_dead_coordinates_inside_windows(cuda):  # noqa: F811
    """Dead coordinates scattered through every window, and whole windows
    of them: no step, no viol, beta untouched."""
    n, k = 640, 1024
    st = _dcd_state(np.random.default_rng(5), n, k, cuda)
    live = np.random.default_rng(6).random(n) < 0.5
    live[64:96] = False
    st["live"] = tt(live, torch.bool, cuda)
    st["beta"] = st["beta"] * st["live"]
    coef = st["y"] * st["beta"]
    st["w"] = (st["phi"].T @ coef).contiguous()
    st["wb"] = torch.sum(coef).reshape(1)
    host = {name: t.cpu().clone() for name, t in st.items()}
    viol = ops.dcd_epoch(**st, bias=1.0)
    _dcd_check(st, host, viol, DCD.dcd_epoch_plain(*host.values(), bias=1.0))
    assert torch.equal(st["beta"].cpu()[~torch.from_numpy(live)],
                       host["beta"][~torch.from_numpy(live)])


@pytest.mark.parametrize("k", [1024, 37, 9000])
@pytest.mark.parametrize("gap", [1, 3, 7, 20, 31, 40])
def test_dcd_epoch_repeated_indices(cuda, gap, k):  # noqa: F811
    """A perm that repeats indices: each repeat sees the beta its earlier
    occurrence left, at distances 1 and below a window (same window),
    below the ring's depth (a later window, not yet written back) and
    past it."""
    n = 600 if k < 9000 else 120
    st = _dcd_state(np.random.default_rng(gap + k), n, k, cuda)
    perm = np.random.default_rng(gap).permutation(n)
    for t in range(gap, n, 5):
        perm[t] = perm[t - gap]
    st["perm"] = torch.from_numpy(perm).to(cuda)
    host = {name: t.cpu().clone() for name, t in st.items()}
    viol = ops.dcd_epoch(**st, bias=1.0)
    _dcd_check(st, host, viol, DCD.dcd_epoch_plain(*host.values(), bias=1.0))


def _dcd_tasks_state(rng, sizes, n_rows, k, device):
    """Tasks over rows of one shared Phi: concatenated per-coordinate
    vectors, per-task permutations of local indices, w (T, k), wb (T,)."""
    phi = tt(rng.normal(scale=1 / np.sqrt(k), size=(n_rows, k)),
             device=device)
    parts = [_dcd_state(rng, s, k, "cpu") for s in sizes]
    rows = [rng.choice(n_rows, size=s, replace=False) for s in sizes]
    cat = {name: torch.cat([pt[name] for pt in parts]).to(device)
           for name in ("y", "p", "lo", "hi", "live", "perm", "beta")}
    cat["rows"] = torch.from_numpy(np.concatenate(rows)).to(device)
    cat["offsets"] = torch.tensor(np.r_[0, np.cumsum(sizes)],
                                  dtype=torch.int64, device=device)
    phi_cpu = phi.cpu()
    q, w, wb = [], [], []
    for pt, r in zip(parts, rows):
        ph = phi_cpu[torch.from_numpy(r)]
        q.append(torch.sum(ph * ph, dim=1) + 1.0)
        coef = pt["y"] * pt["beta"] * pt["live"]
        w.append(ph.T @ coef)
        wb.append(torch.sum(coef))
    cat["q_diag"] = torch.cat(q).to(device)
    cat["w"] = torch.stack(w).contiguous().to(device)
    cat["wb"] = torch.stack(wb).to(device)
    return phi, cat


def test_dcd_task_axis_equals_lone_launches(cuda):  # noqa: F811
    """One task-axis launch over ragged tasks (one of one row), some left
    out (frozen): each launched task equals its one-task launch on its
    gathered rows bit for bit and the plain loop at the usual bounds;
    the tasks left out are untouched."""
    rng = np.random.default_rng(31)
    sizes, k = [700, 1, 333, 9, 512], 1024
    phi, st = _dcd_tasks_state(rng, sizes, 900, k, cuda)
    before = {name: t.clone() for name, t in st.items()}
    tasks = torch.tensor([0, 1, 3, 4], device=cuda)
    ops.reset_launches()
    viols = ops.dcd_epoch_tasks(phi, **st, tasks=tasks, bias=1.0)
    assert ops.launches["dcd_epoch"] == 1
    off = st["offsets"].tolist()
    for b, t in enumerate(tasks.tolist()):
        seg = slice(off[t], off[t + 1])
        phi_t = phi.index_select(0, before["rows"][seg])
        lone = {name: before[name][seg].clone() for name in
                ("y", "p", "lo", "hi", "q_diag", "live", "perm", "beta")}
        lone.update(phi=phi_t, w=before["w"][t].clone(),
                    wb=before["wb"][t:t + 1].clone())
        order = ("phi", "y", "p", "lo", "hi", "q_diag", "live", "perm",
                 "beta", "w", "wb")
        lone = {name: lone[name] for name in order}
        host = {name: v.cpu().clone() for name, v in lone.items()}
        viol = ops.dcd_epoch(**lone, bias=1.0)
        assert torch.equal(st["beta"][seg], lone["beta"])
        assert torch.equal(st["w"][t], lone["w"])
        assert torch.equal(st["wb"][t:t + 1], lone["wb"])
        assert float(viols[b]) == float(viol)
        res = {"beta": st["beta"][seg], "w": st["w"][t],
               "wb": st["wb"][t:t + 1]}
        _dcd_check(res, host, viols[b],
                   DCD.dcd_epoch_plain(*host.values(), bias=1.0))
    seg = slice(off[2], off[3])
    assert torch.equal(st["beta"][seg], before["beta"][seg])
    assert torch.equal(st["w"][2], before["w"][2])


def test_dcd_tasks_solve_on_card_equals_lone(cuda):  # noqa: F811
    """The batched solve on the card: each task's result does not depend
    on the tasks it shares the solve with (equal to the same task
    solved alone by it), and certifies."""
    rng = np.random.default_rng(12)
    n_rows, k = 900, 128
    phi = tt(rng.normal(size=(n_rows, k)) / np.sqrt(k), device=cuda)
    rows = [np.sort(rng.choice(n_rows, size=s, replace=False))
            for s in (400, 1, 250, 600)]
    ys = [np.sign(phi.cpu().numpy()[r] @ rng.normal(size=k) + 0.1)
          .astype(np.float32) for r in rows]
    cfg = linear.DCDConfig(C=1.0, tol=1e-3)
    batch = linear.linear_svc_tasks(phi, rows, ys, cfg=cfg)
    for t, (r, y) in enumerate(zip(rows, ys)):
        alone = linear.linear_svc_tasks(phi, [r], [y], cfg=cfg)[0]
        for name in ("alpha", "w", "b", "n_iter", "converged", "gap"):
            assert torch.equal(getattr(batch[t], name).cpu(),
                               getattr(alone, name).cpu()), (t, name)
        assert bool(batch[t].converged)
        assert _lowrank_certificate(phi.cpu()[torch.from_numpy(r)], y,
                                    batch[t].alpha.cpu(), 1.0) <= 1e-3


def _lowrank_certificate(phi, yy, alpha, C, bias=1.0):
    """float64 KKT of the augmented-bias box QP, r pinned at 0."""
    phib = torch.cat([phi.double().cpu(),
                      torch.full((phi.shape[0], 1), bias,
                                 dtype=torch.float64)], dim=1)
    a = torch.as_tensor(alpha).double()
    y = torch.as_tensor(yy).double()
    f = phib @ (phib.T @ (a * y)) - y
    return float(smo.kkt_violation(a, y, f, 0.0, C, r=0.0))


def test_lowrank_fit_and_serve_on_card(cuda, tmp_path):  # noqa: F811
    x, y = load_pavia_like(n_per_class=300, n_classes=2, seed=7)
    xtr, ytr, xte, _ = train_test_split(normalize(x), y, test_frac=0.25)
    ops.reset_launches()
    clf = SVC(engine="rff", rank=256, device=cuda).fit(xtr, ytr)
    assert ops.launches["rff_features"] > 0 and ops.launches["dcd_epoch"] > 0
    assert clf.converged_
    yy = np.where(ytr == clf.classes_[1], 1.0, -1.0).astype(np.float32)
    phi = clf._feature_map.transform(tt(xtr, device=cuda))
    assert _lowrank_certificate(phi, yy, clf.alpha_, 1.0) <= 1e-3
    serve.save(tmp_path / "m.npz", serve.pack(clf))
    pred = serve.Predictor(serve.load(tmp_path / "m.npz"), device=cuda)
    om, ph = clf._feature_map.arrays
    plain = (FM.rff_features_plain(tt(xte, device=cuda), om, ph,
                                   scale=clf._feature_map.scale)
             @ tt(clf.w_, device=cuda) + clf.b_).cpu().numpy()
    np.testing.assert_array_equal(
        pred.predict(xte), clf.classes_[(plain > 0).astype(np.int64)])
    np.testing.assert_allclose(pred.decision_function(xte), plain,
                               rtol=0, atol=1e-5)


def test_linear_svc_on_card_matches_cpu(cuda):  # noqa: F811
    """The same Phi on the card and on the CPU: the permutations come
    from different generators, so the solves meet at the optimum, not
    step by step: both certify, w within 10 tol, labels equal."""
    rng = np.random.default_rng(4)
    phi = rng.normal(size=(400, 64)).astype(np.float32) / 8
    yy = np.sign(phi @ rng.normal(size=64) + 0.1).astype(np.float32)
    cfg = linear.DCDConfig(C=1.0, tol=1e-3)
    rg = linear.linear_svc(tt(phi, device=cuda), tt(yy, device=cuda),
                           cfg=cfg)
    rc = linear.linear_svc(tt(phi), tt(yy), cfg=cfg)
    assert bool(rg.converged) and bool(rc.converged)
    for r in (rg, rc):
        assert _lowrank_certificate(tt(phi), yy, r.alpha.cpu(), 1.0) <= 1e-3
    np.testing.assert_allclose(rg.w.cpu().numpy(), rc.w.numpy(), atol=1e-2)
    dg = phi @ rg.w.cpu().numpy() + float(rg.b)
    dc = phi @ rc.w.numpy() + float(rc.b)
    away = np.abs(dc) > 1e-2
    np.testing.assert_array_equal(np.sign(dg[away]), np.sign(dc[away]))


@pytest.mark.parametrize("engine", ["pallas", "rff"])
def test_svr_fit_and_serve_on_card(cuda, engine, tmp_path):  # noqa: F811
    x, y = make_synth_regression(600, 6, kind="sinc", noise=0.1, seed=7)
    ops.reset_launches()
    reg = SVR(engine=engine, rank=256, epsilon=0.1, device=cuda).fit(
        x[:500], y[:500])
    assert reg.converged_ and reg.score(x[500:], y[500:]) > 0.5
    used = (("rbf_gram_row_cached", "kkt_select") if engine == "pallas"
            else ("rff_features", "dcd_epoch"))
    assert all(ops.launches[k] > 0 for k in used), ops.launches
    serve.save(tmp_path / "r.npz", serve.pack(reg))
    pred = serve.Predictor(serve.load(tmp_path / "r.npz"), engine=engine,
                           device=cuda)
    np.testing.assert_allclose(pred.predict(x[500:]),
                               reg._predict_engine(x[500:]), **DECISION_TOL)


def _ragged_bucket(rng, widths, w, d, device):
    """A bucket of len(widths) tasks zero-padded to width w, as
    dist._bucket_arrays stacks them."""
    t = len(widths)
    x = np.zeros((t, w, d), np.float32)
    y = np.zeros((t, w), np.float32)
    mask = np.zeros((t, w), bool)
    for s, k in enumerate(widths):
        x[s, :k] = rng.normal(size=(k, d))
        y[s, :k] = np.where(rng.random(k) < 0.5, 1.0, -1.0)
        mask[s, :k] = True
    return (tt(x, device=device), tt(y, device=device),
            tt(mask, torch.bool, device))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_task_axis_kernels_equal_lone_launches(cuda, dtype):  # noqa: F811
    """One task-axis launch of the row and the selection kernel gives each
    task of a ragged bucket what its own T = 1 launch gives, bit for
    bit, and matches the plain versions."""
    rng = np.random.default_rng(23)
    for widths, w, d in [((300, 17, 256), 300, 102), ((5,), 5, 3),
                         ((4000, 3999, 1, 2500), 4000, 7)]:
        x, y, mask = _ragged_bucket(rng, widths, w, d, cuda)
        xk = x.to(ops.tile_dtype(dtype))
        x2 = K.sqnorms(xk)
        i = torch.tensor([k // 2 for k in widths], device=cuda)
        rows = ops.gram_row(xk, x2, i, gamma=0.01)
        torch.testing.assert_close(rows, G.gram_row_plain(
            xk, x2, i, gamma=0.01), **GRAM_TOL)
        n = len(widths)
        f = tt(rng.normal(size=(n, w)), device=cuda)
        alpha = tt(np.where(rng.random((n, w)) < 0.4, 0.0,
                            rng.uniform(0, 1, (n, w))), device=cuda)
        lo, hi = torch.zeros_like(f), torch.ones_like(f)
        got = ops.kkt_select(f, alpha, y, mask, lo, hi)
        want = KS.kkt_select_plain(f, alpha, y, mask, lo, hi)
        for g, wv in zip(got, want):
            assert torch.equal(g, wv)
        for t in range(n):
            assert torch.equal(rows[t], ops.gram_row(xk[t], x2[t], i[t],
                                                     gamma=0.01))
            lone = ops.kkt_select(f[t], alpha[t], y[t], mask[t], lo[t],
                                  hi[t])
            assert [float(v[t]) for v in got] == [float(v) for v in lone]


def test_bucket_smo_equals_lone_solves(cuda):  # noqa: F811
    """A multiclass bucket solved by one batched SMO on the card: each
    task's alphas, b and n_iter equal its lone solve (T = 1 launches)."""
    x, y = load_pavia_like(n_per_class=120, n_classes=4, seed=7)
    taskset = MC.get_strategy("ovo").build_taskset(normalize(x), y)
    bucket = MC.build_schedule(taskset.sizes).buckets[0]
    xt, yt, mk, _ = dist._bucket_arrays(taskset, bucket)
    kw = dict(cfg=smo.SMOConfig(C=1.0), kernel=K.KernelParams(gamma=0.05),
              engine="pallas")
    ops.reset_launches()
    r = smo.binary_smo_tasks(tt(xt, device=cuda), tt(yt, device=cuda),
                             tt(mk, torch.bool, cuda), **kw)
    iters = int(r.n_iter.max())
    assert ops.launches["kkt_select"] <= iters + 32 + 1   # one per step
    assert bool(r.converged.all())
    for s in range(xt.shape[0]):
        lone = smo.binary_smo(tt(xt[s], device=cuda), tt(yt[s], device=cuda),
                              tt(mk[s], torch.bool, cuda), **kw)
        assert torch.equal(lone.alpha, r.alpha[s])
        assert float(lone.b) == float(r.b[s])
        assert int(lone.n_iter) == int(r.n_iter[s])


def test_gd_bucket_equals_lone_solves(cuda):  # noqa: F811
    """A multiclass bucket stepped by one batched GD on the card: one
    task-axis Gram matvec launch a step, and each task's alphas, b and
    loss curve equal its lone ``binary_gd`` (T = 1 launches)."""
    x, y = load_pavia_like(n_per_class=120, n_classes=4, seed=7)
    taskset = MC.get_strategy("ovo").build_taskset(normalize(x), y)
    bucket = MC.build_schedule(taskset.sizes).buckets[0]
    xt, yt, mk, _ = dist._bucket_arrays(taskset, bucket)
    kw = dict(cfg=gd.GDConfig(lr=0.01, steps=300),
              kernel=K.KernelParams(gamma=0.05), engine="pallas")
    ops.reset_launches()
    r = gd.binary_gd_tasks(tt(xt, device=cuda), tt(yt, device=cuda),
                           tt(mk, torch.bool, cuda), **kw)
    assert ops.launches["rbf_gram_matvec"] == 300
    for s in range(xt.shape[0]):
        lone = gd.binary_gd(tt(xt[s], device=cuda), tt(yt[s], device=cuda),
                            tt(mk[s], torch.bool, cuda), **kw)
        assert torch.equal(lone.alpha, r.alpha[s])
        assert torch.equal(lone.b, r.b[s])
        assert torch.equal(lone.loss_curve, r.loss_curve[s])


@pytest.mark.parametrize("kind", ["svc", "svr"])
def test_gd_on_card_matches_cpu(cuda, kind):  # noqa: F811
    """The GD loop on the card (one Gram matvec launch a step) against
    the same loop on the CPU's plain path, at a stable step."""
    if kind == "svc":
        x, y = load_pavia_like(n_per_class=300, n_classes=2, seed=7)
        x, y = normalize(x), np.where(y == 0, 1.0, -1.0).astype(np.float32)
        fit = gd.binary_gd
    else:
        x, y = make_synth_regression(500, 6, kind="sinc", noise=0.1, seed=7)
        fit = gd.svr_gd
    kw = dict(cfg=gd.GDConfig(lr=1e-3, steps=400),
              kernel=K.KernelParams(gamma=0.05), engine="pallas")
    ops.reset_launches()
    got = fit(tt(x, device=cuda), tt(y, device=cuda), **kw)
    assert ops.launches["rbf_gram_matvec"] == 400
    want = fit(tt(x), tt(y), **kw)
    np.testing.assert_allclose(got.alpha.cpu().numpy(), want.alpha.numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.loss_curve.cpu().numpy(),
                               want.loss_curve.numpy(), rtol=1e-4, atol=1e-4)
    assert abs(float(got.b) - float(want.b)) <= 1e-4


@pytest.mark.parametrize("kind,engine", [("svc", "pallas"), ("svr", "pallas"),
                                         ("svc", "rff"), ("svr", "rff")])
def test_cascade_certifies_on_card(cuda, kind, engine):  # noqa: F811
    """S = 4 cascades on the card certify at 1e-3 (the certificate
    recomputed here in float64); S = 1 is the unsharded fit bit for
    bit."""
    kw = dict(engine=engine, rank=256, gamma=0.05, device=cuda)
    if kind == "svc":
        x, y = load_pavia_like(n_per_class=300, n_classes=2, seed=7)
        x, make = normalize(x), SVC
    else:
        x, y = make_synth_regression(600, 6, kind="sinc", noise=0.1, seed=7)
        make = SVR
    ops.reset_launches()
    model = make(shard="cascade", cascade_shards=4, **kw).fit(x, y)
    assert model.converged_ and model.cascade_kkt_ <= 1e-3
    if engine == "pallas":
        assert ops.launches["rbf_gram"] > 0 and ops.launches["kkt_select"] > 0
    else:
        assert ops.launches["dcd_epoch"] > 0
    one = make(shard="cascade", cascade_shards=1, **kw).fit(x, y)
    plain = make(**kw).fit(x, y)
    coef = "alpha_" if kind == "svc" else "beta_"
    np.testing.assert_array_equal(getattr(one, coef), getattr(plain, coef))
    assert one.b_ == plain.b_
    # the certificate, from scratch in float64
    xd = tt(x, device=cuda).double()
    if engine == "rff":
        phi = model._feature_map.transform(tt(x, device=cuda)).double()
        phib = torch.cat([phi, torch.ones((len(x), 1), dtype=torch.float64,
                                          device=cuda)], 1)
        gram = phib @ phib.T
    else:
        gram = torch.exp(-0.05 * torch.cdist(xd, xd) ** 2)
    r = 0.0 if engine == "rff" else None
    if kind == "svc":
        yy = torch.from_numpy(np.where(y == model.classes_[1], 1.0, -1.0)
                              ).to(cuda)
        a = torch.from_numpy(model.alpha_).to(cuda).double()
        f = gram @ (a * yy) - yy
        viol = smo.kkt_violation(a, yy, f, 0.0, 1.0, r=r)
    else:
        y64 = torch.from_numpy(y).to(cuda).double()
        g = gram @ torch.from_numpy(model.beta_).to(cuda).double()
        f = torch.cat([g + 0.1 - y64, g - 0.1 - y64])
        ones = torch.ones(len(y), dtype=torch.float64, device=cuda)
        viol = smo.kkt_violation(torch.from_numpy(model.alpha_raw_).to(cuda),
                                 torch.cat([ones, -ones]), f, 0.0, 1.0, r=r)
    assert float(viol) <= 1e-3


@pytest.mark.parametrize("strategy", ["ovo", "ovr"])
def test_multiclass_fit_and_serve_on_card(cuda, strategy,  # noqa: F811
                                          tmp_path):
    x, y = load_pavia_like(n_per_class=80, n_classes=5, seed=7)
    xtr, ytr, xte, yte = train_test_split(normalize(x), y, test_frac=0.25)
    ops.reset_launches()
    clf = SVC(strategy=strategy, engine="pallas", device=cuda).fit(xtr, ytr)
    assert clf.converged_
    assert ops.launches["rbf_gram_row"] > 0 and ops.launches["kkt_select"] > 0
    serve.save(tmp_path / "m.npz", serve.pack(clf))
    pred = serve.Predictor(serve.load(tmp_path / "m.npz"), engine="pallas",
                           device=cuda).warmup((1, 37))
    df = clf._decision_function_engine(xte)
    np.testing.assert_allclose(pred.decision_function(xte), df,
                               **DECISION_TOL)
    labels = clf.classes_[MC.decide_from_pairs(
        torch.from_numpy(df), clf._taskset.pairs, len(clf.classes_),
        strategy).numpy()]
    np.testing.assert_array_equal(pred.predict(xte), labels)
    assert ops.launches["multitask_decision"] > 0
    cpu = SVC(strategy=strategy, engine="pallas", device="cpu").fit(xtr, ytr)
    np.testing.assert_array_equal(cpu.predict(xte), pred.predict(xte))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hkv,d", [
    (2, 256, 4, 4, 64), (1, 512, 4, 2, 64), (2, 300, 2, 2, 32),
    (1, 128, 8, 1, 16), (1, 77, 3, 1, 128), (1, 1, 2, 2, 8)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_matches_plain(cuda, dtype, b, s, h,  # noqa: F811
                                              hkv, d, causal):
    rng = np.random.default_rng(s + d)
    q, k, v = (tt(rng.normal(size=shape), device=cuda).to(dtype)
               for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)))
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal,
                              out_dtype=torch.float32)
    want = FA.flash_attention_plain(q, k, v, causal=causal,
                                    out_dtype=torch.float32)
    torch.testing.assert_close(got, want, **LM_TOL)
    out = ops.flash_attention(q, k, v, causal=causal)
    assert out.dtype == dtype
    assert torch.equal(out, got.to(dtype))   # rounded once, at the end
    assert ops.launches["flash_attention"] == 2


@pytest.mark.parametrize("bc,h,q,n,p", [
    (2, 3, 32, 16, 8), (1, 4, 64, 32, 16), (3, 2, 128, 16, 32),
    (2, 2, 256, 128, 64), (1, 1, 100, 24, 130)])
def test_ssd_diag_kernel_matches_plain(cuda, bc, h, q, n, p):  # noqa: F811
    rng = np.random.default_rng(q + n)
    cmat, bmat = (tt(rng.normal(size=(bc, q, n)), device=cuda)
                  for _ in range(2))
    x = tt(rng.normal(size=(bc, h, q, p)), device=cuda)
    dt_np = rng.uniform(0.001, 0.1, size=(bc, h, q))
    a = -rng.uniform(1, 8, size=(h,))
    dt = tt(dt_np, device=cuda)
    cs = tt(np.cumsum(dt_np * a[None, :, None], axis=2), device=cuda)
    got = ops.ssd_diag(cmat, bmat, x, dt, cs)
    torch.testing.assert_close(got, SD.ssd_diag_plain(cmat, bmat, x, dt, cs),
                               **LM_TOL)
    # decays steep enough that exp above the diagonal overflows: the
    # kernel never takes it, so nothing turns to NaN
    steep = cs * 40.0
    got = ops.ssd_diag(cmat, bmat, x, dt, steep)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, SD.ssd_diag_plain(cmat, bmat, x, dt,
                                                      steep), **LM_TOL)


def _qkv(rng, b, sq, sk, h, hkv, d, dtype, dev):
    return (tt(rng.normal(size=(b, sq, h, d)), device=dev).to(dtype),
            tt(rng.normal(size=(b, sk, hkv, d)), device=dev).to(dtype),
            tt(rng.normal(size=(b, sk, hkv, d)), device=dev).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk", [(77, 300), (300, 77), (1, 130),
                                   (129, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_sq_unlike_sk(cuda, dtype, sq, sk, causal):  # noqa: F811
    """Queries and keys of different lengths: the causal mask compares
    global positions, ragged tiles of either are masked."""
    q, k, v = _qkv(np.random.default_rng(sq * sk), 2, sq, sk, 4, 2, 64,
                   dtype, cuda)
    got = ops.flash_attention(q, k, v, causal=causal,
                              out_dtype=torch.float32)
    want = FA.flash_attention_plain(q, k, v, causal=causal,
                                    out_dtype=torch.float32)
    torch.testing.assert_close(got, want, **LM_TOL)
    assert torch.equal(ops.flash_attention(q, k, v, causal=causal),
                       got.to(dtype))


@pytest.mark.parametrize("d", [8, 72])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_narrow_and_odd_widths(cuda, d, causal):  # noqa: F811
    """bf16 at d = 8 (one zero-padded k16 step) and d = 72 (staged to
    128, the words past d zero)."""
    q, k, v = _qkv(np.random.default_rng(d), 2, 300, 300, 3, 1, d,
                   torch.bfloat16, cuda)
    got = ops.flash_attention(q, k, v, causal=causal,
                              out_dtype=torch.float32)
    want = FA.flash_attention_plain(q, k, v, causal=causal,
                                    out_dtype=torch.float32)
    torch.testing.assert_close(got, want, **LM_TOL)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 6), (torch.float32, 101),
                                     (torch.bfloat16, 20), (torch.bfloat16, 7)])
def test_flash_attention_rows_no_tensor_map_takes(cuda, dtype, d):  # noqa: F811
    """Rows that are not 16-byte multiples: the producer's loads stage
    them in the tensor maps' layout, zero past d."""
    q, k, v = _qkv(np.random.default_rng(d), 2, 150, 150, 4, 2, d, dtype,
                   cuda)
    for causal in (True, False):
        got = ops.flash_attention(q, k, v, causal=causal,
                                  out_dtype=torch.float32)
        want = FA.flash_attention_plain(q, k, v, causal=causal,
                                        out_dtype=torch.float32)
        torch.testing.assert_close(got, want, **LM_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bits_are_the_inputs_alone(cuda, dtype):  # noqa: F811
    """Two launches give the same bits, and so do both query tiles of the
    plan (64 and 128 rows a block): no atomics, no split over keys."""
    q, k, v = _qkv(np.random.default_rng(3), 1, 700, 700, 6, 2, 128,
                   dtype, cuda)
    first = ops.flash_attention(q, k, v, causal=True)
    assert torch.equal(first, ops.flash_attention(q, k, v, causal=True))
    lib = _build.library()
    for rows in FA.ROWS:
        out = torch.empty_like(first)
        plan = FA.flash_plan(1, 700, 6, 128, dtype, rows=rows)
        assert FA.launch(lib, q, k, v, out, causal=True, plan=plan) == 0
        assert torch.equal(out, first), rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_grouped_heads_equal_repeated_kv(cuda, dtype):  # noqa: F811
    """A query head reading its kv head in place gives the bits of the
    same head over kv heads repeated to H."""
    q, k, v = _qkv(np.random.default_rng(5), 2, 333, 333, 6, 2, 64, dtype,
                   cuda)
    grouped = ops.flash_attention(q, k, v, causal=True)
    rep = [t.repeat_interleave(3, dim=2).contiguous() for t in (k, v)]
    assert torch.equal(grouped, ops.flash_attention(q, *rep, causal=True))


def _ssd(rng, bc, h, q, n, p, dev):
    cmat, bmat = (tt(rng.normal(size=(bc, q, n)), device=dev)
                  for _ in range(2))
    x = tt(rng.normal(size=(bc, h, q, p)), device=dev)
    dt_np = rng.uniform(0.001, 0.1, size=(bc, h, q))
    a = -rng.uniform(1, 8, size=(h,))
    return (cmat, bmat, x, tt(dt_np, device=dev),
            tt(np.cumsum(dt_np * a[None, :, None], axis=2), device=dev))


def test_ssd_diag_heads_do_not_depend_on_the_group(cuda):  # noqa: F811
    """With H = 6 in groups of 6, 3, 2 and 1 heads (a group shares one
    score computation) each head equals an H = 1 call on its slice bit
    for bit."""
    cmat, bmat, x, dt, cs = _ssd(np.random.default_rng(6), 2, 6, 300, 128,
                                 64, cuda)
    lone = [ops.ssd_diag(cmat, bmat, x[:, hd:hd + 1].contiguous(),
                         dt[:, hd:hd + 1].contiguous(),
                         cs[:, hd:hd + 1].contiguous()) for hd in range(6)]
    lib = _build.library()
    for group in (6, 3, 2, 1):
        y = torch.empty_like(x)
        plan = SD.ssd_plan(2, 6, 300, 128, 64, group=group)
        assert SD.launch(lib, cmat, bmat, x, dt, cs, y, plan=plan) == 0
        for hd in range(6):
            assert torch.equal(y[:, hd:hd + 1], lone[hd]), (group, hd)


@pytest.mark.parametrize("bc,h,q,n,p", [(2, 3, 256, 20, 64),
                                        (1, 4, 300, 128, 64),
                                        (2, 5, 300, 20, 72),
                                        (1, 2, 70, 256, 16)])
def test_ssd_diag_narrow_state_and_long_chunks(cuda, bc, h, q, n, p):  # noqa: F811
    """N = 20 (depth not a multiple of the MMA step), Q = 300 (a second
    score window), N = 256 (two depth chunks), steep decays included."""
    cmat, bmat, x, dt, cs = _ssd(np.random.default_rng(q + n), bc, h, q, n,
                                 p, cuda)
    for c in (cs, cs * 40.0):
        got = ops.ssd_diag(cmat, bmat, x, dt, c)
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, SD.ssd_diag_plain(cmat, bmat, x, dt,
                                                          c), **LM_TOL)
