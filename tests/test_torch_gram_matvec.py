"""The Gram matvec K(X, X) v of the port's engines (``ops.gram_matvec``,
one launch of the fused tensor-core kernel on the card, K never written)
against the JAX reference engine's ``matvec``, and the block route's
launch plan.

On the CPU the engines run the kernel's plain version,
``rbf_gram.gram_matvec_plain``: ``chunk``-row blocks of the Gram times v,
the composition the engines ran before the fused kernel, so their bits
do not move. The reference runs its chunked backend, and its pallas
backend in interpret mode (as tests/test_kernels_pallas.py runs it).

Tolerance: GRAM_TOL (rtol 2e-5, atol 2e-6, tests/test_kernels_pallas.py)
on each term K_rc v_c of a row's sum, summed over the row:

    |got_r - want_r| <= 2e-5 sum_c |K_rc v_c| + 2e-6 sum_c |v_c|

with |K| in float64 from the operands rounded to the compute precision.
The CUDA kernel is held to the same bound against a float64 sum on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import kernel_engine as JKE
from repro.core import kernels as JK
from repro_torch.core import kernel_engine as TKE
from repro_torch.core import kernels as TK
from repro_torch.kernels import ops
from repro_torch.kernels import rbf_gram as G
from torch_helpers import np_, tt

GAMMA = 0.05


def _rounded(x: np.ndarray, dtype: str) -> np.ndarray:
    """x as the compute precision sees it, in float64."""
    t = torch.from_numpy(x)
    if dtype == "bf16":
        t = t.to(torch.bfloat16)
    return t.to(torch.float64).numpy()


def _abs_terms(x: np.ndarray, v: np.ndarray, mode: str,
               dtype: str) -> np.ndarray:
    """sum_c |K_rc v_c| for every row r, in float64."""
    xr = _rounded(x, dtype)
    dot = xr @ xr.T
    if mode == "rbf":
        x2 = (xr * xr).sum(1)
        k = np.exp(-GAMMA * np.maximum(x2[:, None] + x2[None, :] - 2 * dot,
                                       0.0))
    else:
        k = dot
    return np.abs(k) @ np.abs(v.astype(np.float64))


def _assert_matvec_close(got, want, x, v, mode, dtype):
    bound = (2e-5 * _abs_terms(x, v, mode, dtype)
             + 2e-6 * np.abs(v.astype(np.float64)).sum())
    err = np.abs(np_(got).astype(np.float64) - np_(want).astype(np.float64))
    assert (err <= bound).all(), float((err / bound).max())


def _engines(x, mode, dtype, backend="chunked", chunk=64):
    kw = dict(name=mode, gamma=GAMMA)
    cfg = dict(chunk=chunk, gram_dtype=dtype)
    jeng = JKE.make_engine(jnp.asarray(x), JK.KernelParams(**kw),
                           JKE.EngineConfig(backend=backend, **cfg))
    teng = TKE.make_engine(tt(x), TK.KernelParams(**kw),
                           TKE.EngineConfig(backend="pallas", **cfg))
    return jeng, teng


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("mode", ["rbf", "linear"])
@pytest.mark.parametrize("n,d", [(1, 1), (37, 7), (150, 102), (129, 7),
                                 (64, 1)])
def test_pallas_engine_matvec_matches_reference(n, d, mode, dtype):
    rng = np.random.default_rng(n * 100 + d)
    x = rng.normal(size=(n, d)).astype(np.float32)
    v = rng.normal(size=n).astype(np.float32)
    jeng, teng = _engines(x, mode, dtype)
    _assert_matvec_close(teng.matvec(tt(v)), jeng.matvec(jnp.asarray(v)),
                         x, v, mode, dtype)


@pytest.mark.parametrize("mode", ["rbf", "linear"])
def test_matvec_matches_reference_pallas_interpret(mode):
    """The reference's pallas backend (its Gram kernel in interpret
    mode), ragged against its 64-row blocks."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(130, 102)).astype(np.float32)
    v = rng.normal(size=130).astype(np.float32)
    jeng, teng = _engines(x, mode, "fp32", backend="pallas")
    _assert_matvec_close(teng.matvec(tt(v)), jeng.matvec(jnp.asarray(v)),
                         x, v, mode, "fp32")


def _bucket(rng, widths, w, d):
    """len(widths) tasks zero-padded to width w (dist._bucket_arrays'
    layout), with v 0 past each task."""
    x = np.zeros((len(widths), w, d), np.float32)
    v = np.zeros((len(widths), w), np.float32)
    for t, k in enumerate(widths):
        x[t, :k] = rng.normal(size=(k, d))
        v[t, :k] = rng.normal(size=k)
    return x, v


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("mode", ["rbf", "linear"])
@pytest.mark.parametrize("widths,w,d", [((90, 17, 1), 90, 102),
                                        ((5, 5), 5, 7), ((70, 3), 70, 1)])
def test_task_engine_matvec_matches_reference(widths, w, d, mode, dtype):
    """A bucket's matvec (one task-axis call) against the reference
    engine on each task's zero-padded rows."""
    rng = np.random.default_rng(sum(widths) + d)
    x, v = _bucket(rng, widths, w, d)
    kp = TK.KernelParams(name=mode, gamma=GAMMA)
    teng = TKE.TaskKernelEngine(tt(x), kp, TKE.EngineConfig(
        backend="pallas", chunk=64, gram_dtype=dtype))
    got = teng.matvec(tt(v))
    assert got.shape == (len(widths), w)
    for t in range(len(widths)):
        jeng, _ = _engines(x[t], mode, dtype)
        _assert_matvec_close(got[t], jeng.matvec(jnp.asarray(v[t])), x[t],
                             v[t], mode, dtype)
        assert torch.equal(got[t], teng.tasks[t].matvec(tt(v[t])))


def test_engine_matvec_keeps_the_blockwise_bits():
    """On the CPU the pallas engine's matvec is the composition it ran
    before the fused kernel, bit for bit: chunk-row Gram blocks times v."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(300, 102)).astype(np.float32)
    v = tt(rng.normal(size=300))
    for dtype in ("fp32", "bf16"):
        _, eng = _engines(x, "rbf", dtype, chunk=128)
        want = torch.cat([
            ops.rbf_gram(eng._xk[s:s + 128], eng._xk, gamma=GAMMA,
                         compute_dtype=dtype, a2=eng._x2[s:s + 128],
                         b2=eng._x2) @ v
            for s in range(0, 300, 128)])
        assert torch.equal(eng.matvec(v), want)


@pytest.mark.parametrize("mode", ["rbf", "linear"])
def test_plain_task_axis_equals_lone_calls(mode):
    rng = np.random.default_rng(2)
    x, v = _bucket(rng, (40, 33, 1, 2), 40, 7)
    xt, vt = tt(x), tt(v)
    x2 = TK.sqnorms(xt)
    got = G.gram_matvec_plain(xt, x2, vt, gamma=GAMMA, mode=mode, chunk=16)
    for t in range(4):
        assert torch.equal(got[t], G.gram_matvec_plain(
            xt[t], x2[t], vt[t], gamma=GAMMA, mode=mode, chunk=16))
    ops.reset_launches()
    assert torch.equal(ops.gram_matvec(xt, x2, vt, gamma=GAMMA, mode=mode,
                                       chunk=16), got)
    assert ops.launches["rbf_gram_matvec"] == 0   # CPU tensors: plain


def test_gram_matvec_checks_its_operands():
    x = torch.zeros((5, 3))
    x2, v = torch.zeros(5), torch.zeros(5)
    with pytest.raises(ValueError, match="x2 must be"):
        ops.gram_matvec(x, torch.zeros(4), v)
    with pytest.raises(ValueError, match="v must be"):
        ops.gram_matvec(x, x2, torch.zeros(5, dtype=torch.float64))
    with pytest.raises(ValueError, match="x must be"):
        ops.gram_matvec(torch.zeros(5), x2, v)
    with pytest.raises(ValueError, match="unknown kernel mode"):
        ops.gram_matvec(x, x2, v, mode="poly")
    with pytest.raises(ValueError, match="several devices"):
        ops.gram_matvec(x, x2, v.to("meta"))


SHAPES = [1, 2, 31, 32, 33, 64, 65, 128, 129, 300, 2048, 4099, 7430, 29491]
DEPTHS = [1, 2, 7, 8, 9, 102, 128, 129, 247, 256, 257, 300, 784]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("entry", G.ENTRIES)
def test_gram_plan_is_feasible(entry, dtype):
    """Every plan fits the 227 KB of shared memory a block may opt in to
    (with a ring of 3 column stages where they fit), its row tiles and
    column tiles cover n and m with no empty group, and its depth is
    padded to the MMA step and covers d."""
    epw = 2 if dtype == torch.bfloat16 else 1
    for n in SHAPES:
        for m in (SHAPES if entry == "block" else [n]):
            for d in DEPTHS:
                for tasks, sms in ((1, 132), (36, 132), (9, 114)):
                    if entry == "block" and tasks > 1:
                        continue
                    p = G.gram_plan(n, m, d, dtype, tasks, entry, sms)
                    assert p.route == G.route_of(d, dtype, entry)
                    if p.route == "wgmma":   # its own fixed layout
                        assert (p.rows, p.smem_bytes) == (128, G.WG_SMEM)
                        assert p.grid == (-(-n // 128), tasks)
                        assert d <= G.WG_MAX_WORDS
                        continue
                    assert p.rows in G.ROWS and p.stages in G.STAGES
                    assert p.smem_bytes == G.smem_bytes(
                        p.rows, p.chunk, p.chunks, p.stages, entry)
                    assert p.smem_bytes <= 232448
                    assert p.stages == 3 or G.smem_bytes(
                        p.rows, p.chunk, p.chunks, 3, entry) > 232448
                    assert p.chunk % G.KSTEP == 0 and p.chunk <= G.MAX_CHUNK
                    assert p.chunks == 1 or p.chunk == G.CHUNK
                    assert p.chunk * p.chunks * epw >= d
                    assert (p.chunk * (p.chunks - 1) * epw < d
                            or p.chunk == G.KSTEP)
                    assert (p.grid[0] - 1) * p.rows < n <= p.grid[0] * p.rows
                    tiles = -(-m // G.COLS)
                    per = -(-tiles // p.groups)
                    assert p.groups * per >= tiles > (p.groups - 1) * per
                    if entry == "matvec":
                        assert p.groups == 1 and p.grid[1] == tasks
                    else:
                        assert p.grid[1] == p.groups <= 65535


def test_gram_plan_fills_the_card_and_rejects_bad_asks():
    p = G.gram_plan(2048, 29491, 102)
    assert p.grid[0] * p.grid[1] <= 132 and p.grid[0] * p.grid[1] >= 100
    assert (p.chunk, p.chunks, p.stages) == (104, 1, 2)
    assert G.gram_plan(29491, 29491, 102, entry="matvec").route == "wgmma"
    assert G.gram_plan(29491, 29491, 102, torch.bfloat16,
                       entry="matvec").stages == 3
    assert G.gram_plan(2048, 29491, 102, torch.bfloat16).chunk == 56
    assert G.gram_plan(29491, 29491, 102, entry="matvec").grid == (231, 1)
    assert G.gram_plan(7430, 7430, 102, tasks=36,
                       entry="matvec").grid == (59, 36)
    with pytest.raises(ValueError, match="square"):
        G.gram_plan(5, 6, 3, entry="matvec")
    with pytest.raises(ValueError, match="rows must be"):
        G.gram_plan(5, 5, 3, rows=48)
    with pytest.raises(ValueError, match="unknown entry"):
        G.gram_plan(5, 5, 3, entry="row")


def test_staged_layout_keeps_values_and_cpu_tensors():
    """``staged`` pads rows to 16 bytes on the card only; on the CPU (the
    plain path) it returns its argument, so the engines' CPU bits do not
    move."""
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    assert G.staged(x) is x
    t = TKE.make_engine(x, TK.KernelParams(gamma=GAMMA), "pallas")
    assert t._xs is t._xk
