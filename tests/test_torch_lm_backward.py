"""The gradients of the two LM-substrate kernels on the CPU: the plain
backward versions (``flash_attn.flash_attention_bwd_plain``,
``ssd_diag.ssd_diag_bwd_plain``), which ``ops``' autograd Functions run
on CPU tensors and which the CUDA backward kernels are held against on
the card (``tests/test_torch_cuda_lm.py``, ``chip_smoke.py``).

* Against ``jax.grad`` of the reference's functions, float32: the
  oracles ``repro/kernels/ref.py::flash_attention`` (one head a row, no
  grouped heads) and ``::ssd_diag``, and ``repro/models/layers.py::
  full_attention`` (the (B, S, H, D) layout with grouped-query heads,
  the function the reference's train step differentiates). Bound:
  rtol 1e-5, and an atol of 1e-5 of the reference gradient's largest
  magnitude (float32 round-off where an entry cancels to near 0).
* Against ``torch.autograd`` of the port's plain forwards in float64,
  at 1e-10 (the same atol reading): the formulas, not round-off.
* ``ops.FlashAttention`` and ``ops.SsdDiag`` (CPU tensors) through
  ``torch.autograd.gradcheck`` at a tiny float64 size; and
  ``ops.flash_attention`` / ``ops.ssd_diag`` of float32 operands give
  the plain backward's bits.

Shapes cover grouped-query heads, causal and bidirectional attention,
a ragged S (37, 45) and an SSD chunk of Q = 20, not a multiple of 16.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import layers as JL
from repro_torch.kernels import flash_attn as FA
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_diag as SD

F32_TOL = 1e-5
F64_TOL = 1e-10


def close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def attn_inputs(b, s, h, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for shape in
            ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, h, d))]


def plain_grads(q, k, v, do, causal, dtype=torch.float32):
    """The plain backward at the plain forward's output and lse."""
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in (q, k, v, do))
    o = FA.flash_attention_plain(q, k, v, causal=causal, out_dtype=dtype)
    lse = FA.attention_lse_plain(q, k, causal=causal)
    return FA.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)


@pytest.mark.parametrize("s", [37, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_plain_matches_jax_grad_of_ref_oracle(s, causal):
    """ref.py's oracle takes (BH, S, d), one head a row: B = 1, H = Hkv."""
    q, k, v, do = attn_inputs(1, s, 3, 3, 16, seed=s)

    def rows(a):   # (1, S, H, d) -> (H, S, d)
        return jnp.asarray(a[0].transpose(1, 0, 2))

    def loss(q_, k_, v_):
        return jnp.sum(jref.flash_attention(q_, k_, v_, causal=causal)
                       * rows(do))
    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        rows(q), rows(k), rows(v))
    got = plain_grads(q, k, v, do, causal)
    for g, w in zip(got, want):
        close(g.numpy()[0].transpose(1, 0, 2), w, F32_TOL)


@pytest.mark.parametrize("b,s,h,hkv,d", [
    (2, 45, 4, 2, 8), (1, 32, 4, 1, 16), (2, 20, 2, 2, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_plain_matches_jax_grad_of_full_attention(
        b, s, h, hkv, d, causal):
    q, k, v, do = attn_inputs(b, s, h, hkv, d, seed=b * s + h + hkv)

    def loss(q_, k_, v_):
        return jnp.sum(JL.full_attention(q_, k_, v_, causal=causal)
                       * jnp.asarray(do))
    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = plain_grads(q, k, v, do, causal)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        close(g.numpy(), w, F32_TOL)


@pytest.mark.parametrize("b,s,h,hkv,d", [(2, 37, 4, 2, 8), (1, 20, 2, 1, 5)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_plain_matches_autograd_float64(b, s, h, hkv, d, causal):
    q, k, v, do = attn_inputs(b, s, h, hkv, d, seed=7 + s)
    got = plain_grads(q, k, v, do, causal, torch.float64)
    leaves = [torch.from_numpy(a).double().requires_grad_()
              for a in (q, k, v)]
    out = FA.flash_attention_plain(*leaves, causal=causal,
                                   out_dtype=torch.float64)
    want = torch.autograd.grad(out, leaves, torch.from_numpy(do).double())
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        close(g.numpy(), w.numpy(), F64_TOL)


def test_flash_lse_and_fully_masked_rows():
    """lse is the natural-log logsumexp of the scaled, masked scores; a
    row that sees no key (none under causal self-attention: here one
    forced by a -inf score) gets +inf, so its P is 0."""
    q, k, _, _ = attn_inputs(1, 9, 2, 1, 4, seed=3)
    q, k = torch.from_numpy(q), torch.from_numpy(k)
    lse = FA.attention_lse_plain(q, k, causal=True)
    kk = k.repeat_interleave(2, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) * 4 ** -0.5
    s = torch.where(torch.ones(9, 9).tril().bool(), s, -torch.inf)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=0, atol=0)
    out, lse_ops = ops.flash_attention_lse(q, k, k, causal=True)
    assert torch.equal(lse_ops, lse)
    assert torch.equal(out, ops.flash_attention(q, k, k, causal=True))
    q_inf = q.clone()
    q_inf[0, 0] = -torch.inf * torch.sign(k[0, 0, 0])   # row 0: score -inf
    assert torch.isinf(FA.attention_lse_plain(q_inf, k, causal=True)[
        0, :, 0]).all()


@pytest.mark.parametrize("causal", [True, False])
def test_ops_flash_attention_gradcheck(causal):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=shape)).requires_grad_()
               for shape in ((1, 6, 4, 3), (1, 6, 2, 3), (1, 6, 2, 3)))
    assert torch.autograd.gradcheck(
        lambda a, b_, c: ops.FlashAttention.apply(a, b_, c, causal,
                                                  torch.float64, True),
        (q, k, v))


@pytest.mark.parametrize("causal", [True, False])
def test_ops_flash_attention_backward_is_the_plain_backward(causal):
    q, k, v, do = attn_inputs(2, 21, 4, 2, 8, seed=11)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=causal)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    want = plain_grads(q, k, v, do, causal)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with torch.inference_mode():   # no gradient wanted: no graph
        assert not ops.flash_attention(*leaves).requires_grad


def ssd_inputs(bc, h, q, n, p, seed):
    """dt ~ U(1e-3, 0.1), A ~ -U(1, 8), cs the in-chunk cumsum of dt A
    (tests/test_kernels_pallas.py's draw)."""
    rng = np.random.default_rng(seed)
    dt = rng.uniform(0.001, 0.1, size=(bc, h, q)).astype(np.float32)
    a = -rng.uniform(1, 8, size=(h,)).astype(np.float32)
    cs = np.cumsum(dt * a[None, :, None], axis=2).astype(np.float32)
    return (rng.normal(size=(bc, q, n)).astype(np.float32),
            rng.normal(size=(bc, q, n)).astype(np.float32),
            rng.normal(size=(bc, h, q, p)).astype(np.float32), dt, cs,
            rng.normal(size=(bc, h, q, p)).astype(np.float32))


SSD_SHAPES = [(3, 2, 20, 8, 5), (2, 4, 32, 16, 8), (1, 3, 64, 4, 16)]


@pytest.mark.parametrize("bc,h,q,n,p", SSD_SHAPES)
def test_ssd_bwd_plain_matches_jax_grad_of_ref_oracle(bc, h, q, n, p):
    *ops_, dy = ssd_inputs(bc, h, q, n, p, seed=q + n)

    def loss(*args):
        return jnp.sum(jref.ssd_diag(*args) * jnp.asarray(dy))
    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        *(jnp.asarray(a) for a in ops_))
    got = SD.ssd_diag_bwd_plain(*(torch.from_numpy(a) for a in ops_),
                                torch.from_numpy(dy))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        close(g.numpy(), w, F32_TOL)


@pytest.mark.parametrize("bc,h,q,n,p", SSD_SHAPES)
def test_ssd_bwd_plain_matches_autograd_float64(bc, h, q, n, p):
    *ops_, dy = ssd_inputs(bc, h, q, n, p, seed=5 + q)
    leaves = [torch.from_numpy(a).double().requires_grad_() for a in ops_]
    want = torch.autograd.grad(SD.ssd_diag_plain(*leaves), leaves,
                               torch.from_numpy(dy).double())
    got = SD.ssd_diag_bwd_plain(*(t.detach() for t in leaves),
                                torch.from_numpy(dy).double())
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        close(g.numpy(), w.numpy(), F64_TOL)


def test_ops_ssd_diag_gradcheck():
    c, b, x, dt, cs, _ = ssd_inputs(2, 3, 5, 4, 3, seed=1)
    leaves = [torch.from_numpy(a).double().requires_grad_()
              for a in (c, b, x, dt, cs)]
    assert torch.autograd.gradcheck(ops.SsdDiag.apply, leaves)


def test_ops_ssd_diag_backward_is_the_plain_backward():
    *ops_, dy = ssd_inputs(2, 3, 20, 8, 5, seed=2)
    leaves = [torch.from_numpy(a).requires_grad_() for a in ops_]
    got = torch.autograd.grad(ops.ssd_diag(*leaves), leaves,
                              torch.from_numpy(dy))
    want = SD.ssd_diag_bwd_plain(*(torch.from_numpy(a) for a in ops_),
                                 torch.from_numpy(dy))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_backward_wrappers_check_shapes():
    q, k, v, do = (torch.from_numpy(a) for a in attn_inputs(1, 8, 2, 1, 4,
                                                           seed=0))
    lse = FA.attention_lse_plain(q, k, causal=True)
    with pytest.raises(ValueError, match="lse must be"):
        ops.flash_attention_bwd(q, k, v, q, lse[:, :, :4], do)
    with pytest.raises(ValueError, match="o and do"):
        ops.flash_attention_bwd(q, k, v, q[:, :4], lse, do)
    c, b, x, dt, cs, dy = (torch.from_numpy(a) for a in
                           ssd_inputs(1, 2, 8, 4, 3, seed=0))
    with pytest.raises(ValueError, match="dy must be"):
        ops.ssd_diag_bwd(c, b, x, dt, cs, dy[:, :1])
