"""The LM-substrate kernels of the port against the reference's Pallas
functions.

``ops.flash_attention`` (the shapes of
``tests/test_kernels_pallas.py::test_flash_attention_sweep``, causal and
not, with grouped-query heads and a ragged S = 300) and ``ops.ssd_diag``
(its three shapes) are fed the same numpy inputs as
``repro.kernels.ops.flash_attention`` and
``repro.kernels.ssd_diag.ssd_diag_pallas``, which run here as the
reference's own tests run them on the CPU (Pallas interpret mode). The
port's wrappers run their plain versions on CPU tensors; the CUDA
kernels are held against those on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). Bound: rtol 2e-4, atol 2e-5, the reference's.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ssd_diag as jsd
from repro_torch.kernels import ops as tops
from torch_helpers import np_, tt

LM_TOL = dict(rtol=2e-4, atol=2e-5)


def _qkv(b, s, h, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, d)).astype(np.float32),
            rng.normal(size=(b, s, hkv, d)).astype(np.float32),
            rng.normal(size=(b, s, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("b,s,h,hkv,d", [
    (2, 256, 4, 4, 64), (1, 512, 4, 2, 64), (2, 300, 2, 2, 32),
    (1, 128, 8, 1, 16),
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_reference(b, s, h, hkv, d, causal):
    q, k, v = _qkv(b, s, h, hkv, d, seed=s + h)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal)
    got = tops.flash_attention(tt(q), tt(k), tt(v), causal=causal)
    assert got.shape == (b, s, h, d) and got.dtype == torch.float32
    np.testing.assert_allclose(np_(got), np_(want), **LM_TOL)


def test_flash_attention_output_dtype_and_checks():
    q, k, v = (tt(a).to(torch.bfloat16) for a in _qkv(1, 40, 4, 2, 8, 0))
    out = tops.flash_attention(q, k, v)
    assert out.dtype == torch.bfloat16
    f32 = tops.flash_attention(q, k, v, out_dtype=torch.float32)
    assert torch.equal(out, f32.to(torch.bfloat16))   # rounded once
    with pytest.raises(ValueError, match="multiple of Hkv"):
        tops.flash_attention(q, k[:, :, :1].expand(-1, -1, 3, -1),
                             v[:, :, :1].expand(-1, -1, 3, -1))
    with pytest.raises(ValueError, match="share a dtype"):
        tops.flash_attention(q, k.float(), v)
    with pytest.raises(ValueError, match="out_dtype"):
        tops.flash_attention(q, k, v, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="out_dtype"):
        tops.flash_attention(q.float(), k.float(), v.float(),
                             out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"\(B, S, H, D\)"):
        tops.flash_attention(q[0], k, v)


def _ssd_inputs(bc, h, q, n, p, seed, steep=1.0):
    rng = np.random.default_rng(seed)
    cmat = rng.normal(size=(bc, q, n)).astype(np.float32)
    bmat = rng.normal(size=(bc, q, n)).astype(np.float32)
    x = rng.normal(size=(bc, h, q, p)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, size=(bc, h, q)).astype(np.float32)
    a = -rng.uniform(1, 8, size=(h,)).astype(np.float32) * steep
    cs = np.cumsum(dt * a[None, :, None], axis=2).astype(np.float32)
    return cmat, bmat, x, dt, cs


@pytest.mark.parametrize("bc,h,q,n,p", [
    (2, 3, 32, 16, 8), (1, 4, 64, 32, 16), (3, 2, 128, 16, 32),
])
@pytest.mark.parametrize("steep", [1.0, 40.0])
def test_ssd_diag_matches_reference(bc, h, q, n, p, steep):
    """``steep`` decays make exp(cs_q - cs_k) overflow above the
    diagonal: both select it away, and nothing turns to NaN."""
    args = _ssd_inputs(bc, h, q, n, p, seed=q + n, steep=steep)
    want = jsd.ssd_diag_pallas(*(jnp.asarray(a) for a in args))
    got = tops.ssd_diag(*(tt(a) for a in args))
    assert got.shape == (bc, h, q, p)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(np_(got), np_(want), **LM_TOL)


def test_ssd_diag_checks_and_counts_no_cpu_launches():
    args = [tt(a) for a in _ssd_inputs(1, 2, 16, 4, 3, seed=0)]
    with pytest.raises(ValueError, match="dt must be"):
        tops.ssd_diag(*args[:3], args[3][:, :1], args[4])
    with pytest.raises(ValueError, match="does not fit"):
        tops.ssd_diag(args[0], args[1], args[2][:, :, :8], args[3], args[4])
    tops.reset_launches()
    tops.ssd_diag(*args)
    tops.flash_attention(*(tt(a) for a in _qkv(1, 8, 2, 1, 4, 1)))
    assert tops.launches["ssd_diag"] == tops.launches["flash_attention"] == 0
    assert {"flash_attention", "ssd_diag"} <= set(tops.KERNELS)
