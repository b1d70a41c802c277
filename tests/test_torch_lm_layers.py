"""The LM substrate's functions in the port against the reference's, on
the CPU, from the same numpy-seeded inputs, in float32 at the
reference's LM bound (rtol 2e-4, atol 2e-5): ``rmsnorm``, ``rope``,
``sinusoidal_positions``, the causal convolution, ``ssd_decode_step``,
``ssd_chunked`` (its intra-chunk term through ``ops.ssd_diag``'s plain
version), that term against the reference's ``ssd_diag_pallas`` in
interpret mode, and attention: ``attention_any`` and the flash call it
makes on the card (``ops.flash_attention``'s plain version here) against
the reference's ``full_attention``, ``chunked_attention`` and Pallas
``ops.flash_attention``. Also the dispatch rule: which attention calls
of a prefill, a forward and a decode step would take the flash kernel
on a card.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ssd_diag as jsd
from repro.models import layers as JL
from repro.models import mamba2 as JM
from repro.models import runtime as JRT
from repro_torch.configs.base import get_config, reduced
from repro_torch.kernels import ops as tops
from repro_torch.models import layers as TL
from repro_torch.models import mamba2 as TM
from repro_torch.models import runtime as TRT
from repro_torch.models.model import Model
from torch_helpers import FLASH_CALLS, np_, tt

LM_TOL = dict(rtol=2e-4, atol=2e-5)


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def test_rmsnorm_and_positions_match_reference():
    rng = np.random.default_rng(0)
    x, w = _normal(rng, 2, 7, 48), _normal(rng, 48, scale=0.1)
    np.testing.assert_allclose(
        np_(TL.rmsnorm(tt(x), tt(w), 1e-5)),
        np_(JL.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5)), **LM_TOL)
    for offset in (0, 37):
        np.testing.assert_allclose(
            np_(TL.sinusoidal_positions(9, 48, offset=offset)),
            np_(JL.sinusoidal_positions(9, 48, offset=offset)), **LM_TOL)


@pytest.mark.parametrize("shape", [(2, 11, 3, 32), (2, 11, 16)])
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_reference(shape, theta):
    rng = np.random.default_rng(1)
    x = _normal(rng, *shape)
    pos = np.broadcast_to(np.arange(5, 5 + shape[1]), shape[:2])
    np.testing.assert_allclose(
        np_(TL.rope(tt(x), torch.from_numpy(pos.copy()), theta)),
        np_(JL.rope(jnp.asarray(x), jnp.asarray(pos), theta)), **LM_TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(2)
    x, w = _normal(rng, 2, 9, 12), _normal(rng, 4, 12, scale=0.1)
    state = _normal(rng, 2, 3, 12) if with_state else None
    y, st = TM._causal_conv(tt(x), tt(w),
                            state=tt(state) if with_state else None)
    jy, jst = JM._causal_conv(jnp.asarray(x), jnp.asarray(w),
                              state=jnp.asarray(state) if with_state
                              else None)
    np.testing.assert_allclose(np_(y), np_(jy), **LM_TOL)
    np.testing.assert_array_equal(np_(st), np_(jst))


def _ssd_inputs(rng, b, s, h, p, n):
    x = _normal(rng, b, s, h, p)
    dt = np.log1p(np.exp(_normal(rng, b, s, h) - 3.0)).astype(np.float32)
    a = -rng.uniform(1.0, 16.0, size=(h,)).astype(np.float32)
    bmat, cmat = _normal(rng, b, s, 1, n), _normal(rng, b, s, 1, n)
    return x, dt, a, bmat, cmat


def test_ssd_decode_step_matches_reference():
    rng = np.random.default_rng(3)
    x, dt, a, bmat, cmat = _ssd_inputs(rng, 2, 1, 4, 8, 16)
    state = _normal(rng, 2, 4, 16, 8)
    args = (x[:, 0], dt[:, 0], a, bmat[:, 0], cmat[:, 0], state)
    y, st = TM.ssd_decode_step(*(tt(v) for v in args))
    jy, jst = JM.ssd_decode_step(*(jnp.asarray(v) for v in args))
    np.testing.assert_allclose(np_(y), np_(jy), **LM_TOL)
    np.testing.assert_allclose(np_(st), np_(jst), **LM_TOL)


@pytest.mark.parametrize("s,chunk", [(64, 32), (96, 32), (40, 40)])
@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_chunked_matches_reference(s, chunk, with_init):
    """The whole chunked scan (y and the final state), its intra-chunk
    term through ``ops.ssd_diag`` (the plain version on the CPU, counted
    as no launch)."""
    rng = np.random.default_rng(s + chunk)
    x, dt, a, bmat, cmat = _ssd_inputs(rng, 2, s, 3, 8, 16)
    init = _normal(rng, 2, 3, 16, 8) if with_init else None
    tops.reset_launches()
    y, final = TM.ssd_chunked(tt(x), tt(dt), tt(a), tt(bmat), tt(cmat),
                              chunk=chunk,
                              init_state=tt(init) if with_init else None)
    assert tops.launches["ssd_diag"] == 0
    jy, jfinal = JM.ssd_chunked(
        jnp.asarray(x), jnp.asarray(dt), jnp.asarray(a), jnp.asarray(bmat),
        jnp.asarray(cmat), chunk=chunk,
        init_state=jnp.asarray(init) if with_init else None)
    np.testing.assert_allclose(np_(y), np_(jy), **LM_TOL)
    np.testing.assert_allclose(np_(final), np_(jfinal), **LM_TOL)


def test_ssd_chunked_refuses_ragged_sequences_and_groups():
    rng = np.random.default_rng(4)
    x, dt, a, bmat, cmat = (tt(v) for v in _ssd_inputs(rng, 1, 40, 2, 4, 8))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        TM.ssd_chunked(x, dt, a, bmat, cmat, chunk=32)
    with pytest.raises(ValueError, match="groups"):
        TM.ssd_chunked(x, dt, a, bmat.expand(-1, -1, 2, -1),
                       cmat.expand(-1, -1, 2, -1), chunk=40)


@pytest.mark.parametrize("b,nc,q,h,p,n", [(2, 2, 32, 3, 8, 16),
                                          (1, 3, 64, 4, 16, 32)])
def test_intra_chunk_term_matches_pallas_kernel(b, nc, q, h, p, n):
    """``ssd_diag_chunks`` (the model's reshape into ``ops.ssd_diag``'s
    operands and back) against the reference's Pallas kernel in
    interpret mode on the same chunk operands."""
    rng = np.random.default_rng(q + n)
    x, dt, a, bmat, cmat = _ssd_inputs(rng, b, nc * q, h, p, n)
    xr = x.reshape(b, nc, q, h, p)
    dtr = dt.reshape(b, nc, q, h)
    br = bmat.reshape(b, nc, q, n)
    cr = cmat.reshape(b, nc, q, n)
    cs = np.cumsum(dtr * a, axis=2).astype(np.float32)
    got = TM.ssd_diag_chunks(tt(xr), tt(dtr), tt(br), tt(cr), tt(cs))
    bc = b * nc
    want = jsd.ssd_diag_pallas(
        jnp.asarray(cr.reshape(bc, q, n)), jnp.asarray(br.reshape(bc, q, n)),
        jnp.asarray(xr.transpose(0, 1, 3, 2, 4).reshape(bc, h, q, p)),
        jnp.asarray(dtr.transpose(0, 1, 3, 2).reshape(bc, h, q)),
        jnp.asarray(cs.transpose(0, 1, 3, 2).reshape(bc, h, q)))
    want = np_(want).reshape(b, nc, h, q, p).transpose(0, 1, 3, 2, 4)
    assert got.shape == (b, nc, q, h, p)
    np.testing.assert_allclose(np_(got), want, **LM_TOL)


def _qkv(rng, b, sq, sk, h, hkv, d, dv=None):
    return (_normal(rng, b, sq, h, d), _normal(rng, b, sk, hkv, d),
            _normal(rng, b, sk, hkv, dv or d))


ATTN_CASES = [
    dict(),                                   # causal prefill
    dict(causal=False),                       # whisper's encoder
    dict(window=5),                           # gemma3's local layers
    dict(causal=False, kv_valid_len=13),      # a decode step's cache
    dict(softcap=30.0),
    dict(q_offset=3),
]


@pytest.mark.parametrize("kw", ATTN_CASES)
def test_attention_any_matches_reference(kw):
    """On the CPU ``attention_any`` follows the reference: here
    ``full_attention`` (below the chunked threshold)."""
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, 2, 24, 24, 4, 2, 16)
    got = TL.attention_any(tt(q), tt(k), tt(v), **kw)
    want = JL.attention_any(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            **kw)
    np.testing.assert_allclose(np_(got), np_(want), **LM_TOL)


@pytest.mark.parametrize("kw", [dict(), dict(causal=False), dict(window=9)])
def test_chunked_attention_matches_reference(kw, monkeypatch):
    """From ``CHUNKED_THRESHOLD`` query positions on, both packages take
    the online-softmax ``chunked_attention`` (chunks of 16 here), and
    agree with it and with the port's ``full_attention``."""
    monkeypatch.setattr(TRT, "CHUNKED_THRESHOLD", 32)
    monkeypatch.setattr(JRT, "CHUNKED_THRESHOLD", 32)
    rng = np.random.default_rng(6)
    q, k, v = _qkv(rng, 2, 48, 48, 4, 2, 16)
    got = TL.chunked_attention(tt(q), tt(k), tt(v), chunk=16, **kw)
    want = JL.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), chunk=16, **kw)
    np.testing.assert_allclose(np_(got), np_(want), **LM_TOL)
    np.testing.assert_allclose(
        np_(TL.attention_any(tt(q), tt(k), tt(v), **kw)),
        np_(JL.attention_any(jnp.asarray(q), jnp.asarray(k),
                             jnp.asarray(v), **kw)), **LM_TOL)
    np.testing.assert_allclose(
        np_(got), np_(TL.full_attention(tt(q), tt(k), tt(v), **kw)),
        **LM_TOL)


@pytest.mark.parametrize("b,s,h,hkv,d", [(2, 40, 4, 2, 16), (2, 33, 6, 3, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_route_matches_reference(b, s, h, hkv, d, causal):
    """What ``attention_any`` calls on the card for an eligible call
    (``layers.flash``: ``ops.flash_attention``, its plain version here)
    against the reference's ``full_attention`` and ``chunked_attention``
    (the XLA functions the model computes) and its Pallas flash kernel
    in interpret mode."""
    rng = np.random.default_rng(s + d)
    q, k, v = _qkv(rng, b, s, s, h, hkv, d)
    tops.reset_launches()
    got = np_(TL.flash(tt(q), tt(k), tt(v), causal=causal))
    assert tops.launches["flash_attention"] == 0
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    np.testing.assert_allclose(
        got, np_(JL.full_attention(jq, jk, jv, causal=causal)), **LM_TOL)
    if s % 8 == 0:
        np.testing.assert_allclose(
            got, np_(JL.chunked_attention(jq, jk, jv, chunk=s // 2,
                                          causal=causal)), **LM_TOL)
    np.testing.assert_allclose(
        got, np_(jops.flash_attention(jq, jk, jv, causal=causal)),
        **LM_TOL)


# bf16 operands: the kernel route rounds its float32 result once, the
# reference rounds the softmax weights to bf16 before P V and sums in
# bf16 products; they agree to bf16 rounding of O(1) outputs
BF16_ATTN_ATOL = 1.5e-2


def test_flash_route_bf16_within_bf16_rounding_of_reference():
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, 2, 64, 64, 4, 2, 32)
    got = TL.flash(*(tt(a).to(torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    want = JL.full_attention(*(jnp.asarray(a).astype(jnp.bfloat16)
                               for a in (q, k, v)))
    np.testing.assert_allclose(np_(got.float()),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=BF16_ATTN_ATOL)


def test_flash_eligible_rule(monkeypatch):
    rng = np.random.default_rng(8)
    q, k, v = (tt(a) for a in _qkv(rng, 1, 8, 8, 4, 2, 16))
    assert TL.flash_eligible(q, k, v)      # causal and bidirectional alike
    for kw in (dict(window=4), dict(q_offset=2), dict(kv_valid_len=5),
               dict(softcap=30.0)):
        assert not TL.flash_eligible(q, k, v, **kw), kw
    assert not TL.flash_eligible(q[:, :1], k, v)         # a decode step
    assert not TL.flash_eligible(q, k, v[..., :8])       # MLA's v dim
    wide = torch.zeros(1, 8, 2, tops.FLASH_MAX_D * 2)
    assert not TL.flash_eligible(wide, wide, wide)       # gemma3's D 256
    monkeypatch.setattr(TRT, "SCORES_BF16", True)
    assert not TL.flash_eligible(q, k, v)


@pytest.mark.parametrize("arch", sorted(FLASH_CALLS))
def test_which_calls_take_the_flash_kernel(arch, monkeypatch):
    cfg = reduced(get_config(arch))
    model = Model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    calls = []
    real = TL.flash_eligible

    def spy(*a, **kw):
        calls.append(real(*a, **kw))
        return calls[-1]
    monkeypatch.setattr(TL, "flash_eligible", spy)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (1, 32))}
    if cfg.arch_type == "vlm":
        batch["vision_embeds"] = np.zeros((1, cfg.vision_tokens,
                                           cfg.d_model), np.float32)
    if cfg.arch_type == "audio":
        batch["frames"] = np.zeros((1, cfg.encoder_frames, cfg.d_model),
                                   np.float32)
    tops.reset_launches()
    caches = model.cache_init(1, 40)
    logits, caches = model.prefill(batch, caches)
    assert sum(calls) == FLASH_CALLS[arch]
    model.forward(batch)
    assert sum(calls) == 2 * FLASH_CALLS[arch]
    n = len(calls)
    model.decode_step(logits.argmax(-1), caches)
    assert sum(calls[n:]) == 0
    # on the CPU nothing launches
    assert tops.launches["flash_attention"] == tops.launches["ssd_diag"] == 0
