"""Shared transformer building blocks of the LM substrate (the port of
``repro/models/layers.py``).

Conventions, as in the reference:

* Parameters are float32 ``nn.Parameter`` s; compute runs in bf16
  (``ACT_DTYPE``), each weight cast at its use, with float32
  softmax / norm accumulators.
* Every block has a train / prefill mode (the whole sequence, optionally
  writing a cache) and a decode mode (one token against the cache).
* A cache is a dict of tensors and ``len``, the positions written so
  far, kept as a host ``int`` so a decode step needs no device read.
  Prefill and decode write the cache's tensors in place and return it.

Attention: ``attention_any`` takes the hand-written flash kernel
(``kernels.ops.flash_attention``) for every call on the card that
``flash_eligible`` accepts — causal or bidirectional self-attention with
no window, offset, softcap or valid length, v shaped as k, D <= 128 —
at any length (the kernel is the online softmax ``chunked_attention``
computes). Every other call, and every call on the CPU, follows the
reference: ``full_attention`` below ``runtime.CHUNKED_THRESHOLD`` query
positions, ``chunked_attention`` from it on. The sharding hint
``wgather`` of the reference is the identity on one card and is left
out.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import runtime as RT

ACT_DTYPE = torch.bfloat16
F32 = torch.float32


# ------------------------------------------------------------------- init

def param(shape, device) -> nn.Parameter:
    """An uninitialised trainable float32 parameter; ``Model.init`` fills
    it. The serving entry points (``prefill``, ``decode_step``) run under
    ``torch.inference_mode`` and track no gradient."""
    return nn.Parameter(torch.empty(shape, dtype=F32, device=device))


def normal_(p: torch.Tensor, gen: torch.Generator, scale: float = 0.02):
    with torch.no_grad():
        p.normal_(0.0, scale, generator=gen)


def out_scale(cfg: ModelConfig) -> float:
    """Scale of the output projections: 0.02 / sqrt(2 n_layers)."""
    return 0.02 / (2 * cfg.n_layers) ** 0.5


def w(p: torch.Tensor) -> torch.Tensor:
    """A weight at its use: cast to the activation dtype."""
    return p.to(ACT_DTYPE)


# ------------------------------------------------------------------ norms

def rmsnorm(x: torch.Tensor, w_: torch.Tensor, eps: float = 1e-5):
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * (1.0 + w_)).to(x.dtype)


# ------------------------------------------------------------------- rope

def _inv_freq(half: int, theta: float, device) -> torch.Tensor:
    return theta ** (-torch.arange(0, half, dtype=F32, device=device) / half)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding. x: (..., S, H, D) or (..., S, D); positions
    (..., S)."""
    half = x.shape[-1] // 2
    ang = positions[..., None].to(F32) * _inv_freq(half, theta, x.device)
    if x.ndim == 4:  # (B, S, H, D): broadcast over heads
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].to(F32), x[..., half:].to(F32)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def sinusoidal_positions(seq_len: int, d: int, offset: int = 0,
                         device=None) -> torch.Tensor:
    pos = torch.arange(seq_len, device=device) + offset
    half = d // 2
    ang = pos[:, None].to(F32) * _inv_freq(half, 10_000.0, device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)  # (S, d)


# -------------------------------------------------------------- attention

def _gqa_scores(q, k, scale):
    """q (B,Sq,H,D), k (B,Sk,Hkv,D) -> scores (B,Hkv,G,Sq,Sk) float32
    (bf16 products are exact in float32, so this is the reference's
    ``preferred_element_type=float32``)."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    q = q.reshape(b, sq, hkv, h // hkv, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.to(F32), k.to(F32)) * scale
    if RT.SCORES_BF16:
        s = s.to(torch.bfloat16)
    return s


def _mask_bias(sq, sk, *, causal, window, q_offset, kv_valid_len=None,
               device=None):
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(sk, device=device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    if kv_valid_len is not None:
        ok &= kpos < kv_valid_len
    return torch.where(ok, 0.0, -torch.inf).to(F32)


def full_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                   kv_valid_len=None, softcap=0.0):
    """Materialized-scores attention (short sequences / decode)."""
    scale = q.shape[-1] ** -0.5
    scores = _gqa_scores(q, k, scale)
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    scores = scores + _mask_bias(q.shape[1], k.shape[1], causal=causal,
                                 window=window, q_offset=q_offset,
                                 kv_valid_len=kv_valid_len,
                                 device=q.device).to(scores.dtype)
    wts = torch.softmax(scores.to(F32), dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", wts, v)
    b, sq, hkv, g, d = out.shape
    return out.reshape(b, sq, hkv * g, d)


def chunked_attention(q, k, v, *, chunk=1024, causal=True, window=0,
                      q_offset=0):
    """Flash-style online softmax over KV chunks, O(Sq * chunk) score
    memory (the reference's XLA path for long prefill)."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]                       # may differ from d (MLA)
    chunk = min(chunk, sk)
    if sk % chunk:
        raise ValueError(f"chunked_attention: {sk} keys are not a multiple "
                         f"of the chunk {chunk}")
    g = h // hkv
    scale = d ** -0.5
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    m = torch.full((b, hkv, g, sq), -torch.inf, dtype=F32, device=q.device)
    l_ = torch.zeros((b, hkv, g, sq), dtype=F32, device=q.device)
    acc = torch.zeros((b, hkv, g, sq, dv), dtype=v.dtype, device=q.device)
    for c in range(sk // chunk):
        k_blk = k[:, c * chunk:(c + 1) * chunk]
        v_blk = v[:, c * chunk:(c + 1) * chunk]
        scores = _gqa_scores(q, k_blk, scale)          # (B,Hkv,G,Sq,chunk)
        kpos = c * chunk + torch.arange(chunk, device=q.device)[None, :]
        ok = torch.ones((sq, chunk), dtype=torch.bool, device=q.device)
        if causal:
            ok &= kpos <= qpos
        if window:
            ok &= kpos > qpos - window
        scores = scores + torch.where(ok, 0.0, -torch.inf).to(scores.dtype)
        m_new = torch.maximum(m, scores.amax(-1))
        # fully masked rows keep m = -inf: exp(0) = 1, but l stays 0
        m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)
        corr = torch.exp(torch.where(torch.isinf(m), m, m - m_safe))
        p = torch.exp(scores - m_safe[..., None])
        l_ = l_ * corr + p.sum(-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype), v_blk)
        acc = acc * corr[..., None].to(acc.dtype) + pv
        m = m_new
    out = acc / torch.clamp_min(l_, 1e-20)[..., None].to(acc.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv)


def flash_eligible(q, k, v, *, window=0, q_offset=0, kv_valid_len=None,
                   softcap=0.0) -> bool:
    """Whether ``attention_any`` hands this call to the flash kernel on
    the card: self-attention (Sq == Sk), causal or bidirectional alike,
    with no window, query offset, softcap or valid length, scores not
    kept in bf16, v shaped as k and a head dim the kernel holds."""
    return (q.shape[1] == k.shape[1] and not window and not q_offset
            and kv_valid_len is None and not softcap
            and not RT.SCORES_BF16 and v.shape == k.shape
            and q.shape[-1] <= ops.FLASH_MAX_D)


def flash(q, k, v, *, causal=True):
    """The flash kernel's call from ``attention_any`` (its plain version
    on CPU tensors): output in q's dtype, rounded once from float32."""
    return ops.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=bool(causal))


def attention_any(q, k, v, *, causal=True, **kw):
    if flash_eligible(q, k, v, **kw) and q.is_cuda:
        return flash(q, k, v, causal=causal)
    if q.shape[1] >= RT.CHUNKED_THRESHOLD and q.shape[1] == k.shape[1]:
        kw.pop("kv_valid_len", None)
        kw.pop("softcap", None)
        return chunked_attention(q, k, v, causal=causal, **kw)
    return full_attention(q, k, v, causal=causal, **kw)


# ------------------------------------------------------------ GQA block

class GQA(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        self.wq = param((d, h * dh), device)
        self.wk = param((d, hkv * dh), device)
        self.wv = param((d, hkv * dh), device)
        self.wo = param((h * dh, d), device)

    def init_(self, gen):
        for p in (self.wq, self.wk, self.wv):
            normal_(p, gen)
        normal_(self.wo, gen, out_scale(self.cfg))

    def forward(self, x, *, positions, causal=True, window=0,
                cache: Optional[dict] = None, cache_pos=None,
                update_cache=False):
        """Returns (out, cache). Modes: train (cache None); prefill
        (``update_cache``, a cache from ``gqa_cache_init``); decode (Sq
        = 1 against the cache, ``cache_pos`` the ring slot of a windowed
        layer)."""
        cfg = self.cfg
        b, sq, _ = x.shape
        h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        xb = x.to(ACT_DTYPE)
        q = (xb @ w(self.wq)).reshape(b, sq, h, dh)
        k = (xb @ w(self.wk)).reshape(b, sq, hkv, dh)
        v = (xb @ w(self.wv)).reshape(b, sq, hkv, dh)
        if cfg.rope_theta > 0:
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)

        if cache is not None and sq == 1:           # decode
            ck, cv = cache["k"], cache["v"]
            cap = ck.shape[1]
            # the reference's dynamic_update_slice clamps the slot
            slot = min(cache_pos if window else cache["len"], cap - 1)
            ck[:, slot] = k[:, 0]
            cv[:, slot] = v[:, 0]
            valid = min(cache["len"] + 1, cap)
            out = full_attention(q, ck, cv, causal=False, kv_valid_len=valid,
                                 softcap=cfg.logit_softcap)
            cache["len"] += 1
        else:                                        # train / prefill
            out = attention_any(q, k, v, causal=causal, window=window,
                                q_offset=0)
            if update_cache and cache is not None:
                cap = cache["k"].shape[1]
                if sq >= cap:
                    # ring buffer: position p lives at slot p % cap; the
                    # last cap keys land rolled by sq % cap so decode
                    # writes at slot len % cap stay consistent
                    shift = sq % cap
                    cache["k"].copy_(torch.roll(k[:, -cap:], shift, 1))
                    cache["v"].copy_(torch.roll(v[:, -cap:], shift, 1))
                else:
                    cache["k"][:, :sq] = k
                    cache["v"][:, :sq] = v
                cache["len"] += sq
        out = out.reshape(b, sq, h * dh) @ w(self.wo)
        return out.to(x.dtype), cache


def gqa_cache_init(cfg: ModelConfig, batch: int, max_len: int, *,
                   window: int = 0, device=None) -> dict:
    s = min(window, max_len) if window else max_len
    shape = (batch, s, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=ACT_DTYPE, device=device),
            "v": torch.zeros(shape, dtype=ACT_DTYPE, device=device),
            "len": 0}


# ------------------------------------------------------------- MLA block

def mla_heads(cfg: ModelConfig) -> int:
    if RT.MLA_PAD_HEADS:
        return -(-cfg.n_heads // 16) * 16
    return cfg.n_heads


class MLA(nn.Module):
    """Multi-head latent attention: prefill expands per-head K / V from
    the compressed c_kv; decode takes the absorbed path against the
    compressed cache."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        d, h = cfg.d_model, mla_heads(cfg)
        rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        self.wq_a = param((d, rq), device)
        self.q_norm = param((rq,), device)
        self.wq_b = param((rq, h * (dn + dr)), device)
        self.wkv_a = param((d, rkv + dr), device)
        self.kv_norm = param((rkv,), device)
        self.wkv_b = param((rkv, h * (dn + dv)), device)
        self.wo = param((h * dv, d), device)

    def init_(self, gen):
        cfg = self.cfg
        for p in (self.wq_a, self.wq_b, self.wkv_a, self.wkv_b):
            normal_(p, gen)
        normal_(self.wo, gen, out_scale(cfg))
        with torch.no_grad():
            self.q_norm.zero_()
            self.kv_norm.zero_()
            h = mla_heads(cfg)
            if h != cfg.n_heads:   # the dummy heads' output rows: zero
                self.wo.view(h, cfg.v_head_dim, -1)[cfg.n_heads:] = 0.0

    def _qkr(self, x, positions):
        """q_nope (B,S,H,dn), q_rope (B,S,H,dr), c_kv (B,S,rkv),
        k_rope (B,S,1,dr)."""
        cfg = self.cfg
        b, s, _ = x.shape
        h = mla_heads(cfg)
        dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
        xb = x.to(ACT_DTYPE)
        q = rmsnorm(xb @ w(self.wq_a), self.q_norm, cfg.norm_eps)
        q = (q @ w(self.wq_b)).reshape(b, s, h, dn + dr)
        q_nope, q_rope = q[..., :dn], q[..., dn:]
        kv = xb @ w(self.wkv_a)                              # (B,S,rkv+dr)
        c_kv = rmsnorm(kv[..., :cfg.kv_lora_rank], self.kv_norm,
                       cfg.norm_eps)
        k_rope = kv[..., cfg.kv_lora_rank:][:, :, None, :]   # (B,S,1,dr)
        q_rope = rope(q_rope, positions, cfg.rope_theta)
        k_rope = rope(k_rope, positions, cfg.rope_theta)
        return q_nope, q_rope, c_kv, k_rope

    def forward(self, x, *, positions, cache: Optional[dict] = None,
                update_cache=False):
        cfg = self.cfg
        b, sq, _ = x.shape
        h = mla_heads(cfg)
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        rkv = cfg.kv_lora_rank
        scale = (dn + dr) ** -0.5
        q_nope, q_rope, c_kv, k_rope = self._qkr(x, positions)
        wkv_b = w(self.wkv_b).reshape(rkv, h, dn + dv)
        w_uk, w_uv = wkv_b[..., :dn], wkv_b[..., dn:]

        if cache is not None and sq == 1:  # ---- absorbed decode
            slot = min(cache["len"], cache["ckv"].shape[1] - 1)
            ckv, krp = cache["ckv"], cache["krope"]
            ckv[:, slot] = c_kv[:, 0]
            krp[:, slot] = k_rope[:, 0, 0]
            q_c = torch.einsum("bqhn,rhn->bqhr", q_nope, w_uk)
            s_c = torch.einsum("bqhr,bkr->bhqk", q_c.to(F32), ckv.to(F32))
            s_r = torch.einsum("bqhd,bkd->bhqk", q_rope.to(F32),
                               krp.to(F32))
            scores = (s_c + s_r) * scale
            valid = (torch.arange(ckv.shape[1], device=x.device)
                     < cache["len"] + 1)
            scores = torch.where(valid, scores, -torch.inf)
            wts = torch.softmax(scores, -1).to(ACT_DTYPE)
            ctx = torch.einsum("bhqk,bkr->bqhr", wts, ckv)
            out = torch.einsum("bqhr,rhv->bqhv", ctx, w_uv)
            cache["len"] += 1
        else:  # ---- train / prefill: expand per-head K and V
            kv = torch.einsum("bkr,rhe->bkhe", c_kv, wkv_b)
            k_nope, v = kv[..., :dn], kv[..., dn:]
            k = torch.cat([k_nope, k_rope.expand(b, sq, h, dr)], -1)
            q = torch.cat([q_nope, q_rope], -1)
            out = attention_any(q, k, v, causal=True)
            if update_cache and cache is not None:
                cache["ckv"][:, :sq] = c_kv
                cache["krope"][:, :sq] = k_rope[:, :, 0]
                cache["len"] += sq
        out = out.reshape(b, sq, h * dv) @ w(self.wo)
        return out.to(x.dtype), cache


def mla_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                   device=None) -> dict:
    return {"ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                               dtype=ACT_DTYPE, device=device),
            "krope": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                                 dtype=ACT_DTYPE, device=device),
            "len": 0}


# -------------------------------------------------------------------- FFN

class FFN(nn.Module):
    def __init__(self, cfg: ModelConfig, device, d_ff: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        f = cfg.d_ff if d_ff is None else d_ff
        if cfg.act == "swiglu":
            self.w_gate = param((d, f), device)
            self.w_up = param((d, f), device)
        else:
            self.w_in = param((d, f), device)
        self.w_down = param((f, d), device)

    def init_(self, gen):
        for name in ("w_gate", "w_up", "w_in"):
            if hasattr(self, name):
                normal_(getattr(self, name), gen)
        normal_(self.w_down, gen, out_scale(self.cfg))

    def forward(self, x):
        xb = x.to(ACT_DTYPE)
        if self.cfg.act == "swiglu":
            h = F.silu(xb @ w(self.w_gate)) * (xb @ w(self.w_up))
        else:   # jax.nn.gelu's default: the tanh approximation
            h = F.gelu(xb @ w(self.w_in), approximate="tanh")
        return (h @ w(self.w_down)).to(x.dtype)


# -------------------------------------------------------- embed / unembed

class Embed(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        self.table = param((cfg.padded_vocab, cfg.d_model), device)
        if not cfg.tie_embeddings:
            self.unembed = param((cfg.d_model, cfg.padded_vocab), device)

    def init_(self, gen):
        normal_(self.table, gen)
        if not self.cfg.tie_embeddings:
            normal_(self.unembed, gen)

    def forward(self, tokens):
        if RT.EMBED_ONEHOT:
            oh = F.one_hot(tokens.long(), self.table.shape[0]).to(ACT_DTYPE)
            return oh @ w(self.table)
        return F.embedding(tokens.long(), w(self.table))

    def unembed_apply(self, x):
        """Logits over the PADDED vocab; padded columns masked to -1e9 so
        they are inert in softmax-CE and in greedy decode."""
        cfg = self.cfg
        xb = x.to(ACT_DTYPE)
        if cfg.tie_embeddings:
            logits = xb @ w(self.table).T
        else:
            logits = xb @ w(self.unembed)
        if cfg.padded_vocab != cfg.vocab_size:   # out of place: autograd
            pad = torch.arange(cfg.padded_vocab, device=x.device)
            logits = logits.masked_fill(pad >= cfg.vocab_size, -1e9)
        return logits

