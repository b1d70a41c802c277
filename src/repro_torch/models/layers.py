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
positions, ``chunked_attention`` from it on.

Sharding (``sharding.place``): each module's ``SPECS`` names the logical
axes of its parameters, as the reference's ``*_init`` return them, and
``gqa_cache_specs`` / ``mla_cache_specs`` those of its caches. On a
model whose parameters are DTensors the same code runs on DTensors;
``w`` is the reference's ``wgather`` under ``runtime.GATHER_WEIGHTS``,
``attention_any`` enters the attention (the flash kernel on the card)
through a ``local_map`` region on whole heads, and ``write_rows``
writes a cache's local block.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

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
    """A weight at its use: cast to the activation dtype. Under
    ``runtime.GATHER_WEIGHTS`` a DTensor weight first takes its TP-only
    placement (``gather_placements``, set by ``sharding.place``): the
    fsdp dims all-gathered at the use, as the reference's ``wgather``
    constrains them."""
    gather = getattr(p, "gather_placements", None)
    if RT.GATHER_WEIGHTS and gather is not None:
        p = p.redistribute(p.device_mesh, gather)
    return p.to(ACT_DTYPE)


def _replicate_partials(t):
    if any(p.is_partial() for p in t.placements):
        return t.redistribute(t.device_mesh, [
            Replicate() if p.is_partial() else p for p in t.placements])
    return t.view_as(t)


class _Settle(torch.autograd.Function):
    """Identity whose result has no ``Partial`` placement (the pending
    sums reduced) and whose gradient comes back in the result's own
    layout."""

    @staticmethod
    def forward(ctx, t):
        out = _replicate_partials(t)
        ctx.placements = out.placements
        return out

    @staticmethod
    def backward(ctx, g):
        if g.placements != ctx.placements:
            return g.redistribute(g.device_mesh, ctx.placements)
        return g


def settle(t):
    """A DTensor's pending sums (``Partial``, e.g. a contraction over a
    sharded dim) reduced now, and its gradient brought back to the same
    layout; a plain tensor as it is. Left to itself, DTensor may
    reduce-scatter pending sums, or lay a gradient out, along any free
    dim (the sequence), and a later merge of batch and sequence then
    holds two shardings in one dim."""
    return _Settle.apply(t) if isinstance(t, DTensor) else t


def matmul(x, wt):
    """``x @ wt`` for an activation and a weight at its use (``w``); on
    DTensors with the activation's gradient and the product settled
    (``settle``), and the product's placements on the data axes made the
    activation's (the batch rows stay where they were, whichever operand
    DTensor chose to move). Those are read from the settled activation,
    which holds no ``Partial``: a ``redistribute`` to a ``Partial``
    target is refused by some torch releases (2.11). The plain product
    on plain tensors."""
    if not isinstance(x, DTensor) and not isinstance(wt, DTensor):
        return x @ wt
    x = settle(x)
    out = settle(x @ wt)
    keep = [x.placements[i] if i in _data_dims(x.device_mesh) else p
            for i, p in enumerate(out.placements)]
    if keep != list(out.placements):
        out = out.redistribute(out.device_mesh, keep)
    return out


def _data_dims(mesh) -> tuple[int, ...]:
    from repro_torch.sharding import rules as SR
    names = SR.axis_names(mesh)
    return tuple(names.index(a) for a in SR.dp_axes(mesh))


# ------------------------------------------------------------------ norms

def rmsnorm(x: torch.Tensor, w_: torch.Tensor, eps: float = 1e-5):
    xf = x.to(F32)
    var = settle(torch.mean(xf * xf, dim=-1, keepdim=True))
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


def head_placements(mesh, batch: int, kv_heads: int) -> list:
    """Placements of a (B, S, H, ...) operand of an attention region: B
    over the data axes where they divide it, the heads over "model"
    where it divides the kv heads (each rank then holds whole kv heads
    with their query groups), else replicated on "model"."""
    from repro_torch.sharding import rules as SR
    return SR.placements(("dp", None, "tp"), mesh, (batch, 1, kv_heads))


def attention_region(q, k, v, *, causal=True, fn=None, **kw):
    """``attention_any`` (or ``fn``) on DTensor operands: a ``local_map``
    region on whole heads (``head_placements``), so the flash kernel (on
    the card) or the plain attention (on the CPU) runs on each rank's
    local block of batch rows and kv-head groups and never on part of a
    head."""
    from torch.distributed.tensor.experimental import local_map
    fn = attention_any if fn is None else fn
    mesh = q.device_mesh
    pl = head_placements(mesh, q.shape[0], k.shape[2])
    # q, k and v share one placement: every gradient is its input's
    return local_map(
        lambda q_, k_, v_: fn(q_, k_, v_, causal=causal, **kw),
        out_placements=pl, in_placements=(pl, pl, pl), device_mesh=mesh,
        redistribute_inputs=True)(q, k, v)


def split_heads(t, *shape):
    """``t.reshape(*shape)``, the last dim split into (heads, head dim).
    A DTensor whose last dim is sharded in blocks that are not whole
    heads is first replicated on those mesh axes (the bytes a dry run
    records); whole-head blocks stay sharded on the heads."""
    if isinstance(t, DTensor):
        t = _whole_heads(t, shape[-2])
    return t.reshape(*shape)


def _whole_heads(t, heads: int):
    """t with its last dim replicated on every mesh axis that shards it
    in blocks that are not whole heads."""
    last = t.ndim - 1
    pl = [Replicate() if isinstance(p, Shard) and p.dim == last
          and heads % t.device_mesh.size(i) else p
          for i, p in enumerate(t.placements)]
    if pl != list(t.placements):
        return t.redistribute(t.device_mesh, pl)
    return t.view_as(t)


class _HeadsMerged(torch.autograd.Function):
    """(..., H, D) -> (..., H * D), whose gradient arrives in whole heads
    (``_whole_heads``) before it is split back."""

    @staticmethod
    def forward(ctx, t):
        ctx.heads = t.shape[-2]
        return t.reshape(*t.shape[:-2], -1)

    @staticmethod
    def backward(ctx, g):
        heads = ctx.heads
        g = _whole_heads(g, heads) if isinstance(g, DTensor) else g
        return g.reshape(*g.shape[:-1], heads, -1)


def merge_heads(t):
    """``t.reshape(..., H * D)`` of a (..., H, D) activation. On a DTensor
    the gradient of the merged tensor (the next product's, sharded on its
    columns) is first made whole heads where the heads do not divide the
    mesh axis (24 heads over 16 ranks), so it splits back into heads."""
    if not isinstance(t, DTensor):
        return t.reshape(*t.shape[:-2], -1)
    return _HeadsMerged.apply(t)


def attention_any(q, k, v, *, causal=True, **kw):
    if isinstance(q, DTensor):
        return attention_region(q, k, v, causal=causal, **kw)
    if flash_eligible(q, k, v, **kw) and q.is_cuda:
        return flash(q, k, v, causal=causal)
    if q.shape[1] >= RT.CHUNKED_THRESHOLD and q.shape[1] == k.shape[1]:
        kw.pop("kv_valid_len", None)
        kw.pop("softcap", None)
        return chunked_attention(q, k, v, causal=causal, **kw)
    return full_attention(q, k, v, causal=causal, **kw)


# ------------------------------------------------------------ GQA block

class GQA(nn.Module):
    SPECS = {"wq": ("fsdp", "tp"), "wk": ("fsdp", "tp"),
             "wv": ("fsdp", "tp"), "wo": ("tp", "fsdp")}

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
        q = split_heads(matmul(xb, w(self.wq)), b, sq, h, dh)
        k = split_heads(matmul(xb, w(self.wk)), b, sq, hkv, dh)
        v = split_heads(matmul(xb, w(self.wv)), b, sq, hkv, dh)
        if cfg.rope_theta > 0:
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)

        if cache is not None and sq == 1:           # decode
            ck, cv = cache["k"], cache["v"]
            cap = ck.shape[1]
            # the reference's dynamic_update_slice clamps the slot
            slot = min(cache_pos if window else cache["len"], cap - 1)
            write_rows(ck, slot, k)
            write_rows(cv, slot, v)
            q = data_only(q)    # one token: whole heads beside the cache
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
                    for key, new in (("k", k), ("v", v)):
                        last = new[:, -cap:]      # rolled by shift
                        write_rows(cache[key], shift, last[:, :cap - shift])
                        write_rows(cache[key], 0, last[:, cap - shift:])
                else:
                    write_rows(cache["k"], 0, k)
                    write_rows(cache["v"], 0, v)
                cache["len"] += sq
        out = matmul(merge_heads(out), w(self.wo))
        return out.to(x.dtype), cache


def write_rows(buf, start: int, rows) -> None:
    """``buf[:, start:start + n] = rows`` in place (a cache's positions;
    n = ``rows.shape[1]``). On a DTensor cache, whose sequence may be
    sharded ("sp"), the rows take the cache's placements with the
    sequence whole, and each rank writes the positions in its own block."""
    n = rows.shape[1]
    if not isinstance(buf, DTensor):
        buf[:, start:start + n] = rows
        return
    from repro_torch.sharding import rules as SR
    mesh = buf.device_mesh
    whole = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
             for p in buf.placements]
    local = rows.redistribute(mesh, whole).to_local()
    lo, size = SR.local_block(buf.shape[1], mesh, buf.placements, 1)
    a, b = max(start, lo), min(start + n, lo + size)
    if a < b:
        buf.to_local()[:, a - lo:b - lo] = local[:, a - start:b - start]


def data_only(t):
    """A DTensor activation replicated on every axis but the data axes
    (its batch rows stay sharded); a plain tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    keep = _data_dims(t.device_mesh)
    pl = [p if i in keep else Replicate() for i, p in enumerate(t.placements)]
    return t.redistribute(t.device_mesh, pl) if pl != list(t.placements) \
        else t


def gqa_cache_specs(window: bool = False) -> dict:
    """Logical axes of a ``gqa_cache_init`` cache (``len`` is a host int):
    the batch over dp, the sequence over "sp" for the long flat caches;
    a window (ring) cache's sequence too under ``runtime.WINDOW_CACHE_SP``
    (else each decode step gathers the whole cache, the new K / V rows
    arriving model-sharded from the TP projections)."""
    seq_ax = ("sp" if RT.WINDOW_CACHE_SP else None) if window else "sp"
    return {"k": ("dp", seq_ax, None, None),
            "v": ("dp", seq_ax, None, None)}


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

    SPECS = {"wq_a": ("fsdp", None), "q_norm": (None,),
             "wq_b": ("fsdp", "tp"), "wkv_a": ("fsdp", None),
             "kv_norm": (None,), "wkv_b": ("fsdp", "tp"),
             "wo": ("tp", "fsdp")}

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
        q = rmsnorm(matmul(xb, w(self.wq_a)), self.q_norm, cfg.norm_eps)
        q = split_heads(matmul(q, w(self.wq_b)), b, s, h, dn + dr)
        q_nope, q_rope = q[..., :dn], q[..., dn:]
        kv = matmul(xb, w(self.wkv_a))                       # (B,S,rkv+dr)
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

        if cache is not None and sq == 1:  # ---- absorbed decode
            wkv_b = split_heads(w(self.wkv_b), rkv, h, dn + dv)
            w_uk, w_uv = wkv_b[..., :dn], wkv_b[..., dn:]
            slot = min(cache["len"], cache["ckv"].shape[1] - 1)
            ckv, krp = cache["ckv"], cache["krope"]
            write_rows(ckv, slot, c_kv)
            write_rows(krp, slot, k_rope[:, :, 0])
            # one token: whole heads beside the sequence-sharded cache
            q_nope, q_rope = data_only(q_nope), data_only(q_rope)
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
            kv = split_heads(matmul(c_kv, w(self.wkv_b)), b, sq, h, dn + dv)
            k_nope, v = kv[..., :dn], kv[..., dn:]
            k = torch.cat([k_nope, k_rope.expand(b, sq, h, dr)], -1)
            q = torch.cat([q_nope, q_rope], -1)
            out = attention_any(q, k, v, causal=True)
            if update_cache and cache is not None:
                write_rows(cache["ckv"], 0, c_kv)
                write_rows(cache["krope"], 0, k_rope[:, :, 0])
                cache["len"] += sq
        out = matmul(merge_heads(out), w(self.wo))
        return out.to(x.dtype), cache


def mla_cache_specs() -> dict:
    return {"ckv": ("dp", "sp", None), "krope": ("dp", "sp", None)}


def mla_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                   device=None) -> dict:
    return {"ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                               dtype=ACT_DTYPE, device=device),
            "krope": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                                 dtype=ACT_DTYPE, device=device),
            "len": 0}


# -------------------------------------------------------------------- FFN

class FFN(nn.Module):
    SPECS = {"w_gate": ("fsdp", "tp"), "w_up": ("fsdp", "tp"),
             "w_in": ("fsdp", "tp"), "w_down": ("tp", "fsdp")}

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
            h = F.silu(matmul(xb, w(self.w_gate))) * matmul(xb,
                                                            w(self.w_up))
        else:   # jax.nn.gelu's default: the tanh approximation
            h = F.gelu(matmul(xb, w(self.w_in)), approximate="tanh")
        return matmul(h, w(self.w_down)).to(x.dtype)


# -------------------------------------------------------- embed / unembed

def one_hot(tokens, n: int):
    """``F.one_hot``; on a DTensor of token rows, each rank's rows."""
    if not isinstance(tokens, DTensor):
        return F.one_hot(tokens, n)
    from torch.distributed.tensor.experimental import local_map
    pl = list(tokens.placements)
    return local_map(lambda t_: F.one_hot(t_, n), out_placements=pl,
                     in_placements=(pl,),
                     device_mesh=tokens.device_mesh)(tokens)


class Embed(nn.Module):
    SPECS = {"table": ("tp", "fsdp"), "unembed": ("fsdp", "tp")}

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
            oh = one_hot(tokens.long(), self.table.shape[0]).to(ACT_DTYPE)
            return matmul(oh, w(self.table))
        table = w(self.table)
        if isinstance(table, DTensor):   # the lookup reads a whole table
            table = table.redistribute(
                table.device_mesh, [Replicate()] * table.device_mesh.ndim)
        return F.embedding(tokens.long(), table)

    def unembed_apply(self, x):
        """Logits over the PADDED vocab; padded columns masked to -1e9 so
        they are inert in softmax-CE and in greedy decode."""
        cfg = self.cfg
        xb = x.to(ACT_DTYPE)
        if cfg.tie_embeddings:
            logits = matmul(xb, w(self.table).T)
        else:
            logits = matmul(xb, w(self.unembed))
        if cfg.padded_vocab != cfg.vocab_size:   # out of place: autograd
            pad = torch.arange(cfg.padded_vocab, device=x.device)
            logits = logits.masked_fill(pad >= cfg.vocab_size, -1e9)
        return logits

