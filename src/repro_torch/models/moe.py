"""Mixture-of-Experts layer: shared + routed experts (the port of
``repro/models/moe.py``).

Routing is the reference's sort-based capacity dispatch: token routes
are sorted by expert id (a stable sort, as ``jnp.argsort``), packed into
a dense (E, capacity, d) buffer by a gather, run through the experts as
one batched matmul, and combined back with the router weights. Routes
past an expert's capacity drop to zero (the shared experts still cover
the token). The expert bank is padded to ``cfg.padded_experts``; the
padded experts get zero router probability and no token.

deepseek-moe: 2 shared + 64 routed top-6. qwen2-moe: 4 shared + 60
routed top-4.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import runtime as RT
from repro_torch.models.layers import (ACT_DTYPE, F32, normal_, out_scale,
                                       param, w)


class _Bank(nn.Module):
    """SwiGLU weights (``w_gate``, ``w_up``, ``w_down``) of shape
    ``(*lead, d, f)`` / ``(*lead, f, d)``."""

    def __init__(self, lead: tuple, d: int, f: int, device):
        super().__init__()
        self.w_gate = param((*lead, d, f), device)
        self.w_up = param((*lead, d, f), device)
        self.w_down = param((*lead, f, d), device)

    def fill_(self, gen, scale_out: float):
        normal_(self.w_gate, gen)
        normal_(self.w_up, gen)
        normal_(self.w_down, gen, scale_out)


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        d, f = cfg.d_model, cfg.moe_d_ff
        self.router = param((d, cfg.n_experts), device)
        self.experts = _Bank((cfg.padded_experts,), d, f, device)
        if cfg.n_shared_experts:
            self.shared = _Bank((), d, cfg.n_shared_experts * f, device)

    def init_(self, gen):
        normal_(self.router, gen, 0.006)
        self.experts.fill_(gen, out_scale(self.cfg))
        if self.cfg.n_shared_experts:
            self.shared.fill_(gen, out_scale(self.cfg))

    def forward(self, x):
        """x (B, S, d) -> (out (B, S, d), aux_loss scalar)."""
        cfg = self.cfg
        b, s, d = x.shape
        t = b * s
        e, k = cfg.padded_experts, cfg.top_k
        e_real = cfg.n_experts
        xt = x.reshape(t, d)

        # ---- router (float32; only the real experts get logits)
        probs = torch.softmax(xt.to(F32) @ self.router, -1)   # (T, E_real)
        if e != e_real:  # zero columns: top-k never picks them
            probs = F.pad(probs, (0, e - e_real))
        gate_w, gate_i = top_k(probs, k)                       # (T, K)
        gate_w = gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True),
                                          1e-9)

        # ---- load-balance auxiliary loss (Switch-style)
        me = probs.mean(0)                                     # (E,)
        assign = torch.zeros(e, dtype=F32, device=x.device).index_add_(
            0, gate_i.reshape(-1),
            torch.full((t * k,), 1.0 / (t * k), dtype=F32, device=x.device))
        aux = e_real * torch.sum(me * assign) * cfg.router_aux_coef

        # ---- sort-based dispatch + expert compute + combine
        if RT.MOE_GROUPED:
            # routes within each batch row, capacity per row
            cap = capacity(cfg, s)
            out = torch.cat([
                _routed(xr, gw, gi, self.experts, e, k, cap)
                for xr, gw, gi in zip(xt.reshape(b, s, d),
                                      gate_w.reshape(b, s, k),
                                      gate_i.reshape(b, s, k))])
        else:
            out = _routed(xt, gate_w, gate_i, self.experts, e, k,
                          capacity(cfg, t))

        # ---- shared experts (always-on dense path)
        if cfg.n_shared_experts:
            sp = self.shared
            xb = xt.to(ACT_DTYPE)
            hs = F.silu(xb @ w(sp.w_gate)) * (xb @ w(sp.w_up))
            out = out + hs @ w(sp.w_down)
        return out.reshape(b, s, d).to(x.dtype), aux


def top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last axis, ties to the
    lower index (a stable descending sort; ``torch.topk`` promises no
    order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    cap = int(cfg.capacity_factor * cfg.top_k * n_tokens / cfg.n_experts)
    return max(8, min(cap, n_tokens))


def _routed(xt, gate_w, gate_i, experts: _Bank, e: int, k: int, cap: int):
    """Sort-based dispatch -> batched expert matmul -> weighted combine.
    xt (T, d); gate_w / gate_i (T, K). Returns (T, d); over-capacity
    routes give zero."""
    t, d = xt.shape
    dev = xt.device
    flat_e = gate_i.reshape(-1)                            # (T*K,)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    token_of = order // k
    # position within its expert: rank in sorted order - expert's start
    counts = torch.bincount(sorted_e, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(t * k, device=dev) - starts[sorted_e]
    keep = pos_in_e < cap
    sentinel = e * cap
    dest = torch.where(keep, sorted_e * cap + pos_in_e, sentinel)

    # pack: buffer row -> source token (t: the zero row)
    buf_src = torch.full((sentinel + 1,), t, dtype=torch.long, device=dev)
    buf_src[dest] = torch.where(keep, token_of, t)
    x_pad = torch.cat([xt, xt.new_zeros((1, d))], 0)
    xe = x_pad[buf_src[:sentinel]].reshape(e, cap, d).to(ACT_DTYPE)

    h = F.silu(torch.bmm(xe, w(experts.w_gate)))
    h = h * torch.bmm(xe, w(experts.w_up))
    ye = torch.bmm(h, w(experts.w_down)).reshape(sentinel, d)

    # combine: back through the same mapping (dropped routes -> zero row)
    dest_unsorted = torch.empty_like(dest)
    dest_unsorted[order] = dest
    ye_pad = torch.cat([ye, ye.new_zeros((1, d))], 0)
    routed = ye_pad[dest_unsorted].reshape(t, k, d)
    return torch.sum(routed * gate_w[..., None].to(ye.dtype), dim=1)
