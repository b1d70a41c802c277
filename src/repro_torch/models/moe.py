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
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.models import runtime as RT
from repro_torch.models.layers import (ACT_DTYPE, F32, matmul, normal_,
                                       out_scale, param, settle, w)


class _Bank(nn.Module):
    """SwiGLU weights (``w_gate``, ``w_up``, ``w_down``) of shape
    ``(*lead, d, f)`` / ``(*lead, f, d)``."""

    def __init__(self, lead: tuple, d: int, f: int, device, specs: dict):
        super().__init__()
        self.SPECS = specs
        self.w_gate = param((*lead, d, f), device)
        self.w_up = param((*lead, d, f), device)
        self.w_down = param((*lead, f, d), device)

    def fill_(self, gen, scale_out: float):
        normal_(self.w_gate, gen)
        normal_(self.w_up, gen)
        normal_(self.w_down, gen, scale_out)


class MoE(nn.Module):
    SPECS = {"router": ("fsdp", None)}

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        d, f = cfg.d_model, cfg.moe_d_ff
        self.router = param((d, cfg.n_experts), device)
        self.experts = _Bank((cfg.padded_experts,), d, f, device, {
            "w_gate": ("expert", "fsdp", None),
            "w_up": ("expert", "fsdp", None),
            "w_down": ("expert", None, "fsdp")})
        if cfg.n_shared_experts:
            self.shared = _Bank((), d, cfg.n_shared_experts * f, device, {
                "w_gate": ("fsdp", "tp"), "w_up": ("fsdp", "tp"),
                "w_down": ("tp", "fsdp")})

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
        probs = torch.softmax(matmul(xt.to(F32), self.router), -1)
        if isinstance(probs, DTensor):   # padded on each rank's rows
            probs, gate_w, gate_i, assign = _route_region(probs, e, k, t)
        else:
            probs = _pad_experts(probs, e)
            gate_w, gate_i, assign = _route(probs, k, t)       # (T, K)

        # ---- load-balance auxiliary loss (Switch-style)
        me = probs.mean(0)                                     # (E,)
        aux = e_real * torch.sum(me * assign) * cfg.router_aux_coef

        # ---- sort-based dispatch + expert compute + combine
        bank = tuple(w(p) for p in (self.experts.w_gate, self.experts.w_up,
                                    self.experts.w_down))
        if isinstance(xt, DTensor):
            out = _routed_sharded(xt, gate_w, gate_i, bank, b, e, k,
                                  capacity(cfg, s if RT.MOE_GROUPED else t))
        elif RT.MOE_GROUPED:
            out = _grouped(xt, gate_w, gate_i, bank, b, e, k,
                           capacity(cfg, s))
        else:
            out = _routed(xt, gate_w, gate_i, bank, e, k, capacity(cfg, t))

        # ---- shared experts (always-on dense path)
        if cfg.n_shared_experts:
            sp = self.shared
            xb = xt.to(ACT_DTYPE)
            hs = F.silu(matmul(xb, w(sp.w_gate))) * matmul(xb, w(sp.w_up))
            out = out + matmul(hs, w(sp.w_down))
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


def _route(probs, k: int, t: int):
    """Top-k routes of the tokens' expert probabilities (T, E): the gates
    renormalised, the experts' ids, and each expert's share of the T x K
    routes (the load-balance loss's assignment)."""
    gate_w, gate_i = top_k(probs, k)
    gate_w = gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True), 1e-9)
    assign = torch.zeros(probs.shape[-1], dtype=F32,
                         device=probs.device).index_add_(
        0, gate_i.reshape(-1),
        torch.full((gate_i.numel(),), 1.0 / (t * k), dtype=F32,
                   device=probs.device))
    return gate_w, gate_i, assign


def _pad_experts(probs, e: int):
    """The router probabilities (T, E_real) with zero columns up to the
    padded bank's E: top-k never picks them (ties go to the lower
    index), and they add nothing to the load-balance loss."""
    e_real = probs.shape[-1]
    return probs if e == e_real else F.pad(probs, (0, e - e_real))


def _route_region(probs, e: int, k: int, t: int):
    """The padding (``_pad_experts``) and ``_route`` of a DTensor of
    token rows on each rank's own rows (``local_map``): the padded
    probabilities and the routes stay on the rows, the assignment
    shares sum over the data axes (``Partial``). A pad of the DTensor
    itself is a DTensor op, whose redistribution some torch releases
    (2.11) refuse."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.sharding import rules as SR
    mesh = probs.device_mesh
    rows = SR.dp_placements(mesh, probs.shape)
    share = [Partial() if p.is_shard() else p for p in rows]

    def route(p_):
        p_ = _pad_experts(p_, e)
        return (p_, *_route(p_, k, t))
    return local_map(route, out_placements=(rows, rows, rows, share),
                     in_placements=(rows,), device_mesh=mesh,
                     redistribute_inputs=True)(probs)


def _grouped(xt, gate_w, gate_i, bank, b: int, e: int, k: int, cap: int):
    """``runtime.MOE_GROUPED``: each batch row's routes dispatched within
    the row, capacity per row."""
    t, d = xt.shape
    s = t // b
    return torch.cat([
        _routed(xr, gw, gi, bank, e, k, cap)
        for xr, gw, gi in zip(xt.reshape(b, s, d), gate_w.reshape(b, s, k),
                              gate_i.reshape(b, s, k))])


def _routed_sharded(xt, gate_w, gate_i, bank, b: int, e: int, k: int,
                    cap: int):
    """The routed experts on DTensor tokens. The sort, counts and
    gathers of the dispatch have no DTensor rule, so they run in
    ``local_map`` regions. Under ``runtime.MOE_GROUPED`` each rank
    dispatches its own batch rows, as the rows' routes never cross them
    (exact). Otherwise the tokens and routes are replicated for the
    global dispatch (all-gathered over the data axes), so the result is
    the unsharded one; the expert products between the pack and the
    combine are DTensor ops on the bank's placements, on a dispatch
    buffer replicated or, under ``runtime.MOE_XE_SHARD``, sharded over
    experts ("model") and capacity rows ("data")."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.sharding import rules as SR
    mesh = xt.device_mesh
    full = [Replicate()] * mesh.ndim
    if RT.MOE_GROUPED:
        t, d = xt.shape
        rows = SR.placements(("dp", None), mesh, (b, 1))
        wanted = (rows, rows, rows) + (full,) * 3
        return local_map(
            lambda x_, gw, gi, *bk: _grouped(x_, gw, gi, bk, x_.shape[0]
                                             * b // t, e, k, cap),
            out_placements=rows, in_placements=wanted,
            in_grad_placements=SR.region_grads(wanted), device_mesh=mesh,
            redistribute_inputs=True)(xt, gate_w, gate_i, *bank)
    t, d = xt.shape
    xe, dest = local_map(lambda x_, gi: _dispatch(x_, gi, e, k, cap),
                         out_placements=(full, full),
                         in_placements=(full, full), device_mesh=mesh,
                         redistribute_inputs=True)(xt, gate_i)
    if RT.MOE_XE_SHARD:
        # experts over "model", capacity rows over "data" (the reference's
        # P("model", ("data",), None))
        xe = xe.redistribute(mesh, SR.placements_of(
            SR.fit(("model", ("data",), None), xe.shape, mesh), mesh))
    ye = _experts(xe, bank)
    return local_map(lambda y_, dt_, gw: _combine(y_, dt_, gw, t, k),
                     out_placements=full, in_placements=(full,) * 3,
                     device_mesh=mesh,
                     redistribute_inputs=True)(ye, dest, gate_w)


def _dispatch(xt, gate_i, e: int, k: int, cap: int):
    """Sort-based dispatch of the routes ``gate_i`` (T, K) of the tokens
    ``xt`` (T, d): the packed buffer (E, cap, d) in the activation dtype
    and each route's buffer row (``e * cap`` for a dropped route)."""
    t, d = xt.shape
    dev = xt.device
    flat_e = gate_i.reshape(-1)                            # (T*K,)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    token_of = order // k
    # position within its expert: rank in sorted order - expert's start
    counts = torch.zeros(e, dtype=sorted_e.dtype, device=dev).index_add_(
        0, sorted_e, torch.ones_like(sorted_e))     # bincount, fixed size
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
    dest_unsorted = torch.empty_like(dest)
    dest_unsorted[order] = dest
    return xe, dest_unsorted


def _experts(xe, bank):
    """The SwiGLU experts over the packed buffer (E, cap, d) -> (E, cap,
    d); ``bank`` the (w_gate, w_up, w_down) weights at their use."""
    w_gate, w_up, w_down = bank
    xe = settle(xe)
    h = F.silu(settle(torch.bmm(xe, w_gate)))
    h = h * settle(torch.bmm(xe, w_up))
    return settle(torch.bmm(settle(h), w_down))


def _combine(ye, dest_unsorted, gate_w, t: int, k: int):
    """Each token's routes back from the expert outputs (E, cap, d),
    weighted by its gates (dropped routes read the zero row)."""
    d = ye.shape[-1]
    ye = ye.reshape(-1, d)
    ye_pad = torch.cat([ye, ye.new_zeros((1, d))], 0)
    routed = ye_pad[dest_unsorted].reshape(t, k, d)
    return torch.sum(routed * gate_w[..., None].to(ye.dtype), dim=1)


def _routed(xt, gate_w, gate_i, bank, e: int, k: int, cap: int):
    """Sort-based dispatch -> batched expert matmul -> weighted combine.
    xt (T, d); gate_w / gate_i (T, K); ``bank`` the experts' weights at
    their use. Returns (T, d); over-capacity routes give zero."""
    xe, dest = _dispatch(xt, gate_i, e, k, cap)
    return _combine(_experts(xe, bank), dest, gate_w, xt.shape[0], k)
