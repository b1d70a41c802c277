"""Mamba2 / SSD (state-space duality) block (the port of
``repro/models/mamba2.py``). [arXiv:2405.21060]

Chunked SSD for train / prefill — quadratic within Q-token chunks,
linear recurrence across chunks — and the O(1)-state recurrent step for
decode. Discretization (per head h, state n, channel p):

    h_t = exp(A_h dt_t) * h_{t-1} + dt_t * B_t[n] * x_t[p]
    y_t = sum_n C_t[n] h_t[n, p] + D_h x_t[p]

The intra-chunk term of ``ssd_chunked`` is ``kernels.ops.ssd_diag``: the
hand-written kernel on the card, its plain version on the CPU. The chunk
states, the recurrence across chunks and their contribution stay torch
ops, as they are XLA ops in the reference. On DTensor operands the
chunked scan (and with it the kernel) and the decode step run in
``local_map`` regions on whole heads (``ssd_region``, ``decode_region``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (ACT_DTYPE, F32, normal_, out_scale,
                                       matmul, merge_heads, param, rmsnorm,
                                       split_heads, w)


def d_inner(cfg: ModelConfig) -> int:
    return cfg.expand * cfg.d_model


N_GROUPS = 1   # B / C groups: one, as in the reference


class Mamba2(nn.Module):
    SPECS = {"w_z": ("fsdp", "tp"), "w_x": ("fsdp", "tp"),
             "w_B": ("fsdp", None), "w_C": ("fsdp", None),
             "w_dt": ("fsdp", "tp"), "dt_bias": ("tp",), "A_log": ("tp",),
             "D": ("tp",), "conv_x": (None, "tp"), "conv_B": (None, None),
             "conv_C": (None, None), "norm": ("tp",),
             "w_out": ("tp", "fsdp")}

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        d, di = cfg.d_model, d_inner(cfg)
        h, n, kk = cfg.ssm_heads, cfg.ssm_state, cfg.conv_kernel
        gn = N_GROUPS * n
        self.w_z = param((d, di), device)
        self.w_x = param((d, di), device)
        self.w_B = param((d, gn), device)
        self.w_C = param((d, gn), device)
        self.w_dt = param((d, h), device)
        self.dt_bias = param((h,), device)
        self.A_log = param((h,), device)
        self.D = param((h,), device)
        self.conv_x = param((kk, di), device)
        self.conv_B = param((kk, gn), device)
        self.conv_C = param((kk, gn), device)
        self.norm = param((di,), device)
        self.w_out = param((di, d), device)

    def init_(self, gen):
        """The reference's distributions: dense weights N(0, 0.02)
        (``w_out`` at the output scale), convolutions N(0, 0.1),
        ``dt_bias`` the inverse softplus of dt ~ exp(U(log 1e-3, log
        1e-1)), ``A_log`` log U(1, 16), D 1, the norm 0."""
        for p in (self.w_z, self.w_x, self.w_B, self.w_C, self.w_dt):
            normal_(p, gen)
        normal_(self.w_out, gen, out_scale(self.cfg))
        for p in (self.conv_x, self.conv_B, self.conv_C):
            normal_(p, gen, 0.1)
        with torch.no_grad():
            dt = torch.exp(self.dt_bias.uniform_(
                math.log(1e-3), math.log(1e-1), generator=gen))
            self.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
            self.A_log.copy_(torch.log(self.A_log.uniform_(
                1.0, 16.0, generator=gen)))
            self.D.fill_(1.0)
            self.norm.zero_()

    def forward(self, x, *, cache: Optional[dict] = None,
                update_cache=False):
        """x (B,S,D) -> (out, cache). cache = {"conv_x", "conv_B",
        "conv_C", "ssm"} (``mamba2_cache_init``); S == 1 with a cache
        takes the recurrent path."""
        cfg = self.cfg
        b, s, _ = x.shape
        di = d_inner(cfg)
        h, n = cfg.ssm_heads, cfg.ssm_state
        pdim = di // h
        xb = x.to(ACT_DTYPE)

        z = matmul(xb, w(self.w_z))                           # (B,S,di)
        xs = matmul(xb, w(self.w_x))
        bs = matmul(xb, w(self.w_B))                          # (B,S,G*N)
        cs_ = matmul(xb, w(self.w_C))
        dt_raw = matmul(xb, w(self.w_dt)).to(F32)
        dt = softplus(dt_raw + self.dt_bias)                  # (B,S,H)
        a = -torch.exp(self.A_log)                            # (H,)

        decode = cache is not None and s == 1
        xs, ncx = _causal_conv(xs, w(self.conv_x),
                               state=cache["conv_x"] if decode else None)
        bs, ncb = _causal_conv(bs, w(self.conv_B),
                               state=cache["conv_B"] if decode else None)
        cs_, ncc = _causal_conv(cs_, w(self.conv_C),
                                state=cache["conv_C"] if decode else None)
        xs, bs, cs_ = F.silu(xs), F.silu(bs), F.silu(cs_)

        xh = split_heads(xs, b, s, h, pdim)
        bmat = bs.reshape(b, s, N_GROUPS, n)
        cmat = cs_.reshape(b, s, N_GROUPS, n)

        if decode:
            step = (decode_region if isinstance(xh, DTensor)
                    else ssd_decode_step)
            y, new_ssm = step(xh[:, 0], dt[:, 0], a, bmat[:, 0],
                              cmat[:, 0], cache["ssm"])
            y = y[:, None]                                    # (B,1,H,P)
            cache.update(conv_x=ncx, conv_B=ncb, conv_C=ncc, ssm=new_ssm)
        else:
            init = cache["ssm"] if cache is not None else None
            scan = ssd_region if isinstance(xh, DTensor) else ssd_chunked
            y, final = scan(xh, dt, a, bmat, cmat,
                            chunk=min(cfg.ssm_chunk, s), init_state=init)
            if update_cache and cache is not None:
                cache.update(conv_x=ncx, conv_B=ncb, conv_C=ncc, ssm=final)

        y = y + xh.to(F32) * self.D[:, None]
        y = merge_heads(y).to(ACT_DTYPE)
        y = rmsnorm(y * F.silu(z), self.norm, cfg.norm_eps)
        out = matmul(y, w(self.w_out))
        return out.to(x.dtype), cache


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)`` at every
    x (torch's ``softplus`` turns linear above its threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _causal_conv(x, w_, *, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x (B,S,C), w (K,C). state: (B,K-1,C) left
    context (decode); returns (y, new_state)."""
    k = w_.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                     # (B, S+K-1, C)
    s = x.shape[1]
    y = xp[:, 0:s] * w_[0]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w_[i]
    # a copy: the state must not hold the whole padded sequence alive
    new_state = xp[:, -(k - 1):].clone() if k > 1 else pad
    return y, new_state


def ssd_diag_chunks(xr, dtr, br, cr, cs):
    """The intra-chunk term y_diag (B,NC,Q,H,P) of chunked operands
    xr (B,NC,Q,H,P), dtr and cs (B,NC,Q,H), br and cr (B,NC,Q,N) through
    ``ops.ssd_diag``, whose operands are one row a (batch, chunk): C, B
    (BC, Q, N); x (BC, H, Q, P); dt, cs (BC, H, Q)."""
    b, nc, q, h, p = xr.shape
    bc = b * nc
    y = ops.ssd_diag(cr.reshape(bc, q, -1).contiguous(),
                     br.reshape(bc, q, -1).contiguous(),
                     xr.permute(0, 1, 3, 2, 4).reshape(bc, h, q, p)
                     .contiguous(),
                     dtr.permute(0, 1, 3, 2).reshape(bc, h, q).contiguous(),
                     cs.permute(0, 1, 3, 2).reshape(bc, h, q).contiguous())
    return y.reshape(b, nc, h, q, p).permute(0, 1, 3, 2, 4)


def ssd_chunked(x, dt, a, bmat, cmat, *, chunk: int,
                init_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    x (B,S,H,P), dt (B,S,H) > 0, a (H,) < 0, bmat / cmat (B,S,G,N) with
    G = 1. Returns y (B,S,H,P) in x's dtype, final_state (B,H,N,P)
    float32.
    """
    b, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    if g != 1:
        raise ValueError(f"ssd_chunked: {g} B / C groups; the model and "
                         "ops.ssd_diag have one")
    if s % chunk:
        raise ValueError(f"ssd_chunked: sequence {s} is not a multiple of "
                         f"the chunk {chunk}")
    nc = s // chunk

    xr = x.reshape(b, nc, chunk, h, p).to(F32)
    dtr = dt.reshape(b, nc, chunk, h).to(F32)
    br = bmat.reshape(b, nc, chunk, n).to(F32)
    cr = cmat.reshape(b, nc, chunk, n).to(F32)

    da = dtr * a                                      # (B,NC,Q,H) negative
    cs = torch.cumsum(da, dim=2)                      # inclusive cumsum
    total = cs[:, :, -1:, :]                          # (B,NC,1,H)

    # ---- intra-chunk (quadratic within the chunk): the kernel
    y_diag = ssd_diag_chunks(xr, dtr, br, cr, cs)

    # ---- chunk states: S_c = sum_k B_k (decay_out * dt)_k x_k
    wk = torch.exp(total - cs) * dtr                  # (B,NC,Q,H)
    states = torch.einsum("bckn,bckh,bckhp->bchnp", br, wk, xr)

    # ---- inter-chunk recurrence over NC chunks (the state before each)
    chunk_decay = torch.exp(total[:, :, 0, :])        # (B,NC,H)
    carry = (torch.zeros((b, h, n, p), dtype=F32, device=x.device)
             if init_state is None else init_state.to(F32))
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)            # (B,NC,H,N,P)

    # ---- inter-chunk contribution
    y_off = torch.einsum("bcqn,bcqh,bchnp->bcqhp", cr, torch.exp(cs),
                         prev_states)
    y = (y_diag + y_off).reshape(b, s, h, p)
    return y.to(x.dtype), carry


def _head_placements(x):
    """Placements of an SSD region over x (B, ..., H, P): x's (and dt's),
    the state's (B, H, N, P), B's and C's (one group: replicated on
    "model"), and the (H,) vector's. The batch goes over the data axes
    where they divide it, the heads over "model" where it divides H."""
    from repro_torch.sharding import rules as SR
    mesh = x.device_mesh
    b, h = x.shape[0], x.shape[-2]
    mid = (None,) * (x.ndim - 3)
    return (SR.placements(("dp",) + mid + ("tp",), mesh,
                          (b,) + (1,) * len(mid) + (h,)),
            SR.placements(("dp", "tp"), mesh, (b, h)),
            SR.placements(("dp",), mesh, (b,)),
            SR.placements(("tp",), mesh, (h,)))


def ssd_region(x, dt, a, bmat, cmat, *, chunk: int, init_state=None):
    """``ssd_chunked`` on DTensor operands, as a ``local_map`` region:
    each rank scans its batch rows and whole heads (``ops.ssd_diag`` on
    the local blocks). The chunk states and the recurrence are per head,
    so nothing crosses ranks inside."""
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding import rules as SR
    heads, state, rows, vec = _head_placements(x)

    def scan(x_, dt_, a_, b_, c_, *init):
        return ssd_chunked(x_, dt_, a_, b_, c_, chunk=chunk,
                           init_state=init[0] if init else None)
    args, pls = (x, dt, a, bmat, cmat), (heads, heads, vec, rows, rows)
    if init_state is not None:
        args, pls = args + (init_state,), pls + (state,)
    return local_map(scan, out_placements=(heads, state), in_placements=pls,
                     in_grad_placements=SR.region_grads(pls),
                     device_mesh=x.device_mesh,
                     redistribute_inputs=True)(*args)


def decode_region(x, dt, a, bvec, cvec, state):
    """``ssd_decode_step`` on DTensor operands, per rank on its batch rows
    and whole heads."""
    from torch.distributed.tensor.experimental import local_map
    heads, st, rows, vec = _head_placements(x)
    return local_map(ssd_decode_step, out_placements=(heads, st),
                     in_placements=(heads, heads, vec, rows, rows, st),
                     device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x, dt, a, bvec, cvec, state)


def ssd_decode_step(x, dt, a, bvec, cvec, state):
    """One recurrent step. x (B,H,P), dt (B,H), bvec / cvec (B,G,N),
    state (B,H,N,P) -> (y (B,H,P), new_state)."""
    x, dt = x.to(F32), dt.to(F32)
    h, g = x.shape[1], bvec.shape[1]
    bh = torch.repeat_interleave(bvec.to(F32), h // g, dim=1)   # (B,H,N)
    ch = torch.repeat_interleave(cvec.to(F32), h // g, dim=1)
    dec = torch.exp(dt * a)                                    # (B,H)
    bx = torch.einsum("bhn,bhp->bhnp", bh, dt[..., None] * x)
    new_state = state * dec[:, :, None, None] + bx
    y = torch.einsum("bhn,bhnp->bhp", ch, new_state)
    return y, new_state


def mamba2_cache_specs() -> dict:
    return {"conv_x": ("dp", None, "tp"), "conv_B": ("dp", None, None),
            "conv_C": ("dp", None, None), "ssm": ("dp", "tp", None, None)}


def mamba2_cache_init(cfg: ModelConfig, batch: int, device=None) -> dict:
    di = d_inner(cfg)
    h, n, k = cfg.ssm_heads, cfg.ssm_state, cfg.conv_kernel
    gn = N_GROUPS * n

    def z(shape, dtype=ACT_DTYPE):
        return torch.zeros(shape, dtype=dtype, device=device)
    return {"conv_x": z((batch, k - 1, di)), "conv_B": z((batch, k - 1, gn)),
            "conv_C": z((batch, k - 1, gn)),
            "ssm": z((batch, h, n, di // h), F32)}
