"""Unified model: every architecture of ``configs`` behind one interface
(the port of ``repro/models/model.py``).

    model = Model(cfg, device="cuda")        # parameters allocated
    params = model.init(generator)           # filled; name -> tensor
    logits, aux = model.forward(batch)       # teacher-forced, trainable
    caches = model.cache_init(batch_size, max_len)
    logits, caches = model.prefill(batch, caches)
    logits, caches = model.decode_step(token, caches)
    model.specs(), model.cache_specs()       # logical axes, by name

``forward`` tracks gradients of the (trainable float32) parameters;
``prefill`` and ``decode_step`` run under ``torch.inference_mode`` and
keep no graph. ``Model(cfg, remat=True)`` wraps each layer body of the
teacher-forced forward in ``runtime.checkpoint_wrap`` (at the
reference's sites: a layer, gemma3's group of ratio + 1 layers, zamba2's
Mamba2 layer with the shared attention before it), so its activations
are recomputed in the backward under ``runtime.REMAT_POLICY``.

``batch`` is a dict of ``tokens`` (B, S) and, by family,
``vision_embeds`` (B, V, d) or ``frames`` (B, F, d); numpy or tensors,
moved to the model's device. ``models.convert.from_reference`` builds a
``Model`` holding the reference's parameter tree.

Families
--------
dense / vlm     pre-norm attn + FFN stack; gemma3's local:global pattern
                is a list of groups (ratio x local + 1 global).
moe             attn + (shared + routed experts); aux load-balance loss.
ssm             mamba2 (SSD) stack.
hybrid          mamba2 stack + ONE weight-tied attention block applied
                before every ``shared_attn_every``-th layer (zamba2).
audio           whisper enc-dec: bidirectional encoder over frame
                embeddings; causal decoder with cross-attention.
vlm             dense decoder over [patch embeds | token embeds].

The reference scans stacked layer axes; here each stack is an
``nn.ModuleList`` walked by a Python loop, and a cache is a list of
per-layer dicts (``layers.gqa_cache_init`` ...), written in place, whose
``len`` is a host int. The reference's logical-axis ``specs`` trees are
``specs()`` (parameter name -> logical tuple, the stacked layer axis
dropped as the stacks are split) and ``cache_specs()`` (``cache_init``'s
structure without ``len``); ``init`` returns parameters only.
``sharding.place.shard_params`` makes every parameter a DTensor placed
by them and sets ``mesh``; the entry points then run on DTensors, the
plain tensors they make (positions, masks) implicitly replicated.
``abstract_model`` builds a model whose tensors are fake: nothing is
allocated.
"""
from __future__ import annotations

import contextlib
from typing import Any

import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import runtime as RT
from repro_torch.models.moe import MoE


def _zero(*params: torch.Tensor) -> None:
    with torch.no_grad():
        for p in params:
            p.zero_()


NORM_SPECS = {"ln1": (None,), "ln2": (None,), "lnx": (None,), "ln": (None,),
              "final_norm": (None,), "enc_norm": (None,)}


def abstract_model(cfg: ModelConfig, *, remat: bool = False):
    """``(Model, FakeTensorMode)``: a CPU model whose parameters are fake
    tensors (shapes and dtypes, no storage), for the dry run. Run what
    uses it under the returned mode."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        return Model(cfg, device="cpu", remat=remat), mode


class DenseLayer(nn.Module):
    """Pre-norm attention (GQA or MLA) + FFN. ``causal=False`` is
    whisper's encoder layer (bidirectional, the default norm eps)."""

    SPECS = NORM_SPECS

    def __init__(self, cfg: ModelConfig, device, *, causal: bool = True):
        super().__init__()
        self.cfg, self.causal = cfg, causal
        self.eps = cfg.norm_eps if causal else 1e-5
        self.attn = (L.MLA(cfg, device) if cfg.attention == "mla"
                     else L.GQA(cfg, device))
        self.ffn = L.FFN(cfg, device)
        self.ln1 = L.param((cfg.d_model,), device)
        self.ln2 = L.param((cfg.d_model,), device)

    def init_(self, gen):
        _zero(self.ln1, self.ln2)

    def forward(self, x, positions, *, window=0, cache=None,
                update_cache=False):
        a, _ = attn_apply(self, x, positions, window=window, cache=cache,
                          update_cache=update_cache, causal=self.causal)
        x = x + a
        return x + self.ffn(L.rmsnorm(x, self.ln2, self.eps))


def attn_apply(lp, x, positions, *, window=0, cache=None,
               update_cache=False, causal=True):
    """A layer's pre-norm attention (``lp.ln1``, ``lp.attn``)."""
    xn = L.rmsnorm(x, lp.ln1, lp.eps)
    if isinstance(lp.attn, L.MLA):
        return lp.attn(xn, positions=positions, cache=cache,
                       update_cache=update_cache)
    cache_pos = None
    if cache is not None and window:
        cache_pos = cache["len"] % window
    return lp.attn(xn, positions=positions, causal=causal, window=window,
                   cache=cache, cache_pos=cache_pos,
                   update_cache=update_cache)


class MoELayer(nn.Module):
    SPECS = NORM_SPECS

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg, self.eps = cfg, cfg.norm_eps
        self.attn = L.GQA(cfg, device)
        self.moe = MoE(cfg, device)
        self.ln1 = L.param((cfg.d_model,), device)
        self.ln2 = L.param((cfg.d_model,), device)

    def init_(self, gen):
        _zero(self.ln1, self.ln2)

    def forward(self, x, positions, *, cache=None, update_cache=False):
        a, _ = attn_apply(self, x, positions, cache=cache,
                          update_cache=update_cache)
        x = x + a
        mo, aux = self.moe(L.rmsnorm(x, self.ln2, self.eps))
        return x + mo, aux


class SSMLayer(nn.Module):
    SPECS = NORM_SPECS

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        self.mamba = M.Mamba2(cfg, device)
        self.ln = L.param((cfg.d_model,), device)

    def init_(self, gen):
        _zero(self.ln)

    def forward(self, x, *, cache=None, update_cache=False):
        y, _ = self.mamba(L.rmsnorm(x, self.ln, self.cfg.norm_eps),
                          cache=cache, update_cache=update_cache)
        return x + y


class XAttnLayer(nn.Module):
    """whisper's decoder layer: causal self-attention, cross-attention
    over the encoder output, FFN."""

    SPECS = NORM_SPECS

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg, self.eps = cfg, cfg.norm_eps
        self.attn = L.GQA(cfg, device)
        self.xattn = L.GQA(cfg, device)
        self.ffn = L.FFN(cfg, device)
        self.ln1 = L.param((cfg.d_model,), device)
        self.lnx = L.param((cfg.d_model,), device)
        self.ln2 = L.param((cfg.d_model,), device)

    def init_(self, gen):
        _zero(self.ln1, self.lnx, self.ln2)

    def forward(self, x, positions, enc_out, *, self_cache=None,
                cross_cache=None, update_cache=False):
        a, _ = attn_apply(self, x, positions, cache=self_cache,
                          update_cache=update_cache)
        x = x + a
        x = x + self._cross(x, enc_out, cross_cache)
        return x + self.ffn(L.rmsnorm(x, self.ln2, self.eps))

    def _cross(self, x, kv_src, cache):
        """Cross-attention (the reference's direct ``full_attention``,
        never the flash kernel); K / V from the encoder output, written
        to ``cache``, or at decode (``kv_src`` None) read from it."""
        cfg = self.cfg
        xn = L.rmsnorm(x, self.lnx, self.eps)
        b, sq, _ = xn.shape
        hh, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        p = self.xattn
        q = L.split_heads(L.matmul(xn.to(L.ACT_DTYPE), L.w(p.wq)), b, sq, hh,
                          dh)
        if kv_src is None:
            ck, cv = cache["k"], cache["v"]
        else:
            src = kv_src.to(L.ACT_DTYPE)
            ck = L.split_heads(L.matmul(src, L.w(p.wk)), b, src.shape[1],
                               hkv, dh)
            cv = L.split_heads(L.matmul(src, L.w(p.wv)), b, src.shape[1],
                               hkv, dh)
            if cache is not None:
                cache.update(k=ck, v=cv)
        if isinstance(q, L.DTensor):
            out = L.attention_region(q, ck, cv, causal=False,
                                     fn=L.full_attention)
        else:
            out = L.full_attention(q, ck, cv, causal=False)
        out = L.matmul(L.merge_heads(out), L.w(p.wo))
        return out.to(x.dtype)


class LocalGlobalGroup(nn.Module):
    """gemma3: ``ratio`` windowed local layers, then one global layer
    (submodules ``local`` and ``global``, the reference's names)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.local = nn.ModuleList(DenseLayer(cfg, device)
                                   for _ in range(cfg.local_global_ratio))
        self.add_module("global", DenseLayer(cfg, device))

    @property
    def global_(self) -> DenseLayer:
        return self._modules["global"]


class Model(nn.Module):
    SPECS = NORM_SPECS

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.remat = remat
        self.mesh = None        # set by sharding.place.shard_params
        self.device = dev = resolve_device(device)
        self.embed = L.Embed(cfg, dev)
        self.final_norm = L.param((cfg.d_model,), dev)
        t = cfg.arch_type
        if t in ("dense", "vlm"):
            if cfg.local_global_ratio:
                ng, rem = divmod(cfg.n_layers, cfg.local_global_ratio + 1)
                if rem:
                    raise ValueError(f"{cfg.name}: {cfg.n_layers} layers "
                                     "do not make whole local:global groups")
                self.groups = nn.ModuleList(LocalGlobalGroup(cfg, dev)
                                            for _ in range(ng))
            else:
                self.layers = self._stack(DenseLayer, cfg.n_layers)
        elif t == "moe":
            nd = cfg.first_k_dense
            if nd:
                self.dense_layers = self._stack(DenseLayer, nd)
            self.layers = self._stack(MoELayer, cfg.n_layers - nd)
        elif t == "ssm":
            self.layers = self._stack(SSMLayer, cfg.n_layers)
        elif t == "hybrid":
            self.layers = self._stack(SSMLayer, cfg.n_layers)
            self.shared_attn = DenseLayer(cfg, dev)
        elif t == "audio":
            self.encoder = nn.ModuleList(
                DenseLayer(cfg, dev, causal=False)
                for _ in range(cfg.encoder_layers))
            self.layers = self._stack(XAttnLayer, cfg.n_layers)
            self.enc_norm = L.param((cfg.d_model,), dev)
        else:
            raise ValueError(t)

    def _stack(self, cls, n: int) -> nn.ModuleList:
        return nn.ModuleList(cls(self.cfg, self.device) for _ in range(n))

    # ================================================================ init
    def init(self, generator: torch.Generator) -> dict:
        """Random parameters from ``generator`` (on the model's device),
        the reference's distributions: dense weights N(0, 0.02), output
        projections N(0, 0.02 / sqrt(2 n_layers)), norms 0, the router
        N(0, 0.006) and the Mamba2 block's own (``Mamba2.init_``).
        Returns the parameters by name (no logical-axis specs)."""
        _zero(self.final_norm)
        if hasattr(self, "enc_norm"):
            _zero(self.enc_norm)
        for m in self.modules():
            if m is not self and hasattr(m, "init_"):
                m.init_(generator)
        return dict(self.named_parameters())

    # ========================================================== sharding
    def specs(self) -> dict:
        """Logical axes of every parameter, by ``named_parameters()`` name:
        the reference's ``init`` spec tree without the stacked layer axis.
        Each module's ``SPECS`` names its own parameters."""
        out = {}
        for prefix, mod in self.named_modules():
            for name, _ in mod.named_parameters(recurse=False):
                out[f"{prefix}.{name}" if prefix else name] = \
                    mod.SPECS[name]
        return out

    def cache_specs(self) -> Any:
        """Logical axes of ``cache_init``'s caches, in its structure (lists
        of per-layer dicts) without the host-int ``len``."""
        cfg = self.cfg
        t = cfg.arch_type

        def gqa(n, window=False):
            return [L.gqa_cache_specs(window=window) for _ in range(n)]

        if t in ("dense", "vlm"):
            if cfg.attention == "mla":
                return [L.mla_cache_specs() for _ in range(cfg.n_layers)]
            if cfg.local_global_ratio:
                return [{"local": gqa(cfg.local_global_ratio, window=True),
                         "global": L.gqa_cache_specs()}
                        for _ in range(len(self.groups))]
            return gqa(cfg.n_layers)
        if t == "moe":
            nd = cfg.first_k_dense
            out = {"moe": gqa(cfg.n_layers - nd)}
            if nd:
                out["dense"] = gqa(nd)
            return out
        if t in ("ssm", "hybrid"):
            mamba = [M.mamba2_cache_specs() for _ in range(cfg.n_layers)]
            if t == "ssm":
                return mamba
            return {"mamba": mamba,
                    "attn": gqa(-(-cfg.n_layers // cfg.shared_attn_every))}
        if t == "audio":
            cross = ("dp", None, None, None)
            return {"self": gqa(cfg.n_layers),
                    "cross": [{"k": cross, "v": cross}
                              for _ in range(cfg.n_layers)]}
        raise ValueError(t)

    def _sharded(self):
        """DTensor's implicit replication of the plain tensors an entry
        point makes, when the parameters are DTensors."""
        if self.mesh is None:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import implicit_replication
        return implicit_replication()

    @contextlib.contextmanager
    def _serving(self):
        """No graph for prefill / decode: ``inference_mode``, or on DTensor
        parameters ``no_grad`` (a view of a DTensor parameter fails under
        ``inference_mode``)."""
        grad_off = (torch.inference_mode() if self.mesh is None
                    else torch.no_grad())
        with grad_off, self._sharded():
            yield

    # ============================================================ inputs
    def _input(self, a, dtype=None) -> torch.Tensor:
        if self.mesh is not None and hasattr(a, "device_mesh"):
            return a if dtype is None else a.to(dtype)
        return torch.as_tensor(a, device=self.device, dtype=dtype)

    def _embed_inputs(self, batch: dict):
        """Token embeddings (vision patches prepended, sinusoidal
        positions added where the family has no rope) and positions."""
        cfg = self.cfg
        tokens = self._input(batch["tokens"], torch.long)
        b = tokens.shape[0]
        h = self.embed(tokens)
        if cfg.arch_type == "vlm" and "vision_embeds" in batch:
            ve = self._input(batch["vision_embeds"]).to(h.dtype)
            h = torch.cat([ve, h], dim=1)
        if cfg.rope_theta <= 0 and cfg.arch_type != "ssm":
            h = h + L.sinusoidal_positions(h.shape[1], cfg.d_model,
                                           device=self.device
                                           ).to(h.dtype)[None]
        positions = torch.arange(h.shape[1], device=self.device).expand(
            b, h.shape[1])
        enc_out = None
        if cfg.arch_type == "audio":
            enc_out = self._encode(self._input(batch["frames"]))
        return h, positions, enc_out

    # ============================================================ forward
    def forward(self, batch: dict):
        """Teacher-forced forward: (logits (B, S, V) over the padded
        vocab, aux_loss scalar)."""
        with self._sharded():
            return self._forward(batch)

    def _forward(self, batch: dict):
        cfg = self.cfg
        s_text = batch["tokens"].shape[1]
        h, positions, enc_out = self._embed_inputs(batch)
        h, aux = self._backbone(h, positions, enc_out=enc_out)
        h = L.rmsnorm(h, self.final_norm, cfg.norm_eps)
        logits = self.embed.unembed_apply(h)
        if cfg.arch_type == "vlm" and "vision_embeds" in batch:
            logits = logits[:, -s_text:]     # text positions only
        return logits, aux

    def _encode(self, frames):
        cfg = self.cfg
        h = frames.to(L.ACT_DTYPE)
        h = h + L.sinusoidal_positions(h.shape[1], cfg.d_model,
                                       device=self.device).to(h.dtype)[None]
        positions = torch.arange(h.shape[1], device=self.device).expand(
            h.shape[0], h.shape[1])
        for lp in self.encoder:
            h = self._wrap(lp)(h, positions)
        return L.rmsnorm(h, self.enc_norm, cfg.norm_eps)

    # -------------------------------------------------------- backbones
    def _wrap(self, body):
        """A layer body of the teacher-forced forward, rematerialized
        under ``remat`` (``runtime.checkpoint_wrap``)."""
        return RT.checkpoint_wrap(body) if self.remat else body

    def _backbone(self, h, positions, *, enc_out=None, caches=None,
                  update_cache=False):
        """The family's stack over h; with ``caches``, each layer reads
        and (``update_cache``) writes its cache. Returns (h, aux).
        Without caches (the teacher-forced forward) each layer body goes
        through ``_wrap``."""
        cfg = self.cfg
        t = cfg.arch_type
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        wrap = self._wrap if caches is None else (lambda body: body)
        kw = dict(update_cache=update_cache)
        if t in ("dense", "vlm") and cfg.local_global_ratio:
            def group(x, grp, gc):   # ratio windowed layers + 1 global
                for i, lp in enumerate(grp.local):
                    x = lp(x, positions, window=cfg.sliding_window,
                           cache=gc and gc["local"][i], **kw)
                return grp.global_(x, positions, cache=gc and gc["global"],
                                   **kw)
            for g, grp in enumerate(self.groups):
                h = wrap(group)(h, grp, _at(caches, g))
        elif t in ("dense", "vlm"):
            for i, lp in enumerate(self.layers):
                h = wrap(lp)(h, positions, cache=_at(caches, i), **kw)
        elif t == "moe":
            for i, lp in enumerate(getattr(self, "dense_layers", ())):
                h = wrap(lp)(h, positions,
                             cache=_at(caches and caches["dense"], i), **kw)
            for i, lp in enumerate(self.layers):
                h, a_loss = wrap(lp)(h, positions,
                                     cache=_at(caches and caches["moe"], i),
                                     **kw)
                aux = aux + a_loss
        elif t == "ssm":
            for i, lp in enumerate(self.layers):
                h = wrap(lp)(h, cache=_at(caches, i), **kw)
        elif t == "hybrid":
            k = cfg.shared_attn_every

            def hybrid(x, i, lp, attn_cache, cache):
                if i % k == 0:   # the one shared block, cache slot i // k
                    x = self.shared_attn(x, positions, cache=attn_cache,
                                         **kw)
                return lp(x, cache=cache, **kw)
            for i, lp in enumerate(self.layers):
                h = wrap(hybrid)(h, i, lp,
                                 _at(caches and caches["attn"], i // k),
                                 _at(caches and caches["mamba"], i))
        elif t == "audio":
            for i, lp in enumerate(self.layers):
                h = wrap(lp)(h, positions, enc_out,
                             self_cache=_at(caches and caches["self"], i),
                             cross_cache=_at(caches and caches["cross"], i),
                             **kw)
        else:
            raise ValueError(t)
        return h, aux

    # ========================================================== serving
    def cache_init(self, batch: int, max_len: int) -> Any:
        """Per-layer caches for prefill / decode, on the model's device:
        the reference's tree with lists in place of stacked layer axes."""
        cfg = self.cfg
        t = cfg.arch_type
        dev = self.device

        def gqa(n, **kw):
            return [L.gqa_cache_init(cfg, batch, max_len, device=dev, **kw)
                    for _ in range(n)]

        if t in ("dense", "vlm"):
            if cfg.attention == "mla":
                return [L.mla_cache_init(cfg, batch, max_len, device=dev)
                        for _ in range(cfg.n_layers)]
            if cfg.local_global_ratio:
                return [{"local": gqa(cfg.local_global_ratio,
                                      window=cfg.sliding_window),
                         "global": gqa(1)[0]}
                        for _ in range(len(self.groups))]
            return gqa(cfg.n_layers)
        if t == "moe":
            nd = cfg.first_k_dense
            out = {"moe": gqa(cfg.n_layers - nd)}
            if nd:
                out["dense"] = gqa(nd)
            return out
        if t in ("ssm", "hybrid"):
            mamba = [M.mamba2_cache_init(cfg, batch, device=dev)
                     for _ in range(cfg.n_layers)]
            if t == "ssm":
                return mamba
            return {"mamba": mamba,
                    "attn": gqa(-(-cfg.n_layers // cfg.shared_attn_every))}
        if t == "audio":
            shape = (batch, cfg.encoder_frames, cfg.n_kv_heads, cfg.d_head)
            return {"self": gqa(cfg.n_layers),
                    "cross": [{"k": torch.zeros(shape, dtype=L.ACT_DTYPE,
                                                device=dev),
                               "v": torch.zeros(shape, dtype=L.ACT_DTYPE,
                                                device=dev)}
                              for _ in range(cfg.n_layers)]}
        raise ValueError(t)

    def prefill(self, batch: dict, caches):
        """The whole prompt, writing the caches; returns (last-position
        logits (B, V), caches)."""
        with self._serving():
            return self._prefill(batch, caches)

    def _prefill(self, batch: dict, caches):
        cfg = self.cfg
        h, positions, enc_out = self._embed_inputs(batch)
        h, _ = self._backbone(h, positions, enc_out=enc_out, caches=caches,
                              update_cache=True)
        h = L.rmsnorm(h[:, -1:], self.final_norm, cfg.norm_eps)
        return self.embed.unembed_apply(h)[:, 0], caches

    def decode_step(self, token, caches):
        """One token (B,) + caches -> (logits (B, V), caches). The
        position is the caches' host-side length: no device read."""
        with self._serving():
            return self._decode_step(token, caches)

    def _decode_step(self, token, caches):
        cfg = self.cfg
        token = self._input(token, torch.long)
        b = token.shape[0]
        h = self.embed(token[:, None])
        pos = self._cache_len(caches)
        positions = torch.full((b, 1), pos, dtype=torch.long,
                               device=self.device)
        if cfg.rope_theta <= 0 and cfg.arch_type != "ssm":
            h = h + L.sinusoidal_positions(1, cfg.d_model, offset=pos,
                                           device=self.device
                                           ).to(h.dtype)[None]
        h, _ = self._backbone(h, positions, caches=caches,
                              update_cache=True)
        h = L.rmsnorm(h, self.final_norm, cfg.norm_eps)
        return self.embed.unembed_apply(h)[:, 0], caches

    def _cache_len(self, caches) -> int:
        cfg = self.cfg
        t = cfg.arch_type
        if t in ("dense", "vlm"):
            if cfg.local_global_ratio:
                return caches[0]["global"]["len"]
            return caches[0]["len"]
        if t == "moe":
            return caches["moe"][0]["len"]
        if t == "hybrid":
            return caches["attn"][0]["len"]
        if t == "audio":
            return caches["self"][0]["len"]
        return 0   # pure ssm: no position is used


def _at(caches, i):
    return caches[i] if caches else None
