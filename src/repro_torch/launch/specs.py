"""Abstract inputs per (architecture x shape) for the dry run (the port
of ``repro/launch/specs.py``): fake tensors (shapes and dtypes, no
storage), placed on a mesh as DTensors by the sharding rules. Call each
under the ``FakeTensorMode`` of ``models.model.abstract_model``.

``batch_specs`` (a train / prefill batch: tokens, labels for training,
the family's stub embeddings), ``decode_token_specs`` (one token a
row), ``abstract_params`` (a fake model with every parameter placed),
``abstract_cache`` (its caches at a length, placed by
``Model.cache_specs()``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models.model import Model, abstract_model
from repro_torch.sharding import place
from repro_torch.sharding import rules as R


def _placed(shape, dtype, mesh) -> torch.Tensor:
    t = torch.zeros(shape, dtype=dtype)
    return place.distribute(t, mesh, R.dp_placements(mesh, shape))


def batch_specs(cfg: ModelConfig, shape: InputShape, mesh) -> dict:
    """The train / prefill batch of ``shape``: tokens (B, S) (S less the
    vision tokens for a VLM, whose total stays S), labels when training,
    and ``vision_embeds`` / ``frames`` in bf16; the batch dim over the
    data axes where they divide it."""
    b, s = shape.global_batch, shape.seq_len
    out = {}
    text = s
    if cfg.arch_type == "vlm":
        text = s - cfg.vision_tokens
        out["vision_embeds"] = _placed((b, cfg.vision_tokens, cfg.d_model),
                                       torch.bfloat16, mesh)
    if cfg.arch_type == "audio":
        out["frames"] = _placed((b, cfg.encoder_frames, cfg.d_model),
                                torch.bfloat16, mesh)
    out["tokens"] = _placed((b, text), torch.long, mesh)
    if shape.kind == "train":
        out["labels"] = _placed((b, text), torch.long, mesh)
    return out


def decode_token_specs(shape: InputShape, mesh) -> torch.Tensor:
    """One token a row (B,); the rows over the data axes when B > 1."""
    return _placed((shape.global_batch,), torch.long, mesh)


def abstract_params(cfg: ModelConfig, mesh, *, remat: bool = False,
                    serve_pure_tp: bool = False):
    """``(model, params, mode)``: a model of fake tensors whose parameters
    are placed by the rules (``serve_pure_tp``: TP-only), and its
    ``FakeTensorMode``."""
    model, mode = abstract_model(cfg, remat=remat)
    with mode:
        params = place.shard_params(model, mesh, serve_pure_tp=serve_pure_tp)
    return model, params, mode


def abstract_cache(model: Model, batch: int, max_len: int, mesh):
    """The model's caches for ``batch`` rows of ``max_len`` positions,
    fake and placed by ``model.cache_specs()`` (``runtime.WINDOW_CACHE_SP``
    read there)."""
    return place.shard_cache(model.cache_init(batch, max_len),
                             model.cache_specs(), mesh)
