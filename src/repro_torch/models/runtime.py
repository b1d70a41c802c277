"""Runtime switches of the LM substrate that change the function one card
computes or how it trains (the port's share of
``repro/models/runtime.py``).

Each defaults to the reference's paper-faithful baseline:

* ``SCORES_BF16``: attention scores stored in bf16 (softmax still
  reduces in float32). A call with it on never takes the flash kernel.
* ``CHUNKED_THRESHOLD``: the query length from which ``attention_any``
  on the CPU takes the online-softmax ``chunked_attention`` instead of
  ``full_attention`` (on the card eligible calls take the flash kernel
  at any length).
* ``MLA_PAD_HEADS``: MLA's head count padded to a multiple of 16, the
  dummy heads' output rows zero.
* ``EMBED_ONEHOT``: the embedding lookup as a one-hot matmul.
* ``MOE_GROUPED``: MoE dispatch within each batch row, capacity per row.
* ``REMAT_POLICY``: what ``checkpoint_wrap`` keeps of a layer body's
  forward under ``Model(..., remat=True)``: ``"full"`` nothing (the
  whole body is recomputed in the backward), ``"dots"`` the outputs of
  the matrix products, ``"none"`` everything (no rematerialization).
* ``MICROBATCHES``: gradient-accumulation steps of a train step
  (``training.train.make_train_step``).

The sharding switches act only on a model whose parameters are DTensors
(``sharding.place.shard_params``); on one device they change nothing:

* ``SERVE_PURE_TP``: prefill / decode parameters TP-only, no fsdp dim
  (read by ``launch.dryrun`` and the callers of ``shard_params``).
* ``WINDOW_CACHE_SP``: sliding-window KV caches sharded on their
  sequence axis over "model" too (``layers.gqa_cache_specs``).
* ``GATHER_WEIGHTS``: a weight redistributed to its TP-only placement at
  its use (``layers.w``): the fsdp dims all-gathered, never the
  activations of a contraction reduced.
* ``MOE_XE_SHARD``: the MoE dispatch buffer sharded, experts over
  "model" and capacity rows over "data" (``moe._experts``).

``UNROLL_SCANS`` (XLA's cost analysis counts a scan body once) is not
carried: the port's stacks are Python loops.
"""
from __future__ import annotations

import torch

SCORES_BF16 = False
CHUNKED_THRESHOLD = 8192
MLA_PAD_HEADS = False
EMBED_ONEHOT = False
MOE_GROUPED = False
REMAT_POLICY = "full"      # full | dots (save matmul outputs) | none
MICROBATCHES = 1           # gradient accumulation steps per train step
SERVE_PURE_TP = False      # prefill/decode: params TP-only (no fsdp dim)
WINDOW_CACHE_SP = False    # shard sliding-window KV caches on seq (model)
GATHER_WEIGHTS = False     # gather fsdp-sharded weights at their use
MOE_XE_SHARD = False       # shard MoE dispatch buffers (E->model, cap->dp)

FLAGS = ("SCORES_BF16", "CHUNKED_THRESHOLD", "MLA_PAD_HEADS",
         "EMBED_ONEHOT", "MOE_GROUPED", "REMAT_POLICY", "MICROBATCHES",
         "SERVE_PURE_TP", "WINDOW_CACHE_SP", "GATHER_WEIGHTS",
         "MOE_XE_SHARD")
REMAT_POLICIES = ("full", "dots", "none")


def set_flags(**kw) -> None:
    """Set switches by name (case-insensitive), as the reference's
    ``set_flags``; an unknown name raises."""
    g = globals()
    for k, v in kw.items():
        key = k.upper()
        if key not in FLAGS:
            raise KeyError(f"unknown runtime flag {k!r}; expected one of "
                           f"{FLAGS}")
        g[key] = v


def _dots_policy(_ctx, op, *_args, **_kwargs):
    """Selective checkpoint policy of ``"dots"``: keep the outputs of the
    matrix products, recompute everything else (the reference's
    ``dots_with_no_batch_dims_saveable``, batched products included)."""
    from torch.utils.checkpoint import CheckpointPolicy
    dots = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default)
    return (CheckpointPolicy.MUST_SAVE if op in dots
            else CheckpointPolicy.PREFER_RECOMPUTE)


def checkpoint_wrap(body):
    """``body`` rematerialized under ``REMAT_POLICY`` (read here, when the
    body is wrapped): ``"full"`` recomputes it in the backward,
    ``"dots"`` recomputes all but its matrix products' outputs,
    ``"none"`` returns it as it is. Non-reentrant checkpointing, so its
    inputs need not require grad."""
    import functools

    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts,
                                        noop_context_fn)
    if REMAT_POLICY == "none":
        return body
    if REMAT_POLICY == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _dots_policy)
    elif REMAT_POLICY == "full":
        context_fn = noop_context_fn
    else:
        raise ValueError(f"REMAT_POLICY must be one of {REMAT_POLICIES}, "
                         f"got {REMAT_POLICY!r}")

    @functools.wraps(body)
    def wrapped(*args, **kwargs):
        return checkpoint(body, *args, use_reentrant=False,
                          context_fn=context_fn, **kwargs)
    return wrapped
