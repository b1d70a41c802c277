"""Runtime switches of the LM substrate that change the function one card
computes (the port's share of ``repro/models/runtime.py``).

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

The reference's training switches (``REMAT_POLICY``, ``MICROBATCHES``),
sharding hints (``SERVE_PURE_TP``, ``WINDOW_CACHE_SP``,
``GATHER_WEIGHTS``, ``MOE_XE_SHARD``) and ``UNROLL_SCANS`` (XLA's cost
analysis) are not carried: on one card they change nothing.
"""
from __future__ import annotations

SCORES_BF16 = False
CHUNKED_THRESHOLD = 8192
MLA_PAD_HEADS = False
EMBED_ONEHOT = False
MOE_GROUPED = False

FLAGS = ("SCORES_BF16", "CHUNKED_THRESHOLD", "MLA_PAD_HEADS",
         "EMBED_ONEHOT", "MOE_GROUPED")


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
