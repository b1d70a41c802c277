"""gemma3-12b [dense] — 5:1 local:global attention, 128k context.

[hf:google/gemma-3-1b-pt family, 12B point]
48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144.
Local layers use a 1024-token sliding window; every 6th layer is global.
The sliding window is what qualifies gemma3 for the long_500k decode
shape (local layers keep O(window) caches; the 8 global layers hold the
full 500k KV, O(seq) per decoded token).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3_12b",
    arch_type="dense",
    source="hf:google/gemma-3-1b-pt (12b)",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_head=256,
    d_ff=15360,
    vocab_size=262144,
    attention="gqa",
    rope_theta=1_000_000.0,
    sliding_window=1024,
    local_global_ratio=5,     # 5 local : 1 global
    act="gelu",
    tie_embeddings=True,
)
