"""zamba2-1.2b [hybrid] — Mamba2 backbone + SHARED attention block.

[arXiv:2411.15242]
38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000, ssm_state=64.
One weight-tied attention+FFN block is invoked every 6th layer (7
invocations share a single parameter set) — the Zamba trick that buys
attention quality at near-zero parameter cost. SSM path qualifies the
arch for long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2_1p2b",
    arch_type="hybrid",
    source="arXiv:2411.15242",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_head=64,
    d_ff=8192,
    vocab_size=32000,
    attention="gqa",
    ssm_state=64,
    ssm_heads=64,             # expand*d_model / ssm_head_dim
    ssm_head_dim=64,
    ssm_chunk=256,
    shared_attn_every=6,
    tie_embeddings=True,
)
