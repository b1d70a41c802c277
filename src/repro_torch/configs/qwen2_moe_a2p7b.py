"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4.

[hf:Qwen/Qwen1.5-MoE-A2.7B]
24L d_model=2048 16H (kv=16) vocab=151936, expert d_ff=1408.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2_moe_a2p7b",
    arch_type="moe",
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=5632,                # (unused: no dense layers)
    vocab_size=151936,
    attention="gqa",
    n_experts=60,
    n_shared_experts=4,
    top_k=4,
    moe_d_ff=1408,
    first_k_dense=0,
    act="swiglu",
)
