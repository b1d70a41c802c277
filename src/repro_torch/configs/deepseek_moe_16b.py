"""deepseek-moe-16b [moe] — fine-grained MoE, 2 shared + 64 routed top-6.

[arXiv:2401.06066]
28L d_model=2048 16H (kv=16) vocab=102400, expert d_ff=1408.
Layer 0 is a dense SwiGLU layer (d_ff=10944), layers 1..27 are MoE —
the paper's "first k dense" stabilization.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek_moe_16b",
    arch_type="moe",
    source="arXiv:2401.06066",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=10944,               # dense layers (first_k_dense)
    vocab_size=102400,
    attention="gqa",
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_k_dense=1,
    act="swiglu",
)
