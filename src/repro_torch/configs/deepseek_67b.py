"""deepseek-67b [dense] — llama-arch at depth. [arXiv:2401.02954]

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek_67b",
    arch_type="dense",
    source="arXiv:2401.02954",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=22016,
    vocab_size=102400,
    attention="gqa",
    rope_theta=10_000.0,
    act="swiglu",
)
