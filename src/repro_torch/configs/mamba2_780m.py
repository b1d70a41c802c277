"""mamba2-780m [ssm] — SSD (state-space duality). [arXiv:2405.21060]

48L d_model=1536, attention-free, vocab=50280, ssm_state=128.
d_inner = 2*d_model = 3072, head_dim 64 -> 48 SSD heads, 1 group.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2_780m",
    arch_type="ssm",
    source="arXiv:2405.21060",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    attention="none",
    ssm_state=128,
    ssm_heads=48,            # expand*d_model / ssm_head_dim
    ssm_head_dim=64,
    ssm_chunk=256,
    conv_kernel=4,
    expand=2,
    tie_embeddings=True,
)
