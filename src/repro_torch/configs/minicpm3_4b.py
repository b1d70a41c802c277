"""minicpm3-4b [dense] — Multi-head Latent Attention (MLA).

[hf:openbmb/MiniCPM3-4B]
62L d_model=2560 40H d_ff=6400 vocab=73448.
MLA: q_lora_rank=768, kv_lora_rank=256, qk dims 64 nope + 32 rope,
v_head_dim=64. Decode caches the COMPRESSED c_kv + shared k_rope
(the MLA memory advantage), with the absorbed-matmul decode path.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3_4b",
    arch_type="dense",
    source="hf:openbmb/MiniCPM3-4B",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_head=64,
    d_ff=6400,
    vocab_size=73448,
    attention="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_rope_dim=32,
    qk_nope_dim=64,
    v_head_dim=64,
    act="swiglu",
)
