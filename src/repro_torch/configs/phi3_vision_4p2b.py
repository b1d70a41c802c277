"""phi-3-vision-4.2b [vlm] — phi3-mini decoder + CLIP vision frontend.

[hf:microsoft/Phi-3-vision-128k-instruct]
32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064.
The ViT/projector frontend is a STUB per the assignment carve-out:
``input_specs()`` supplies precomputed patch embeddings (vision_tokens,
d_model) that are prepended to the text sequence.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3_vision_4p2b",
    arch_type="vlm",
    source="hf:microsoft/Phi-3-vision-128k-instruct",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_head=96,
    d_ff=8192,
    vocab_size=32064,
    attention="gqa",
    rope_theta=10_000.0,
    vision_tokens=576,       # one 336px CLIP-L crop worth of patch embeds
    act="swiglu",
)
