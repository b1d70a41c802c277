"""whisper-medium [audio] — encoder-decoder. [arXiv:2212.04356]

24L (x2: encoder + decoder) d_model=1024 16H d_ff=4096 vocab=51865.
The mel-spectrogram + conv frontend is a STUB per the assignment
carve-out: ``input_specs()`` supplies precomputed frame embeddings
(encoder_frames, d_model). rope_theta=0 -> absolute sinusoidal positions
(whisper uses learned/sinusoidal, not RoPE).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper_medium",
    arch_type="audio",
    source="arXiv:2212.04356",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=4096,
    vocab_size=51865,
    attention="gqa",
    rope_theta=0.0,           # sinusoidal absolute positions
    encoder_layers=24,
    encoder_frames=1500,
    cross_attention=True,
    act="gelu",
)
