"""Config system: architecture + run configs and the input-shape pool
(the port's copy of ``repro/configs/base.py``; nothing here imports
``repro``).

Every assigned architecture registers a ``ModelConfig`` here via its
``src/repro_torch/configs/<arch>.py`` module; ``get_config(name)`` resolves it.
``reduced(cfg)`` derives the CPU smoke-test variant (2 layers,
d_model <= 512, <= 4 experts) of the same family.
"""
from __future__ import annotations

import dataclasses
import importlib

# ----------------------------------------------------------------- configs


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | audio | vlm
    source: str = ""               # citation (paper / model card)
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_head: int = 64
    d_ff: int = 1024
    vocab_size: int = 32000
    # attention flavour
    attention: str = "gqa"         # gqa | mla | none
    rope_theta: float = 10_000.0
    sliding_window: int = 0        # >0: local-attention window size
    local_global_ratio: int = 0    # gemma3: N local layers per 1 global
    logit_softcap: float = 0.0
    # MLA (minicpm3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0         # leading dense layers (deepseek-moe)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_kernel: int = 4
    expand: int = 2
    # hybrid (zamba2): one SHARED attention block applied every k layers
    shared_attn_every: int = 0
    # encoder-decoder / multimodal stubs
    encoder_layers: int = 0
    encoder_frames: int = 0        # whisper: stub frame-embedding count
    vision_tokens: int = 0         # vlm: stub patch-embedding count
    cross_attention: bool = False
    act: str = "swiglu"            # swiglu | gelu
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    @property
    def attn_layers(self) -> int:
        return self.n_layers if self.attention != "none" else 0

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a shardable multiple (table/unembed use this;
        padded logit columns are masked to -1e9)."""
        m = 512 if self.vocab_size >= 512 else 16
        return -(-self.vocab_size // m) * m

    @property
    def padded_experts(self) -> int:
        """Expert bank padded to the model-axis multiple (16); padded
        experts get -inf router logits and are never dispatched to."""
        return -(-self.n_experts // 16) * 16 if self.n_experts else 0

    def param_count(self) -> int:
        """Total parameters (approximate, used for MODEL_FLOPS)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        n = 0
        n += v * d                                     # embed
        if not self.tie_embeddings:
            n += v * d                                 # unembed
        per_layer = 0
        if self.arch_type in ("dense", "moe", "vlm", "audio"):
            per_layer += self._attn_params() + 2 * d   # attn + norms
            if self.arch_type == "moe":
                moe_f = self.moe_d_ff
                routed = self.n_experts * 3 * d * moe_f
                shared = self.n_shared_experts * 3 * d * moe_f
                router = d * self.n_experts
                per_layer += routed + shared + router
            else:
                per_layer += 3 * d * f if self.act == "swiglu" else 2 * d * f
            n += per_layer * self.n_layers
            if self.arch_type == "moe" and self.first_k_dense:
                n += self.first_k_dense * (3 * d * f - (
                    self.n_experts + self.n_shared_experts) * 3 * d *
                    self.moe_d_ff - d * self.n_experts)
            if self.arch_type == "audio":   # encoder stack + cross attn
                enc = self.encoder_layers * (4 * d * d + 3 * d * f
                                             if self.act == "swiglu"
                                             else 4 * d * d + 2 * d * f)
                n += enc + self.n_layers * 4 * d * d   # cross-attn per layer
        elif self.arch_type == "ssm":
            n += self.n_layers * self._ssm_params()
        elif self.arch_type == "hybrid":
            n += self.n_layers * self._ssm_params()
            n += self._attn_params() + 3 * d * f       # ONE shared block
        return n

    def _attn_params(self) -> int:
        d = self.d_model
        if self.attention == "mla":
            r_q, r_kv = self.q_lora_rank, self.kv_lora_rank
            h = self.n_heads
            qd = self.qk_rope_dim + self.qk_nope_dim
            return (d * r_q + r_q * h * qd + d * (r_kv + self.qk_rope_dim)
                    + r_kv * h * (self.qk_nope_dim + self.v_head_dim)
                    + h * self.v_head_dim * d)
        hd, kvd = self.n_heads * self.d_head, self.n_kv_heads * self.d_head
        return d * hd + 2 * d * kvd + hd * d

    def _ssm_params(self) -> int:
        d = self.d_model
        d_in = self.expand * d
        ng = max(1, self.ssm_heads // 8)
        conv_dim = d_in + 2 * ng * self.ssm_state
        return (d * (2 * d_in + 2 * ng * self.ssm_state + self.ssm_heads)
                + conv_dim * self.conv_kernel + 3 * self.ssm_heads
                + d_in * d)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top-k + shared only)."""
        if self.arch_type != "moe":
            return self.param_count()
        d, moe_f = self.d_model, self.moe_d_ff
        total = self.param_count()
        routed_all = self.n_layers * self.n_experts * 3 * d * moe_f
        routed_active = self.n_layers * self.top_k * 3 * d * moe_f
        return total - routed_all + routed_active


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

ARCH_NAMES = [
    "phi3_vision_4p2b", "mamba2_780m", "phi4_mini_3p8b", "gemma3_12b",
    "deepseek_moe_16b", "minicpm3_4b", "whisper_medium", "zamba2_1p2b",
    "qwen2_moe_a2p7b", "deepseek_67b",
]

# archs able to run long_500k (sub-quadratic path)
LONG_CONTEXT_ARCHS = {"mamba2_780m", "zamba2_1p2b", "gemma3_12b"}


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG


def list_configs() -> list[str]:
    return list(ARCH_NAMES)


def supports_shape(cfg: ModelConfig, shape: InputShape) -> bool:
    if shape.name == "long_500k":
        return cfg.name in LONG_CONTEXT_ARCHS
    return True


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test variant: same family, tiny dims (CPU-runnable)."""
    kw = dict(
        n_layers=2, d_model=min(cfg.d_model, 128),
        n_heads=min(cfg.n_heads, 4),
        d_head=32, d_ff=min(cfg.d_ff, 256) or 0,
        vocab_size=min(cfg.vocab_size, 512),
        q_lora_rank=min(cfg.q_lora_rank, 64),
        kv_lora_rank=min(cfg.kv_lora_rank, 32),
        qk_rope_dim=min(cfg.qk_rope_dim, 16),
        qk_nope_dim=min(cfg.qk_nope_dim, 16),
        v_head_dim=min(cfg.v_head_dim, 32),
        n_experts=min(cfg.n_experts, 4),
        n_shared_experts=min(cfg.n_shared_experts, 1),
        top_k=min(cfg.top_k, 2),
        moe_d_ff=min(cfg.moe_d_ff, 128),
        first_k_dense=min(cfg.first_k_dense, 1),
        ssm_state=min(cfg.ssm_state, 16),
        ssm_heads=min(cfg.ssm_heads, 4),
        ssm_head_dim=min(cfg.ssm_head_dim, 32),
        ssm_chunk=32,
        sliding_window=min(cfg.sliding_window, 64),
        shared_attn_every=min(cfg.shared_attn_every, 2) or 0,
        encoder_layers=min(cfg.encoder_layers, 2),
        encoder_frames=min(cfg.encoder_frames, 16),
        vision_tokens=min(cfg.vision_tokens, 8),
        name=cfg.name + "_reduced",
    )
    kv = min(cfg.n_kv_heads, 4)
    kw["n_kv_heads"] = min(kv, kw["n_heads"])
    if cfg.local_global_ratio:
        kw["local_global_ratio"] = 1
        kw["n_layers"] = 2  # 1 local + 1 global group
    return dataclasses.replace(cfg, **kw)
