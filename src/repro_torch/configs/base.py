"""ModelConfig — the single config dataclass every architecture instantiates.

One file per assigned architecture lives next to this module; each exposes
``CONFIG`` (full-size, exact published dims) and ``smoke_config()`` (reduced
same-family config for CPU tests).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ModelConfig:
    arch_id: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    rope_theta: float = 10000.0
    qk_norm: bool = False
    attention_type: str = "gqa"     # gqa | mla | none
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # --- MLA (deepseek-v2) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mla_absorb: str = "auto"        # auto (decode steps) | never
    kv_cache_quant: bool = False    # int8 KV cache (absmax per row)
    # --- MoE ---
    n_experts: int = 0
    moe_top_k: int = 0
    expert_d_ff: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    moe_renormalize: bool = True
    moe_groups: int = 1             # >1: group-local dispatch (G = data axis)
    moe_impl: str = "global"        # global | grouped | a2a (shard_map EP)
    # --- RWKV6 ---
    rwkv_heads: int = 0
    rwkv_decay_lora: int = 64
    # --- Mamba2 / hybrid ---
    ssm_state: int = 0
    mamba_d_inner: int = 0
    mamba_heads: int = 0
    mamba_conv_width: int = 4
    hybrid_attn_every: int = 0      # zamba2: shared attn block period
    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    decoder_layers: int = 0
    encoder_seq: int = 1500         # whisper conv-stub output frames
    # --- vlm ---
    cross_attn_every: int = 0       # llama-3.2-vision: 1 cross per 5 layers
    vision_seq: int = 4100          # stub patch embeddings (4 tiles x 1025)
    # --- kernels / numerics ---
    attn_impl: str = "xla"          # xla | pallas_mapped | pallas_bb
    attn_block: int = 128
    pallas_interpret: bool = False
    dtype: str = "bfloat16"         # bfloat16 | float32 | float64 (CPU checks)
    remat: bool = True
    remat_policy: str = "full"      # full (recompute all) | dots | none
    scan_layers: bool = True
    # --- shapes ---
    max_seq: int = 4096

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab_size // 128) * 128

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch supports long-context decode (SSM/hybrid)."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
