"""deepseek-v2-236b [moe] — MLA (kv_lora=512) + 2 shared + 160 routed top-6.
[arXiv:2405.04434; hf]
Deviation: the paper's first dense layer is modeled as MoE (homogeneous
scan-over-layers); MLA dims are the published ones (q_lora 1536, kv_lora 512,
nope 128, rope 64, v 128).
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "deepseek-v2-236b"

CONFIG = ModelConfig(
    arch_id=ARCH_ID, family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=1536, vocab_size=102400, rope_theta=10000.0,
    attention_type="mla",
    q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128,
    n_experts=160, moe_top_k=6, expert_d_ff=1536, n_shared_experts=2,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=96, vocab_size=256,
        q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
        v_head_dim=16,
        n_experts=8, moe_top_k=2, expert_d_ff=96, n_shared_experts=1,
        max_seq=64, dtype="float32",
    )
