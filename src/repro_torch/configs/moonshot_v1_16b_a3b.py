"""moonshot-v1-16b-a3b [moe] — kimi/moonlight-style, 64 experts top-6.
[hf:moonshotai/Moonlight-16B-A3B; hf]
Deviation: Moonlight's first dense layer is modeled as MoE like the rest
(homogeneous scan; <0.5% param delta — see DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "moonshot-v1-16b-a3b"

CONFIG = ModelConfig(
    arch_id=ARCH_ID, family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=163840, rope_theta=50000.0,
    n_experts=64, moe_top_k=6, expert_d_ff=1408, n_shared_experts=2,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=96, vocab_size=256, n_experts=8, moe_top_k=2, expert_d_ff=96,
        n_shared_experts=1, max_seq=64, dtype="float32",
    )
