"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block.
[arXiv:2411.15242; hf]
Deviation: Zamba2's shared block is invoked with per-invocation LoRA
adapters; we model the shared weights without LoRA (see DESIGN.md).
Runs long_500k (sub-quadratic decode).
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "zamba2-1.2b"

CONFIG = ModelConfig(
    arch_id=ARCH_ID, family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000, rope_theta=10000.0,
    ssm_state=64, mamba_d_inner=4096, mamba_heads=64, mamba_conv_width=4,
    hybrid_attn_every=6,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256,
        ssm_state=16, mamba_d_inner=128, mamba_heads=8,
        hybrid_attn_every=3, max_seq=64, dtype="float32",
    )
