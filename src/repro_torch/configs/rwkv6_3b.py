"""rwkv6-3b [ssm] — Finch, data-dependent decay; attention-free.
[arXiv:2404.05892; hf]
The paper's thread-mapping technique targets attention grids and is
inapplicable here (DESIGN.md §Arch-applicability); runs long_500k.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "rwkv6-3b"

CONFIG = ModelConfig(
    arch_id=ARCH_ID, family="ssm",
    n_layers=32, d_model=2560, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=8960, vocab_size=65536, rope_theta=0.0,
    attention_type="none", rwkv_heads=40, rwkv_decay_lora=64,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=64, d_ff=128, vocab_size=256, rwkv_heads=4,
        rwkv_decay_lora=16, max_seq=64, dtype="float32",
    )
