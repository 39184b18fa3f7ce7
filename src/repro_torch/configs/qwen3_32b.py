"""qwen3-32b [dense] — qk_norm, GQA kv=8.  [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "qwen3-32b"

CONFIG = ModelConfig(
    arch_id=ARCH_ID, family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=25600, vocab_size=151936, rope_theta=1000000.0, qk_norm=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, max_seq=64, dtype="float32",
    )
