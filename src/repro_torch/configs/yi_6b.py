"""yi-6b [dense] — llama-arch GQA kv=4.  [arXiv:2403.04652; hf]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "yi-6b"

CONFIG = ModelConfig(
    arch_id=ARCH_ID, family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab_size=64000, rope_theta=5000000.0,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, max_seq=64, dtype="float32",
    )
