"""granite-8b [dense] — llama-arch, code model.  [arXiv:2405.04324; hf]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "granite-8b"

CONFIG = ModelConfig(
    arch_id=ARCH_ID, family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=49152, rope_theta=10000000.0,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, max_seq=64, dtype="float32",
    )
