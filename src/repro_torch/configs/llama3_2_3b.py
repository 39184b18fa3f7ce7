"""llama3.2-3b [dense] — small llama3, tied embeddings.
[hf:meta-llama/Llama-3.2-1B; unverified]
24 heads is not divisible by the 16-wide model axis: the sharding layer's
divisibility fallback replicates the head axis and keeps FSDP on embed.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "llama3.2-3b"

CONFIG = ModelConfig(
    arch_id=ARCH_ID, family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=128256, rope_theta=500000.0, tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=48, n_heads=6, n_kv_heads=2, head_dim=8,
        d_ff=96, vocab_size=256, max_seq=64, dtype="float32",
    )
