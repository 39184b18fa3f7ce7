"""llama-3.2-vision-11b [vlm] — 40L (32 self + 8 gated cross-attn image
layers, 1 per 5-layer group), GQA kv=8.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
Vision frontend is a STUB: input_specs provides precomputed patch embeddings.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "llama-3.2-vision-11b"

CONFIG = ModelConfig(
    arch_id=ARCH_ID, family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=128256, rope_theta=500000.0,
    cross_attn_every=5, vision_seq=4100,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=10, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, vision_seq=12, max_seq=64, dtype="float32",
    )
