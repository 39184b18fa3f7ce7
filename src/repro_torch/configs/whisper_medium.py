"""whisper-medium [audio] — enc-dec, conv frontend STUB (precomputed frame
embeddings via input_specs).  [arXiv:2212.04356; unverified]
"24L" = 24 encoder + 24 decoder layers (whisper-medium's published config).
Decoder shapes drive seq_len; encoder is fixed at 1500 frames.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "whisper-medium"

CONFIG = ModelConfig(
    arch_id=ARCH_ID, family="audio",
    n_layers=48, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=51865, rope_theta=0.0,
    is_encoder_decoder=True, encoder_layers=24, decoder_layers=24,
    encoder_seq=1500,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256,
        encoder_layers=2, decoder_layers=2, encoder_seq=24,
        max_seq=64, dtype="float32",
    )
