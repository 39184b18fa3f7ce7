"""Model FLOPs of an RWKV-6 model (time mix r, k, v, g, o and the decay
LoRA; channel mix k, v, r; untied head), from the configuration's
``model`` sizes."""
from bench import arith

#: the chunk length of the port's chunked WKV
CHUNK = 64


def matmul_params(m: dict) -> int:
    """Weights of the products, the head included."""
    d, f, lora = m["d_model"], m["d_ff"], m["rwkv_decay_lora"]
    layer = 5 * d * d + 2 * d * lora + 2 * d * f + d * d
    return m["n_layers"] * layer + d * m["vocab_size"]


def forward(m: dict, batch: int, seq: int) -> float:
    """One teacher-forced forward over (batch, seq): every weight product,
    the head, and the chunked WKV."""
    hd = m["d_model"] // m["rwkv_heads"]
    mix, _ = arith.wkv_chunked(batch * m["rwkv_heads"], seq, hd, CHUNK,
                               "bfloat16", "float32")
    return 2.0 * batch * seq * matmul_params(m) + m["n_layers"] * mix
