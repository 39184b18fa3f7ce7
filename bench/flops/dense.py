"""Model FLOPs of a dense decoder (GQA attention with RoPE, SwiGLU MLP,
untied head), from the configuration's ``model`` sizes; after
``repro_torch/launch/analytic.py``'s ``param_counts`` and ``_attn_flops``,
counted exactly."""
from bench import arith


def matmul_params(m: dict) -> int:
    """Weights of the products, the head included and the lookup table
    not."""
    d, h, hk, hd, f = (m["d_model"], m["n_heads"], m["n_kv_heads"],
                       m["head_dim"], m["d_ff"])
    layer = d * h * hd + 2 * d * hk * hd + h * hd * d + 3 * d * f
    return m["n_layers"] * layer + d * m["vocab_size"]


def forward(m: dict, batch: int, seq: int) -> float:
    """One teacher-forced forward over (batch, seq): every weight product,
    the head, and causal attention over the lower triangle."""
    mix, _ = arith.tri_attn_forward(batch, m["n_heads"], m["n_kv_heads"],
                                    seq, m["head_dim"], "bfloat16")
    return 2.0 * batch * seq * matmul_params(m) + m["n_layers"] * mix
