"""The cost of one call of ``kernels/tri_attn/ops.py``'s
``causal_attention(q, k, v, ...)``, q (B, H, S, D) and k, v (B, Hk, S, D),
for the ``tri_attn_roofline.*`` readers."""
from bench import arith

SPANS = {"tri_attn": "repro_torch.kernels.tri_attn.ops:causal_attention"}


def cost(call, backward: bool):
    (q, dtype), (k, _) = call["tensors"][0], call["tensors"][1]
    b, h, s, d = q
    fn = arith.tri_attn_backward if backward else arith.tri_attn_forward
    return (*fn(b, h, k[1], s, d, dtype), dtype)
