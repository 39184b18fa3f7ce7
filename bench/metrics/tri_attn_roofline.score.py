"""``tri_attn_roofline.score``: least time over measured device time of the
attention entry ``causal_attention`` (which ``models/attention.py`` looks up
at call time), in %.  Least time: the larger of the causal
work at 989 TFLOP/s (bf16 inputs) and q, k, v read and o written once at
3.35 TB/s."""
from bench import readers
from bench.metrics import _tri_attn

SPANS = _tri_attn.SPANS


def read(ctx):
    return readers.roofline(ctx, "tri_attn", _tri_attn.cost)
