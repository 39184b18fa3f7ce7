"""``train_mfu``: model FLOPs of a training step (every product, the head,
causal attention over the lower triangle; forward and a backward of twice
its work, recompute not counted) over the step's host time and 989 TFLOP/s,
in %, over the window's untraced steps."""
from bench import readers

SPANS = {}


def read(ctx):
    return readers.step_mfu(ctx)
