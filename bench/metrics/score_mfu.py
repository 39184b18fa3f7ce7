"""``score_mfu``: model FLOPs of a request's forward (every product, the
head, the sequence mixer) over the request's host time and 989 TFLOP/s, in
%, over the window's untraced requests."""
from bench import readers

SPANS = {}


def read(ctx):
    return readers.step_mfu(ctx)
