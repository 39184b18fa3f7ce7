"""``optimizer_ms``: device ms a traced step of every kernel launched inside
``train/optimizer.py``'s ``apply_updates``, which the train step looks up at
call time."""
from bench import readers

SPANS = {"optimizer": "repro_torch.train.optimizer:apply_updates"}


def read(ctx):
    return readers.span_ms_per_step(ctx, "optimizer")
