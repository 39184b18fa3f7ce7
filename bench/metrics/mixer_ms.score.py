"""``mixer_ms.score``: device ms a traced request of every launch charged to
the program's ``repro_torch.mixer`` ranges (``models/transformer.py``: a
layer's pre-norm, sequence mixer and residual add), by ``_spans``' rule."""
from bench.metrics import _spans

SPANS = {}


def read(ctx):
    return _spans.ms_per_item(ctx, ["mixer"])
