"""``ffn_ms.train``: device ms a traced step of every launch charged to the
program's ``repro_torch.ffn`` ranges (``models/transformer.py``: a layer's
second norm, SwiGLU or channel mix and residual add; forward, remat
recompute and backward), by ``_spans``' rule."""
from bench.metrics import _spans

SPANS = {}


def read(ctx):
    return _spans.ms_per_item(ctx, ["ffn"])
