"""``head_ms.train``: device ms a traced step of every launch charged to the
program's ``repro_torch.head`` (the final norm and the fp32 vocab product)
and ``repro_torch.loss`` ranges (the fp32 cast, logsumexp, the label's
logit, cross entropy and z-loss), forward and backward, by ``_spans``'
rule."""
from bench.metrics import _spans

SPANS = {}


def read(ctx):
    return _spans.ms_per_item(ctx, ["head", "loss"])
