"""``kernel_launches.score``: launches of one traced request charged to the
program's ``repro_torch.step`` range and every range inside it (kernels,
copies and sets that reached the device), by ``_spans``' rule: the most
any traced request has, since the profiler loses the records of its first
launches."""
from bench.metrics import _spans

SPANS = {}


def read(ctx):
    return _spans.launches_per_item(ctx)
