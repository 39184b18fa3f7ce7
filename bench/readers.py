"""What the per-layer readers in ``bench/metrics/`` share.

A reader is a module with ``SPANS`` (name -> ``"module:attribute"`` of an
entry point of the program to wrap in a host range while the slice is
traced) and ``read(ctx)``, which returns the metric's value or None where
its run has nothing to read.  ``ctx`` has:

    ctx.trace     the slice's ``tracing.TraceView``
    ctx.calls     {span name: [call descriptions]} for the traced slice
    ctx.items     the window's items, each a dict with ``t0``, ``t1``
                  (host seconds), ``tokens`` and ``traced``
    ctx.config    the configuration file; ``ctx.model`` its model sizes
    ctx.traffic   the traffic file
    ctx.kind      the traffic kind's module (``bench/traffic/<kind>.py``)
    ctx.flops     the configuration's FLOP module (``bench/flops/``)
"""
from __future__ import annotations

import statistics

from bench import arith
from bench.tracing import BACKWARD_RANGE


def step_mfu(ctx):
    """Model FLOPs of the window's untraced items over their host time and
    the bf16 dense peak, in %."""
    items = [i for i in ctx.items if not i["traced"]]
    if not items:
        return None
    seconds = sum(i["t1"] - i["t0"] for i in items)
    flops = ctx.kind.item_flops(ctx.flops, ctx.model, ctx.traffic)
    return 100.0 * len(items) * flops / seconds / arith.MFU_PEAK


def roofline(ctx, span: str, cost):
    """The least time over the measured device time of entry ``span``, in
    %.  ``cost(call, backward)`` gives (FLOPs, bytes, dtype) of a call's
    forward, or of its backward.  A call with no autograd node is counted
    as a forward; a call with one is counted, forward and backward, once
    for each run of its node's backward (a forward recomputed in the
    backward adds time, not work).  The time is that of every kernel
    launched inside the entry's range and inside its node's backward."""
    calls = ctx.calls.get(span, [])
    if not calls:
        return None
    least = sum(arith.least_time(*cost(c, False))
                for c in calls if c["grad_fn"] is None)
    ranges = ["bench." + span]
    for node in {c["grad_fn"] for c in calls if c["grad_fn"]}:
        mine = [c for c in calls if c["grad_fn"] == node]
        per_run = sum(arith.least_time(*cost(c, False))
                      + arith.least_time(*cost(c, True))
                      for c in mine) / len(mine)
        name = BACKWARD_RANGE.format(node)
        least += ctx.trace.count(name) * per_run
        ranges.append(name)
    measured = ctx.trace.device_s(ranges)
    if measured <= 0 or least <= 0:
        return None
    return 100.0 * least / measured


def span_ms_per_step(ctx, span: str):
    """Device ms a traced step of the kernels launched inside ``span``."""
    if not ctx.calls.get(span):
        return None
    return 1e3 * ctx.trace.device_s(["bench." + span]) / ctx.trace.steps


def idle_share(ctx):
    """% of an untraced item's host time in which no kernel, copy or set
    ran on the device: one less the device's busy time a traced item over
    the mean host time of the window's untraced items.  The profiler's host
    cost stretches the traced items but not their busy time."""
    untraced = [i["t1"] - i["t0"] for i in ctx.items if not i["traced"]]
    if not untraced:
        return None
    busy = ctx.trace.busy_s / ctx.trace.steps
    return 100.0 * (1.0 - busy / statistics.fmean(untraced))
