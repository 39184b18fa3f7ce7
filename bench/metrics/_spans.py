"""Device time and launches charged to the program's own ranges, for the
``mixer_ms.*``, ``ffn_ms.*``, ``head_ms.*`` and ``kernel_launches.*``
readers.

The program opens ``repro_torch.<name>`` ranges (``step``, ``mixer``,
``ffn``, ``head``, ``loss``: ``repro_torch/obs/trace.py``'s ``region``)
while a profiler records.  The rule, on what ``tracing.TraceView`` keeps:

- a launch is a ``cuda_runtime`` or ``cuda_driver`` event whose correlation
  id has a device event (a kernel, a copy or a set), counted once;
- its range is the innermost one around it on its own thread among the
  program's ranges and the autograd engine's ranges of backward nodes
  (``autograd::engine::evaluate_function: <node>``);
- where that is a node, the launch goes to the program's range that enclosed
  the node's forward op: the op of the node's ``Sequence number`` on the
  thread where the step ran (the ``repro_torch.step`` ranges' thread), the
  last to start before the node (ops that only read the counter share its
  number; the op that makes the node is the last of them).  A node evaluated
  inside another node's range was made in that backward (tri_attn's and
  wkv's plain vjps run autograd themselves), so its launches go with the
  outermost node around it.

A layer recomputed in the backward opens its ranges again inside the node
that asked for it, so the recompute's launches are charged to the layer
directly.  On a card autograd runs the backward on its own device thread; on
the CPU on the caller's, inside ``step``: the rule gives both the same.
Launches in no program range (the bench's own, outside the step) and in a
node that has no forward op (``AccumulateGrad``) are charged to none.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

from bench.tracing import BACKWARD_RANGE, STEP_RANGE, _end

PREFIX = "repro_torch."
STEP = PREFIX + "step"
NODE = BACKWARD_RANGE.format("")
_SEQ = "Sequence number"


def _innermost(ranges, times):
    """For each of ``times`` (sorted), the stack of ``ranges`` (events on one
    thread, properly nested) open at that time, outermost first."""
    order = sorted(ranges, key=lambda r: (float(r["ts"]), -float(r["dur"])))
    out, stack, k = [], [], 0
    for t in times:
        while k < len(order) and float(order[k]["ts"]) <= t:
            stack.append(order[k])
            k += 1
        stack = [r for r in stack if _end(r) >= t]
        out.append(list(stack))
    return out


def _enclosing(ranges, starts, t):
    """The innermost of ``ranges`` (sorted by start, properly nested;
    ``starts`` their starts) that holds time ``t``, or None."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0 and _end(ranges[i]) < t:
        i -= 1
    return ranges[i] if i >= 0 else None


def _owner(stack):
    """The program range or the outermost node of the innermost run of
    nodes, from a stack of open ranges (outermost first); None if empty."""
    owner = None
    for r in reversed(stack):
        if r["name"].startswith(PREFIX):
            return owner or r
        owner = r
    return owner


def charge(view) -> dict | None:
    """{range name without ``repro_torch.``: (device µs, launches)} for the
    traced slice, None where the trace holds no ``repro_torch.step``."""
    owners = launch_ranges(view)
    if owners is None:
        return None
    out = {}
    for corr, name in owners.items():
        us, n = out.get(name, (0.0, 0))
        out[name] = (us + view._device[corr], n + 1)
    return out


def launch_ranges(view) -> dict | None:
    """{correlation id: range name without ``repro_torch.``} of every launch
    charged to a range; None where the trace holds no ``repro_torch.step``.
    Computed once a view."""
    if not hasattr(view, "_spans_owners"):
        view._spans_owners = _launch_ranges(view)
    return view._spans_owners


def _launch_ranges(view):
    steps = view._ranges.get(STEP, [])
    if not steps:
        return None
    owners = defaultdict(list)          # (pid, tid) -> program and nodes
    program = defaultdict(list)         # (pid, tid) -> program ranges
    fwd_threads = {(r["pid"], r["tid"]) for r in steps}
    by_seq = defaultdict(list)          # seq -> [(ts, thread)] of forward ops
    for name, events in view._ranges.items():
        mine, node = name.startswith(PREFIX), name.startswith(NODE)
        for e in events:
            where = (e["pid"], e["tid"])
            if mine or node:
                owners[where].append(e)
            if mine:
                program[where].append(e)
            seq = e.get("args", {}).get(_SEQ)
            if (not node and seq is not None and seq >= 0
                    and where in fwd_threads):
                by_seq[seq].append((float(e["ts"]), where))
    for v in by_seq.values():
        v.sort()
    starts = {}
    for where, rs in program.items():
        rs.sort(key=lambda r: (float(r["ts"]), -float(r["dur"])))
        starts[where] = [float(r["ts"]) for r in rs]

    def forward_range(node):
        """The program range that enclosed ``node``'s forward op."""
        ops = by_seq.get(node.get("args", {}).get(_SEQ), [])
        i = bisect.bisect_left(ops, (float(node["ts"]),)) - 1
        if i < 0:
            return None
        ts, where = ops[i]
        return _enclosing(program[where], starts[where], ts)

    resolved, out = {}, {}
    for where, launches in view._launches.items():
        launches = [(t, c) for t, c in launches if c in view._device]
        stacks = _innermost(owners.get(where, []), [t for t, _ in launches])
        for (_, corr), stack in zip(launches, stacks):
            r = _owner(stack)
            if r is not None and not r["name"].startswith(PREFIX):
                if id(r) not in resolved:
                    resolved[id(r)] = forward_range(r)
                r = resolved[id(r)]
            if r is not None and corr not in out:
                out[corr] = r["name"][len(PREFIX):]
    return out


def ms_per_item(ctx, names):
    """Device ms a traced item charged to the ranges ``names``; None where
    no launch was charged to them (no program ranges, or no device)."""
    got = charge(ctx.trace)
    if not got:
        return None
    us = sum(got[n][0] for n in names if n in got)
    if not any(got[n][1] for n in names if n in got):
        return None
    return 1e-3 * us / ctx.trace.steps


def launches_per_item(ctx):
    """Launches charged to ``step`` and every range inside it in one traced
    item: the most any item has (every item runs the same launches; the
    profiler loses the device records of the first few launches after it
    starts, which then do not count); None where none was charged."""
    view = ctx.trace
    owners = launch_ranges(view)
    if not owners:
        return None
    items = sorted((float(r["ts"]), _end(r)) for r in view._ranges[STEP_RANGE])
    starts = [a for a, _ in items]
    when = {}
    for launches in view._launches.values():
        for t, corr in launches:
            if corr in owners:
                when[corr] = min(t, when.get(corr, t))
    counts = [0] * len(items)
    for t in when.values():
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= items[i][1]:
            counts[i] += 1
    return max(counts)
