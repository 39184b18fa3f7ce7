"""Per-request distributed tracing — stdlib only.

The serving stack spans processes (forward hops, peer pulls) and threads
(offload pools, batcher workers), so "why was this derive slow?" cannot be
answered from any single counter.  This module gives every request a trace
ID carried in the ``X-Repro-Trace-Id`` header: the ingress node generates
(or adopts) one, every outgoing hop re-sends it, and each node records the
spans *it* executed into a bounded ring buffer served by ``GET
/v1/trace/<id>``.  A cross-node trace is therefore assembled client-side by
asking each node for its shard of the same ID — no collector process, no
wire format beyond the JSON the servers already speak.

Span records are flat JSON dicts::

    {"name": "store_peer", "start_unix": ..., "duration_ms": ..., **attrs}

Propagation uses two mechanisms, matched to the two concurrency shapes in
the stack:

* **contextvars** for request-scoped call stacks: the HTTP frontends
  activate ``(buffer, trace_id)`` at ingress and everything that runs on
  that logical flow — including asyncio-offloaded work wrapped with
  ``contextvars.copy_context().run`` — records via :func:`span`.
* **the backend ``meta`` dict** for shared worker threads: a batcher's
  drain loop serves many requests from one thread, so contextvars cannot
  attribute its work.  :func:`meta_context` snapshots the active trace into
  ``meta[META_KEY]`` (in-process only — the tuple is never serialized) and
  the worker calls :func:`record_for_meta` against it.

Everything here is a no-op (one contextvar read) when no trace is active,
which is what keeps the hot path's instrumentation overhead in the noise.

Ranges on the model path
------------------------

:func:`region` names a layer of the model path (``step``, ``mixer``,
``ffn``, ``head``, ``loss``) for ``torch.profiler``: while a profiler is
recording, it opens ``record_function("repro_torch.<name>")``, a range in the
same trace as the kernels it launches and on the same clock; otherwise it is
the shared no-op.  The gate is torch's own flag,
``torch.autograd.profiler._is_profiler_enabled``, read through the module at
every call: a range entered and left costs about 13 µs on a CPU with or
without a profiler, the flag's read under 0.1 µs, and a scoring request
passes some 70 ranges.  There is no setting: the ranges follow the profiler.
They record nothing into a request's :class:`TraceBuffer`, whose span budget
is a request's, not a model's.  A layer recomputed in the backward (remat)
opens its ranges again there, inside the autograd node that asked for it.
"""
from __future__ import annotations

import collections
import contextvars
import threading
import time
import uuid
from typing import Any

#: wire header carrying the trace ID across forward hops and peer pulls
TRACE_HEADER = "X-Repro-Trace-Id"

#: reserved key under which `meta_context()` snapshots the active trace into
#: a backend `meta` dict (in-process hand-off to shared worker threads; the
#: value is a live (TraceBuffer, trace_id) tuple and must never hit the wire)
META_KEY = "_trace"

#: per-flow active trace: (TraceBuffer, trace_id) or None
_current: contextvars.ContextVar[tuple["TraceBuffer", str] | None] = \
    contextvars.ContextVar("repro_trace", default=None)


def new_trace_id() -> str:
    """A fresh 32-hex-char trace ID."""
    return uuid.uuid4().hex


def valid_trace_id(trace_id: Any) -> bool:
    """Lenient wire validation: 8..64 hex chars.  Anything else is ignored
    at ingress (a fresh ID is generated instead), so a hostile header can
    never grow the ring buffer's key space unboundedly per request."""
    if not isinstance(trace_id, str) or not 8 <= len(trace_id) <= 64:
        return False
    return all(c in "0123456789abcdef" for c in trace_id)


class TraceBuffer:
    """Bounded ring of recent traces (per node).

    At most ``max_traces`` trace IDs are held; recording into a new ID when
    full evicts the oldest trace wholesale.  Each trace holds at most
    ``max_spans`` spans — further records bump ``dropped_spans`` instead of
    growing, so a pathological request can't eat the buffer either."""

    def __init__(self, max_traces: int = 512, max_spans: int = 64):
        self.max_traces = max_traces
        self.max_spans = max_spans
        self.dropped_traces = 0  # whole traces evicted by the ring
        self.dropped_spans = 0   # spans refused by a full trace
        self._traces: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        self._mu = threading.Lock()

    def record(self, trace_id: str, span: dict) -> None:
        with self._mu:
            entry = self._traces.get(trace_id)
            if entry is None:
                entry = self._traces[trace_id] = {
                    "trace_id": trace_id,
                    "started_unix": span.get("start_unix", time.time()),
                    "spans": [],
                    "dropped_spans": 0,
                }
                while len(self._traces) > self.max_traces:
                    self._traces.popitem(last=False)
                    self.dropped_traces += 1
            if len(entry["spans"]) >= self.max_spans:
                entry["dropped_spans"] += 1
                self.dropped_spans += 1
                return
            entry["spans"].append(span)

    def get(self, trace_id: str) -> dict | None:
        """This node's shard of one trace (a JSON-ready copy), or None."""
        with self._mu:
            entry = self._traces.get(trace_id)
            if entry is None:
                return None
            return {**entry, "spans": list(entry["spans"]),
                    "span_count": len(entry["spans"])}

    def ids(self) -> list[str]:
        """Known trace IDs, most recent last."""
        with self._mu:
            return list(self._traces)

    def stats(self) -> dict:
        with self._mu:
            return {"traces": len(self._traces),
                    "max_traces": self.max_traces,
                    "max_spans": self.max_spans,
                    "dropped_traces": self.dropped_traces,
                    "dropped_spans": self.dropped_spans}


# ---------------------------------------------------------------------------
# Context propagation + span recording
# ---------------------------------------------------------------------------


def activate(buffer: TraceBuffer, trace_id: str) -> contextvars.Token:
    """Make ``trace_id`` the active trace on this logical flow."""
    return _current.set((buffer, trace_id))


def deactivate(token: contextvars.Token) -> None:
    _current.reset(token)


def current_trace_id() -> str | None:
    """The active trace ID (what outgoing hops put on the wire), or None."""
    ctx = _current.get()
    return ctx[1] if ctx is not None else None


def wire_headers() -> dict:
    """``{TRACE_HEADER: id}`` when a trace is active, else ``{}`` — merge
    into any outgoing fleet request so the remote node records under the
    same ID."""
    ctx = _current.get()
    return {TRACE_HEADER: ctx[1]} if ctx is not None else {}


class _NoopSpan:
    __slots__ = ()

    def __enter__(self) -> dict:
        return {}

    def __exit__(self, *exc) -> bool:
        return False


_NOOP = _NoopSpan()


class _LiveSpan:
    __slots__ = ("_buffer", "_trace_id", "_name", "_attrs", "_t0", "_wall")

    def __init__(self, buffer: TraceBuffer, trace_id: str, name: str,
                 attrs: dict):
        self._buffer = buffer
        self._trace_id = trace_id
        self._name = name
        self._attrs = attrs

    def __enter__(self) -> dict:
        self._t0 = time.monotonic()
        self._wall = time.time()
        return self._attrs  # caller may add attrs mid-span

    def __exit__(self, exc_type, exc, tb) -> bool:
        rec = {"name": self._name, "start_unix": self._wall,
               "duration_ms": (time.monotonic() - self._t0) * 1e3}
        if exc_type is not None:
            rec["error"] = exc_type.__name__
        rec.update(self._attrs)
        self._buffer.record(self._trace_id, rec)
        return False


def span(name: str, **attrs):
    """Context manager recording one span into the active trace (a shared
    no-op when none is active).  Yields the attrs dict, so callers can
    attach outcomes discovered mid-span::

        with span("store_peer") as s:
            rec = probe()
            s["hit"] = rec is not None
    """
    ctx = _current.get()
    if ctx is None:
        return _NOOP
    return _LiveSpan(ctx[0], ctx[1], name, attrs)


#: prefix of every model-path range's name in a profiler trace
REGION_PREFIX = "repro_torch."

#: ``torch.autograd.profiler``, imported at the first :func:`region` call so
#: that this module stays importable without torch
_profiler = None


def region(name: str):
    """Context manager: ``record_function(REGION_PREFIX + name)`` while a
    torch profiler is recording, the shared no-op otherwise."""
    global _profiler
    if _profiler is None:
        import torch.autograd.profiler as _profiler
    if not _profiler._is_profiler_enabled:
        return _NOOP
    return _profiler.record_function(REGION_PREFIX + name)


def meta_context() -> dict:
    """Snapshot of the active trace for a backend ``meta`` dict (``{}``
    when inactive) — lets shared worker threads attribute their work via
    :func:`record_for_meta`."""
    ctx = _current.get()
    return {META_KEY: ctx} if ctx is not None else {}


def record_for_meta(meta: dict, name: str, seconds: float, **attrs) -> None:
    """Record a just-finished span of ``seconds`` against the trace carried
    in ``meta`` (no-op when the request was untraced)."""
    ctx = meta.get(META_KEY)
    if ctx is None:
        return
    buffer, trace_id = ctx
    buffer.record(trace_id, {
        "name": name, "start_unix": time.time() - seconds,
        "duration_ms": seconds * 1e3, **attrs})
