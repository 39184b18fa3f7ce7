"""Observability plane: metrics registry + request tracing (stdlib only).

One :class:`Observability` instance per server frontend bundles the three
measurement surfaces this package provides:

* per-endpoint request stats (bounded histogram buckets, not samples),
  feeding the JSON ``/metrics`` payload's ``http`` section unchanged;
* Prometheus text exposition of the same numbers
  (``GET /metrics?format=prometheus``);
* per-request traces (``X-Repro-Trace-Id``) in a bounded ring buffer,
  served by ``GET /v1/trace/<id>`` and ``GET /v1/traces``.

``enabled=False`` turns request *tracing* off (no ID generation, no
contextvar activation, no span records) while metrics keep flowing — the
knob behind ``--no-observability`` and the instrumentation-overhead
benchmark.
"""
from __future__ import annotations

import time

from repro_torch.obs.metrics import (  # noqa: F401
    DEFAULT_BUCKETS,
    Counter,
    EndpointStats,
    Gauge,
    Histogram,
    MetricsRegistry,
    flatten_payload,
    parse_prometheus,
)
from repro_torch.obs.trace import (  # noqa: F401
    META_KEY,
    TRACE_HEADER,
    TraceBuffer,
    current_trace_id,
    meta_context,
    new_trace_id,
    record_for_meta,
    span,
    valid_trace_id,
    wire_headers,
)
from repro_torch.obs import trace as trace_mod


class Observability:
    """One frontend's bundle of registry + endpoint stats + trace buffer."""

    def __init__(self, mode: str = "", node: str = "", enabled: bool = True,
                 max_traces: int = 512, max_spans: int = 64):
        self.mode = mode          # "threaded" | "async"
        self.node = node          # this server's URL (set post-bind)
        self.enabled = enabled    # tracing on/off; metrics always flow
        self.started_unix = time.time()
        self._t0 = time.monotonic()
        self.registry = MetricsRegistry()
        self.traces = TraceBuffer(max_traces=max_traces, max_spans=max_spans)
        self._endpoint_cache: dict[str, EndpointStats] = {}

    def uptime_seconds(self) -> float:
        return time.monotonic() - self._t0

    # -- per-endpoint stats ------------------------------------------------
    def endpoint(self, name: str) -> EndpointStats:
        stats = self._endpoint_cache.get(name)
        if stats is None:
            hist = self.registry.histogram(
                "repro_http_request_seconds",
                "per-endpoint request latency", endpoint=name)
            stats = self._endpoint_cache.setdefault(name,
                                                    EndpointStats(hist))
        return stats

    def observe(self, endpoint: str, seconds: float, ok: bool) -> None:
        self.endpoint(endpoint).record(seconds, ok)

    def http_dict(self) -> dict:
        """The /metrics ``http`` section (its JSON shape, unchanged)."""
        return {name: stats.as_dict()
                for name, stats in sorted(self._endpoint_cache.items())}

    def frontend_dict(self) -> dict:
        """The /metrics ``frontend`` section — identical key set on both
        frontends (the parity contract); mode distinguishes them."""
        return {
            "mode": self.mode,
            "node": self.node,
            "observability": self.enabled,
            "uptime_seconds": self.uptime_seconds(),
            "started_unix": self.started_unix,
            "traces": self.traces.stats(),
        }

    # -- request tracing ---------------------------------------------------
    def begin_request(self, header_value: str | None):
        """Activate a trace for one request: adopt a valid incoming ID or
        mint a fresh one.  Returns an opaque token for :meth:`end_request`
        (None when tracing is disabled)."""
        if not self.enabled:
            return None
        trace_id = header_value if valid_trace_id(header_value) \
            else new_trace_id()
        token = trace_mod.activate(self.traces, trace_id)
        return (token, trace_id)

    def end_request(self, token, endpoint: str, seconds: float,
                    ok: bool) -> None:
        """Record the request-level span and deactivate the trace."""
        if token is None:
            return
        cv_token, trace_id = token
        rec = {"name": endpoint, "start_unix": time.time() - seconds,
               "duration_ms": seconds * 1e3, "node": self.node}
        if not ok:
            rec["error"] = True
        self.traces.record(trace_id, rec)
        trace_mod.deactivate(cv_token)

    # -- wire payloads -----------------------------------------------------
    def trace_payload(self, trace_id: str) -> dict | None:
        entry = self.traces.get(trace_id)
        if entry is None:
            return None
        return {**entry, "node": self.node}

    def traces_payload(self) -> dict:
        ids = self.traces.ids()
        return {"node": self.node, "traces": ids, "count": len(ids),
                "stats": self.traces.stats()}

    def prometheus(self, payload: dict | None = None) -> str:
        return self.registry.prometheus(payload)
