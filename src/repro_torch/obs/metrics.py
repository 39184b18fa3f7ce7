"""Metrics registry: named counters, gauges, fixed-bucket histograms.

Replaces the ad-hoc dict/list counters the serving layer grew through PRs
3-7 with proper instruments:

* :class:`Counter` / :class:`Gauge` — named, labeled, thread-safe;
* :class:`Histogram` — **fixed-bucket** latency distribution.  Memory is
  bounded by construction (one int per bucket, forever), unlike the
  deque-of-samples the frontends used before; quantiles are estimated by
  linear interpolation inside the covering bucket, with the observed max
  bounding the overflow bucket;
* :class:`MetricsRegistry` — get-or-create by (name, labels), rendered as
  Prometheus text exposition (format 0.0.4: ``# HELP``/``# TYPE``,
  ``_bucket{le=...}``/``_sum``/``_count`` series).

The existing JSON ``/metrics`` payload stays the source of truth for its
nested shape (tests and the benchmark harness consume it); the Prometheus
view is generated from the same numbers — registered instruments first,
then every numeric leaf of the JSON payload flattened into
``repro_<path>`` gauges, so a scraper sees the whole surface without the
JSON consumers noticing anything changed.
"""
from __future__ import annotations

import math
import re
import threading
from typing import Any, Iterable

#: default latency buckets (seconds): 0.5ms hot-path hits .. 10s derivations
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")
_SANITIZE = re.compile(r"[^a-zA-Z0-9_]")


def sanitize_name(raw: str) -> str:
    """A valid Prometheus metric-name fragment from an arbitrary key."""
    name = _SANITIZE.sub("_", str(raw))
    if not name or name[0].isdigit():
        name = "_" + name
    return name


def escape_label_value(value: Any) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{sanitize_name(k)}="{escape_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(value: float) -> str:
    if value != value:  # NaN
        return "NaN"
    if value in (math.inf, -math.inf):
        return "+Inf" if value > 0 else "-Inf"
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, int) or float(value).is_integer():
        return str(int(value))
    return repr(float(value))


class Counter:
    """Monotonically increasing named counter."""

    kind = "counter"

    def __init__(self, name: str, help: str = "", labels: dict | None = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._value = 0.0
        self._mu = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._mu:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def samples(self) -> Iterable[tuple[str, dict, float]]:
        yield self.name, self.labels, self._value


class Gauge:
    """Point-in-time value (may go up or down)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "", labels: dict | None = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._value = 0.0
        self._mu = threading.Lock()

    def set(self, value: float) -> None:
        with self._mu:
            self._value = value

    def inc(self, amount: float = 1.0) -> None:
        with self._mu:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value

    def samples(self) -> Iterable[tuple[str, dict, float]]:
        yield self.name, self.labels, self._value


class Histogram:
    """Fixed-bucket distribution (cumulative counts, Prometheus-style).

    ``observe`` is O(len(buckets)) with zero allocation; storage is one int
    per bucket regardless of how many samples a long-lived server sees —
    this is what bounds the frontends' per-endpoint latency memory.
    ``quantile`` interpolates linearly inside the covering bucket; the
    open-ended overflow bucket is capped at the observed maximum so a p99
    estimate can never exceed reality."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", labels: dict | None = None,
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # +1: overflow (+Inf)
        self._sum = 0.0
        self._count = 0
        self._max = 0.0
        self._mu = threading.Lock()

    def observe(self, value: float) -> None:
        with self._mu:
            self._sum += value
            self._count += 1
            if value > self._max:
                self._max = value
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> float:
        """Estimated q-quantile in the observed unit (0.0 when empty)."""
        with self._mu:
            total = self._count
            if total == 0:
                return 0.0
            target = q * total
            if target < 1.0:
                target = 1.0
            cumulative = 0
            lo = 0.0
            for i, bound in enumerate(self.buckets):
                in_bucket = self._counts[i]
                if cumulative + in_bucket >= target:
                    frac = (target - cumulative) / in_bucket
                    hi = min(bound, self._max) if self._max > lo else bound
                    return lo + (hi - lo) * frac
                cumulative += in_bucket
                lo = bound
            # overflow bucket: interpolate toward the observed max
            in_bucket = self._counts[-1]
            if in_bucket == 0:
                return lo
            frac = min(1.0, (target - cumulative) / in_bucket)
            return lo + (max(self._max, lo) - lo) * frac

    def samples(self) -> Iterable[tuple[str, dict, float]]:
        with self._mu:
            counts = list(self._counts)
            total, acc = self._count, self._sum
        cumulative = 0
        for bound, n in zip(self.buckets, counts):
            cumulative += n
            yield (self.name + "_bucket",
                   {**self.labels, "le": _fmt_value(bound)}, cumulative)
        yield self.name + "_bucket", {**self.labels, "le": "+Inf"}, total
        yield self.name + "_sum", self.labels, acc
        yield self.name + "_count", self.labels, total


class EndpointStats:
    """Per-endpoint request counters over a bounded histogram.

    Publishes the exact JSON dict shape the frontends have always served
    (``{requests, errors, p50_ms, p95_ms}``) so every existing /metrics
    consumer keeps working — but backed by fixed buckets instead of an
    unbounded (well, deque-bounded) latency sample."""

    def __init__(self, histogram: Histogram):
        self.histogram = histogram
        self.errors = 0
        self._mu = threading.Lock()

    def record(self, seconds: float, ok: bool) -> None:
        self.histogram.observe(seconds)
        if not ok:
            with self._mu:
                self.errors += 1

    def as_dict(self) -> dict:
        return {
            "requests": self.histogram.count,
            "errors": self.errors,
            "p50_ms": self.histogram.quantile(0.50) * 1e3,
            "p95_ms": self.histogram.quantile(0.95) * 1e3,
            "p99_ms": self.histogram.quantile(0.99) * 1e3,
        }


class MetricsRegistry:
    """Get-or-create instrument registry keyed by (name, sorted labels)."""

    def __init__(self):
        self._instruments: dict[tuple, Any] = {}
        self._mu = threading.Lock()

    def _get(self, cls, name: str, help: str, labels: dict, **kw):
        if not _NAME_OK.fullmatch(name):
            raise ValueError(f"invalid metric name {name!r}")
        key = (name, tuple(sorted(labels.items())))
        with self._mu:
            inst = self._instruments.get(key)
            if inst is None:
                inst = self._instruments[key] = cls(
                    name, help=help, labels=labels, **kw)
            elif not isinstance(inst, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {inst.kind}")
            return inst

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple[float, ...] = DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def instruments(self) -> list:
        with self._mu:
            return list(self._instruments.values())

    def prometheus(self, payload: dict | None = None,
                   payload_prefix: str = "repro") -> str:
        """Text exposition (format 0.0.4) of every registered instrument,
        plus — when given — each numeric leaf of a nested JSON ``payload``
        flattened to ``<payload_prefix>_<path>`` gauges."""
        lines: list[str] = []
        seen_meta: set[str] = set()
        for inst in self.instruments():
            if inst.name not in seen_meta:
                seen_meta.add(inst.name)
                if inst.help:
                    lines.append(f"# HELP {inst.name} {inst.help}")
                lines.append(f"# TYPE {inst.name} {inst.kind}")
            for name, labels, value in inst.samples():
                lines.append(
                    f"{name}{_fmt_labels(labels)} {_fmt_value(value)}")
        if payload is not None:
            for name, value in flatten_payload(payload, payload_prefix):
                if name not in seen_meta:
                    seen_meta.add(name)
                    lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {_fmt_value(value)}")
        return "\n".join(lines) + "\n"


def flatten_payload(payload: dict, prefix: str = "repro",
                    ) -> list[tuple[str, float]]:
    """Every numeric leaf of a nested dict as (metric_name, value), path
    components joined by ``_`` and sanitized — how the JSON /metrics shape
    becomes scrapeable without maintaining two bookkeeping systems."""
    out: list[tuple[str, float]] = []

    def walk(node: Any, path: str) -> None:
        if isinstance(node, bool):
            out.append((path, 1.0 if node else 0.0))
        elif isinstance(node, (int, float)):
            out.append((path, float(node)))
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}_{sanitize_name(k)}")
        # lists/strings/None are skipped: not time-series material

    walk(payload, sanitize_name(prefix))
    return out


def parse_prometheus(text: str) -> dict[str, float]:
    """Minimal exposition parser (tests + loadgen): ``{name{labels}: value}``.
    Raises ValueError on a malformed line, which is exactly what the
    format-validity tests want to detect."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        series, _, raw = line.rpartition(" ")
        if not series:
            raise ValueError(f"malformed exposition line: {line!r}")
        name = series.split("{", 1)[0]
        if not _NAME_OK.fullmatch(name):
            raise ValueError(f"invalid series name in line: {line!r}")
        try:
            value = float(raw)
        except ValueError as e:
            raise ValueError(f"non-numeric sample in line: {line!r}") from e
        out[series] = value
    return out
