"""The port's observability plane (``repro_torch.obs``) held against the
JAX package's: the same metric operations give the same Prometheus text,
JSON sections and parsed series; the trace buffer keeps and drops the same
spans; and the port's pipeline records the spans the reference's records
(inference and validation on a derivation, the store tiers on a load)."""
import math

import pytest

from repro import obs as robs
from repro.core import pipeline as rp
from repro.core.backends import MockLLMBackend as RMock
from repro.core.domains import DOMAINS as RDOMAINS
from repro.core.store import build_store as ref_build_store
from repro.obs import trace as rtrace
from repro_torch import obs as tobs
from repro_torch.core import pipeline as tp
from repro_torch.core.backends import MockLLMBackend as TMock
from repro_torch.core.domains import DOMAINS as TDOMAINS
from repro_torch.core.store import build_store
from repro_torch.obs import trace as ttrace

PAYLOAD = {"store": {"hits": 5, "nested": {"rate": 0.5, "name": "x"}},
           "service": {"derivations": 3, "ok": True, "none": None},
           "list": [1, 2]}


def _drive(obs_pkg):
    """The same metric operations on one package's registry."""
    reg = obs_pkg.MetricsRegistry()
    reg.counter("repro_requests_total", "requests", endpoint="/v1/derive") \
        .inc()
    reg.counter("repro_requests_total", "requests", endpoint="/v1/derive") \
        .inc(2.5)
    reg.counter("repro_requests_total", "requests",
                endpoint='we"ird\\label\n').inc()
    g = reg.gauge("repro_inflight", "in flight")
    g.set(7)
    g.dec(2)
    g.inc(0.25)
    h = reg.histogram("repro_http_request_seconds", "latency",
                      endpoint="/v1/evaluate")
    for v in (1e-5, 3e-4, 0.002, 0.002, 0.04, 0.9, 3.0, 120.0):
        h.observe(v)
    quantiles = [h.quantile(q) for q in (0.0, 0.5, 0.9, 0.99, 1.0)]
    stats = obs_pkg.EndpointStats(reg.histogram(
        "repro_http_request_seconds", "latency", endpoint="/v1/derive"))
    for v, ok in ((0.01, True), (0.2, False), (0.003, True)):
        stats.record(v, ok)
    return reg, quantiles, stats.as_dict()


def test_prometheus_text_equal_reference():
    mine, mine_q, mine_stats = _drive(tobs)
    ref, ref_q, ref_stats = _drive(robs)
    text = mine.prometheus(PAYLOAD)
    assert text == ref.prometheus(PAYLOAD)
    assert mine.prometheus() == ref.prometheus()
    assert mine_q == ref_q and mine_stats == ref_stats
    assert tobs.parse_prometheus(text) == robs.parse_prometheus(text)
    assert tobs.flatten_payload(PAYLOAD) == robs.flatten_payload(PAYLOAD)
    assert tobs.DEFAULT_BUCKETS == robs.DEFAULT_BUCKETS
    for bad in ("repro_ok 1\njustonetoken", "repro_bad notanumber"):
        with pytest.raises(ValueError):
            tobs.parse_prometheus(bad)
        with pytest.raises(ValueError):
            robs.parse_prometheus(bad)


def test_observability_sections_equal_reference():
    mine = tobs.Observability(mode="async", node="http://n:1",
                              max_traces=4, max_spans=3)
    ref = robs.Observability(mode="async", node="http://n:1",
                             max_traces=4, max_spans=3)
    for o, mod in ((mine, tobs), (ref, robs)):
        o.observe("/v1/derive", 0.01, True)
        o.observe("/v1/derive", 0.5, False)
        o.observe("/v1/evaluate", 0.002, True)
        tok = o.begin_request("ab" * 16)
        with mod.span("store_memory", hit=True):
            pass
        o.end_request(tok, "/v1/derive", 0.01, True)
    assert mine.http_dict() == ref.http_dict()
    assert set(mine.frontend_dict()) == set(ref.frontend_dict())
    assert mine.traces_payload() == ref.traces_payload()
    a, b = mine.trace_payload("ab" * 16), ref.trace_payload("ab" * 16)
    assert [s["name"] for s in a["spans"]] == [s["name"] for s in b["spans"]]
    assert mine.prometheus({"x": 1}) == ref.prometheus({"x": 1})
    assert tobs.Observability(enabled=False).begin_request(None) is None


def test_trace_buffer_bounds_equal_reference():
    bufs = (ttrace.TraceBuffer(max_traces=2, max_spans=2),
            rtrace.TraceBuffer(max_traces=2, max_spans=2))
    for buf in bufs:
        for tid in ("a" * 8, "b" * 8, "a" * 8, "c" * 8):
            for k in range(3):
                buf.record(tid, {"name": f"s{k}", "start_unix": 1.0,
                                 "duration_ms": 0.5})
    assert bufs[0].stats() == bufs[1].stats()
    assert bufs[0].ids() == bufs[1].ids()
    for tid in bufs[1].ids():
        assert bufs[0].get(tid) == bufs[1].get(tid)
    for tid in ("ab" * 16, "x" * 16, "a" * 7, "a" * 65, "AB" * 8, None, 7):
        assert ttrace.valid_trace_id(tid) == rtrace.valid_trace_id(tid)
    assert ttrace.TRACE_HEADER == rtrace.TRACE_HEADER
    assert ttrace.META_KEY == rtrace.META_KEY


def test_trace_context_helpers():
    buf = ttrace.TraceBuffer()
    assert ttrace.current_trace_id() is None and ttrace.wire_headers() == {}
    assert ttrace.meta_context() == {}
    token = ttrace.activate(buf, "cd" * 16)
    try:
        assert ttrace.current_trace_id() == "cd" * 16
        assert ttrace.wire_headers() == {ttrace.TRACE_HEADER: "cd" * 16}
        meta = ttrace.meta_context()
        ttrace.record_for_meta(meta, "batch_wait", 0.25, size=3)
        with pytest.raises(RuntimeError):
            with ttrace.span("fails"):
                raise RuntimeError("x")
    finally:
        ttrace.deactivate(token)
    spans = buf.get("cd" * 16)["spans"]
    assert [s["name"] for s in spans] == ["batch_wait", "fails"]
    assert spans[0]["size"] == 3 and math.isclose(spans[0]["duration_ms"],
                                                  250.0)
    assert spans[1]["error"] == "RuntimeError"
    # no active trace: a shared no-op, nothing recorded
    with ttrace.span("ignored") as attrs:
        attrs["x"] = 1
    assert buf.stats()["traces"] == 1


def _traced(trace_mod, fn):
    buf = trace_mod.TraceBuffer(max_spans=1000)
    token = trace_mod.activate(buf, "ef" * 16)
    try:
        fn()
    finally:
        trace_mod.deactivate(token)
    return buf.get("ef" * 16)["spans"]


def _names(spans):
    return [s["name"] for s in spans]


def test_derive_mapping_records_inference_and_validation_spans(tmp_path):
    def derive(pipeline, mock, domains, store):
        return lambda: [pipeline.derive_mapping(
            domains[d], mock("OSS:120b"), 20, n_validate=2000, cache=store)
            for d in ("tri2d", "menger3d", "tri2d")]

    mine = _traced(ttrace, derive(tp, TMock, TDOMAINS,
                                  build_store(tmp_path / "port")))
    ref = _traced(rtrace, derive(rp, RMock, RDOMAINS,
                                 ref_build_store(tmp_path / "ref")))
    assert _names(mine) == _names(ref)
    # two misses derive (each: the memory and disk probes, inference,
    # validation); the repeat is a memory hit with no inference
    assert _names(mine) == ["store_memory", "store_disk", "inference",
                            "validation"] * 2 + ["store_memory"]
    for a, b in zip(mine, ref):
        assert set(a) == set(b)
        for k in a:
            if k not in ("start_unix", "duration_ms"):
                assert a[k] == b[k], (a["name"], k)
    infer = [s for s in mine if s["name"] == "inference"]
    assert infer[0]["model"] == "OSS:120b"
    valid = [s for s in mine if s["name"] == "validation"]
    assert valid[0]["n_points"] == 2000


def test_uncached_derivation_records_spans_without_store():
    spans = _traced(ttrace, lambda: tp.derive_mapping(
        TDOMAINS["gasket2d"], TMock("Qw3:235b"), 20, n_validate=1000,
        cache=None))
    # the Qw3:235b stage-20 gasket2d cell does not compile: inference only
    assert _names(spans) == ["inference"]
