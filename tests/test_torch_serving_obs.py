"""The port's observability plane on its frontends, under the serving
cases of ``tests/test_observability.py``: metrics parity between the
threaded and asyncio frontends, ``/healthz``, Prometheus exposition,
request tracing on one node and across a 3-node ring (one trace ID over a
forward hop and the peer pull it triggers).

The 3-node case is made deterministic here: its nodes route with
``RequestRouter(policy="static", epsilon=0)``, so the forward hop always
takes the ring's first replica peer — the owner whose copy the test
evicts.  (The JAX package's copy ranks owners by measured latency with
exploration, and may forward to the other owner.)  The registry units live
in ``tests/test_torch_obs.py``; the loadgen cases wait for ``benchmarks/``,
which is not ported."""
from __future__ import annotations

import json
import time
import urllib.error
import urllib.request

import pytest

from repro_torch.core.backends import MockLLMBackend
from repro_torch.core.store import build_store
from repro_torch.obs.metrics import parse_prometheus
from repro_torch.obs.trace import TRACE_HEADER, new_trace_id, valid_trace_id
from repro_torch.serving import (
    AsyncMappingHTTPServer,
    MappingHTTPServer,
    MappingService,
    RemoteMappingService,
    RequestRouter,
)
from repro_torch.serving.cluster import ClusterMembership

MODEL = "OSS:120b"


def make_service(tmp_path, name="svc"):
    return MappingService(store=build_store(root=tmp_path / name),
                          backend_factory=MockLLMBackend,
                          n_validate=2000, sample_every=1)


def post_json(url: str, body: dict, headers: dict | None = None):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, dict(resp.headers), json.loads(resp.read())


def get_json(url: str, headers: dict | None = None):
    req = urllib.request.Request(url, headers=headers or {})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, dict(resp.headers), resp.read()


def wait_for_span(url: str, trace_id: str, name: str,
                  timeout: float = 5.0) -> dict:
    """Poll one node for a span — the ingress span lands an instant after
    the response bytes, so reads must tolerate that gap."""
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        try:
            _, _, raw = get_json(f"{url}/v1/trace/{trace_id}")
            last = json.loads(raw)
            for sp in last["spans"]:
                if sp["name"] == name:
                    return last
        except urllib.error.HTTPError:
            pass
        time.sleep(0.02)
    raise AssertionError(
        f"span {name!r} never appeared in trace {trace_id} on {url}: {last}")


# ---------------------------------------------------------------------------
# Frontend surface: parity, healthz, Prometheus, single-node traces
# ---------------------------------------------------------------------------


def _exercise(url: str):
    post_json(f"{url}/v1/derive",
              {"domain": "tri2d", "model": MODEL, "stage": 100})
    get_json(f"{url}/healthz")
    get_json(f"{url}/metrics")


def test_metrics_parity_between_frontends(tmp_path):
    with MappingHTTPServer(make_service(tmp_path, "t")) as threaded, \
            AsyncMappingHTTPServer(make_service(tmp_path, "a")) as aio:
        for server in (threaded, aio):
            _exercise(server.url)
        # endpoint stats land in a finally after response bytes: poll until
        # both frontends have recorded all three exercised endpoints
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            mt = threaded.metrics()
            ma = aio.metrics()
            if set(ma["http"]) == set(mt["http"]) == {
                    "derive", "healthz", "metrics"}:
                break
            time.sleep(0.02)
    # identical top-level key set, modulo the async-only "aio" alias
    assert set(ma) - {"aio"} == set(mt)
    # the shared frontend section carries the same keys too
    assert set(ma["frontend"]) - {"aio"} == set(mt["frontend"])
    assert mt["frontend"]["mode"] == "threaded"
    assert ma["frontend"]["mode"] == "async"
    # and the http sections saw the same endpoints with the same shape
    assert set(ma["http"]) == set(mt["http"])
    for section in (mt, ma):
        d = section["http"]["derive"]
        assert d["requests"] >= 1 and d["p50_ms"] > 0.0


@pytest.mark.parametrize("cls", [MappingHTTPServer, AsyncMappingHTTPServer])
def test_healthz_reports_uptime_and_mode(tmp_path, cls):
    with cls(make_service(tmp_path)) as server:
        _, _, raw = get_json(f"{server.url}/healthz")
        hz = json.loads(raw)
    assert hz["status"] == "ok"
    assert hz["mode"] in ("threaded", "async")
    assert hz["uptime_seconds"] > 0.0
    assert hz["started_unix"] <= time.time()
    assert hz["backend_names"] == []


@pytest.mark.parametrize("cls", [MappingHTTPServer, AsyncMappingHTTPServer])
def test_prometheus_endpoint_is_valid_exposition(tmp_path, cls):
    with cls(make_service(tmp_path)) as server:
        _exercise(server.url)
        _, headers, raw = get_json(
            f"{server.url}/metrics?format=prometheus")
    assert headers["Content-Type"].startswith("text/plain")
    series = parse_prometheus(raw.decode())
    assert any(k.startswith('repro_http_request_seconds_bucket{')
               for k in series)
    assert any(k.startswith("repro_service_") for k in series)
    # JSON /metrics numeric leaves are all scrapeable
    assert "repro_store_hits" in series


@pytest.mark.parametrize("cls", [MappingHTTPServer, AsyncMappingHTTPServer])
def test_trace_roundtrip_single_node(tmp_path, cls):
    tid = "cd" * 16
    with cls(make_service(tmp_path)) as server:
        status, headers, _ = post_json(
            f"{server.url}/v1/derive",
            {"domain": "tri2d", "model": MODEL, "stage": 100},
            headers={TRACE_HEADER: tid})
        assert status == 200
        # the trace ID echoes on the response
        assert headers[TRACE_HEADER] == tid
        trace = wait_for_span(server.url, tid, "derive")
        names = [sp["name"] for sp in trace["spans"]]
        # cold derive: local tier probes + inference + validation happened
        # under this request's trace
        assert "store_memory" in names
        assert "inference" in names
        assert "validation" in names
        assert trace["trace_id"] == tid
        assert trace["node"] == server.url
        # a hot repeat records a fresh (server-minted) trace too
        status, headers, _ = post_json(
            f"{server.url}/v1/derive",
            {"domain": "tri2d", "model": MODEL, "stage": 100})
        minted = headers[TRACE_HEADER]
        assert valid_trace_id(minted) and minted != tid
        _, _, raw = get_json(f"{server.url}/v1/traces")
        listing = json.loads(raw)
        assert tid in listing["traces"]
        assert listing["stats"]["max_traces"] > 0


def test_malformed_trace_header_gets_fresh_id(tmp_path):
    with MappingHTTPServer(make_service(tmp_path)) as server:
        _, headers, _ = post_json(
            f"{server.url}/v1/derive",
            {"domain": "tri2d", "model": MODEL, "stage": 100},
            headers={TRACE_HEADER: "NOT-HEX-AT-ALL!"})
        echoed = headers[TRACE_HEADER]
        assert valid_trace_id(echoed)
        assert echoed != "NOT-HEX-AT-ALL!"


@pytest.mark.parametrize("cls", [MappingHTTPServer, AsyncMappingHTTPServer])
def test_tracing_disabled_serves_without_traces(tmp_path, cls):
    tid = "ef" * 16
    with cls(make_service(tmp_path), observability=False) as server:
        status, headers, _ = post_json(
            f"{server.url}/v1/derive",
            {"domain": "tri2d", "model": MODEL, "stage": 100},
            headers={TRACE_HEADER: tid})
        assert status == 200
        assert TRACE_HEADER not in headers
        with pytest.raises(urllib.error.HTTPError):
            get_json(f"{server.url}/v1/trace/{tid}")
        # metrics keep flowing
        m = server.metrics()
        assert m["http"]["derive"]["requests"] == 1
        assert m["frontend"]["observability"] is False


def test_trace_unknown_id_is_404(tmp_path):
    with MappingHTTPServer(make_service(tmp_path)) as server:
        with pytest.raises(urllib.error.HTTPError) as exc:
            get_json(f"{server.url}/v1/trace/{'aa' * 16}")
        assert exc.value.code == 404


# ---------------------------------------------------------------------------
# Acceptance: one trace ID across a 3-node ring (forward hop + peer pull)
# ---------------------------------------------------------------------------


def boot_node(tmp_path, name: str, seeds, async_frontend: bool = False):
    svc = make_service(tmp_path, name)
    # ring order, no exploration: the forward hop's owner is known
    router = RequestRouter(policy="static", epsilon=0.0)
    server = (AsyncMappingHTTPServer(svc, router=router).start()
              if async_frontend
              else MappingHTTPServer(svc, router=router).start())
    cluster = ClusterMembership(
        server.url, seeds=seeds or (), replicas=2, vnodes=64,
        heartbeat_interval=0.15, down_after=1.0, sync_interval=0.3,
        probe_timeout=1.0)
    server.attach_cluster(cluster)
    return server


def wait_fleet(servers, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(len(s.cluster.live_peers()) == len(servers) - 1
               for s in servers):
            return
        time.sleep(0.05)
    raise AssertionError("fleet never converged")


def test_one_trace_spans_forward_and_peer_pull(tmp_path):
    """The acceptance scenario: a single client-injected trace ID
    covers the forwarded derive AND the peer pull it triggers —
    ingress node records the forward hop, the owner records admission +
    store probes + store_peer, and the pulled-from sibling records its
    replicate_pull, all retrievable per node from GET /v1/trace/<id>."""
    servers = []
    try:
        n0 = boot_node(tmp_path, "n0", seeds=None)
        servers.append(n0)
        for name in ("n1", "n2"):
            servers.append(boot_node(tmp_path, name, seeds=[n0.url]))
        wait_fleet(servers)

        # derive once so the cell exists on its 2 owners; learn the key
        res = RemoteMappingService(servers[0].url).derive(
            "gasket2d", MODEL, 100)
        key = res.cache_key
        deadline = time.monotonic() + 5.0
        owners = []
        while time.monotonic() < deadline:
            owners = [s for s in servers if key in s.service.store]
            if len(owners) == 2:
                break
            time.sleep(0.05)
        assert len(owners) == 2, f"expected 2 replicas, got {len(owners)}"
        non_owner = next(s for s in servers if s not in owners)
        # the forwarder hops to its first replica peer (static routing) —
        # evict exactly that node's copy so the forwarded derive must
        # peer-pull
        by_url = {s.url: s for s in servers}
        primary = by_url[non_owner.cluster.replica_peers(key)[0]]
        assert primary in owners
        sibling = next(s for s in owners if s is not primary)

        req = urllib.request.Request(
            f"{primary.url}/v1/artifact/{key}", method="DELETE")
        with urllib.request.urlopen(req, timeout=10):
            pass
        assert key not in primary.service.store

        # ONE trace ID through the whole story: non-owner forwards to the
        # primary owner, which misses locally and pulls from its sibling
        tid = new_trace_id()
        status, headers, payload = post_json(
            f"{non_owner.url}/v1/derive",
            {"domain": "gasket2d", "model": MODEL, "stage": 100},
            headers={TRACE_HEADER: tid})
        assert status == 200
        assert headers[TRACE_HEADER] == tid
        assert payload["key"] == key

        # ingress node: request-level span + the forward hop it took
        ingress = wait_for_span(non_owner.url, tid, "derive")
        fwd = next(sp for sp in ingress["spans"] if sp["name"] == "forward")
        assert fwd["owner"] == primary.url

        # owner: admission (derive), local tier probes, then the peer pull
        owner_trace = wait_for_span(primary.url, tid, "derive")
        names = [sp["name"] for sp in owner_trace["spans"]]
        assert "store_memory" in names and "store_disk" in names
        pull = next(sp for sp in owner_trace["spans"]
                    if sp["name"] == "store_peer")
        assert pull["hit"] is True
        assert pull["peer"] == sibling.url

        # pulled-from sibling: its replicate_pull ran under the same ID
        sib = wait_for_span(sibling.url, tid, "replicate_pull")
        assert sib["trace_id"] == tid

        # and the client-side fetchers see the same shards
        client = RemoteMappingService(non_owner.url)
        assert client.trace(tid)["trace_id"] == tid
        assert tid in client.traces(base=primary.url)["traces"]
    finally:
        for s in servers:
            s.close()
