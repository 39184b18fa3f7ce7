"""The port's networked mapping service end to end, as
``tests/test_http_service.py`` holds the JAX package's: HTTP frontend +
remote client + batching/admission — concurrent remote clients share one
server-side derivation and one store, the wire schema round-trips
byte-identically, and two servers with disjoint local stores replicate
derivations through the peer tier (one backend inference for the whole
fleet).  ``EngineBackend`` runs on the CPU here (``device="cpu"``); without
that it refuses, as ``test_engine_backend_refuses_naming_item_7`` holds."""
import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from repro_torch.core import pipeline, synthesis
from repro_torch.core.artifact import ArtifactCache
from repro_torch.core.backends import EngineBackend, LLMResponse, MockLLMBackend
from repro_torch.core.domains import DOMAINS
from repro_torch.core.store import PeerStore, build_store
from repro_torch.serving import (
    AdmissionError, BatchingBackend, MappingHTTPServer, MappingService,
    RemoteMappingService, RemoteServiceError, batching_factory,
)

MODEL = "OSS:120b"


class CountingBackend:
    """Thread-safe MockLLMBackend wrapper counting `generate` calls, with a
    small sleep so concurrent requests genuinely overlap."""

    def __init__(self, model: str, delay: float = 0.05):
        self._inner = MockLLMBackend(model)
        self.name = self._inner.name
        self.calls = 0
        self.delay = delay
        self._mu = threading.Lock()

    @property
    def cache_fingerprint(self):
        return self._inner.cache_fingerprint

    def generate(self, prompt, *, meta):
        with self._mu:
            self.calls += 1
        time.sleep(self.delay)
        return self._inner.generate(prompt, meta=meta)


def shared_factory():
    bank: dict[str, CountingBackend] = {}
    mu = threading.Lock()

    def factory(model: str) -> CountingBackend:
        with mu:
            if model not in bank:
                bank[model] = CountingBackend(model)
            return bank[model]

    factory.bank = bank
    return factory


def make_server(tmp_path, factory, **kw):
    kw.setdefault("n_validate", 2000)
    kw.setdefault("sample_every", 1)
    svc = MappingService(cache=ArtifactCache(tmp_path),
                         backend_factory=factory, **kw)
    return MappingHTTPServer(svc)


# ---------------------------------------------------------------------------
# Acceptance: two concurrent remote clients, one backend inference
# ---------------------------------------------------------------------------


def test_two_concurrent_clients_one_inference(tmp_path):
    """Two RemoteMappingService clients racing on one (domain, model, stage):
    exactly one backend inference, byte-identical artifact records for both,
    and /metrics reports the coalesced/cached resolution."""
    factory = shared_factory()
    with make_server(tmp_path, factory) as server:
        out = {}
        mu = threading.Lock()

        def client(tag):
            c = RemoteMappingService(server.url)
            res = c.derive("tri2d", MODEL, 20)
            with mu:
                out[tag] = res

        threads = [threading.Thread(target=client, args=(t,)) for t in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

        assert factory.bank[MODEL].calls == 1  # exactly one inference
        a, b = out["a"], out["b"]
        assert a.cache_key == b.cache_key
        assert a.artifact is not None and b.artifact is not None
        assert (json.dumps(a.artifact.to_record(), sort_keys=True) ==
                json.dumps(b.artifact.to_record(), sort_keys=True))

        metrics = RemoteMappingService(server.url).metrics()
        svc = metrics["service"]
        assert svc["requests"] == 2
        assert svc["derivations"] == 1
        assert svc["coalesced"] + svc["cache_hits"] == 1  # the reported hit
        assert svc["cache_hit_ratio"] == pytest.approx(0.5)
        assert metrics["http"]["derive"]["requests"] == 2
        assert metrics["http"]["derive"]["p95_ms"] > 0


def test_engine_backend_served_map_validates(tmp_path):
    """EngineBackend through POST /v1/derive on a smoke config: real
    prefill/decode runs server-side, and the returned map passes
    stage_validation."""
    def factory(model):
        return EngineBackend(model, max_new_tokens=4, device="cpu")

    with make_server(tmp_path, factory) as server:
        client = RemoteMappingService(server.url)
        res = client.derive("tri2d", MODEL, 20)
    assert res.compiled and res.source is not None
    assert res.response.tokens_out == 4  # genuine decode steps
    # re-validate the served source through the pipeline's own stage
    req = pipeline.prepare_request(
        DOMAINS["tri2d"], EngineBackend(MODEL, max_new_tokens=4), 20,
        n_validate=2000, sample_every=1)
    assert req.key == res.cache_key  # same content address client-side
    rep, cls = pipeline.stage_validation(
        req, synthesis.synthesize(res.source))
    assert rep.ordered == 1.0
    assert cls is not None


def test_engine_backend_refuses_naming_item_7(tmp_path, monkeypatch):
    """EngineBackend (ROADMAP queue 1 item 7, now ported) runs on the card
    unless asked for the CPU: on a machine without one, a server built
    around it answers a derive with an error naming ``device="cpu"``
    instead of falling back, while ``device="cpu"`` serves."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    backend = EngineBackend(MODEL, max_new_tokens=4)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        backend.generate("p", meta={"domain": "tri2d", "stage": 20})
    with make_server(tmp_path, lambda m: backend) as server:
        client = RemoteMappingService(server.url, retries=0)
        with pytest.raises(RemoteServiceError, match="device"):
            client.derive("tri2d", MODEL, 20)
    cpu = EngineBackend(MODEL, max_new_tokens=4, device="cpu")
    resp = cpu.generate("p", meta={"domain": "tri2d", "stage": 20})
    assert resp.tokens_out == 4 and resp.seconds > 0


# ---------------------------------------------------------------------------
# Batching / admission
# ---------------------------------------------------------------------------


class BatchRecorder:
    """Mock backend exposing generate_batch, recording group sizes."""

    def __init__(self, model: str, delay: float = 0.05):
        self._inner = MockLLMBackend(model)
        self.name = model
        self.batch_sizes = []
        self.delay = delay
        self._mu = threading.Lock()

    @property
    def cache_fingerprint(self):
        return self._inner.cache_fingerprint

    def generate(self, prompt, *, meta):
        return self.generate_batch([prompt], [meta])[0]

    def generate_batch(self, prompts, metas):
        with self._mu:
            self.batch_sizes.append(len(prompts))
        time.sleep(self.delay)
        return [self._inner.generate(p, meta=m)
                for p, m in zip(prompts, metas)]


def test_batching_groups_concurrent_same_model_derives(tmp_path):
    """Concurrent derive requests for *different* cells on one model are
    admitted as one batched backend call (coalescing handles same-cell)."""
    inner = {}

    def base_factory(model):
        return inner.setdefault(model, BatchRecorder(model))

    factory = batching_factory(base_factory, max_batch=8, max_wait=0.25)
    svc = MappingService(cache=ArtifactCache(tmp_path),
                         backend_factory=factory, n_validate=2000,
                         sample_every=1)
    with MappingHTTPServer(svc) as server:
        cells = [("tri2d", 20), ("tri2d", 50), ("gasket2d", 20),
                 ("gasket2d", 50), ("carpet2d", 20), ("msimplex3", 20)]
        results = {}
        mu = threading.Lock()

        def one(domain, stage):
            res = RemoteMappingService(server.url).derive(domain, MODEL, stage)
            with mu:
                results[(domain, stage)] = res

        threads = [threading.Thread(target=one, args=c) for c in cells]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    rec = inner[MODEL]
    assert sum(rec.batch_sizes) == len(cells)      # every request served
    assert len(rec.batch_sizes) < len(cells)       # ...in fewer backend calls
    assert max(rec.batch_sizes) > 1
    stats = factory.batchers[MODEL].stats
    assert stats.requests == len(cells)
    assert stats.max_batch_seen == max(rec.batch_sizes)
    assert all(r.compiled for r in results.values())


def test_admission_queue_sheds_load():
    """A full admission queue rejects instead of queueing unboundedly."""
    class Slow:
        name = MODEL

        def generate(self, prompt, *, meta):
            time.sleep(0.5)
            return LLMResponse("x", MODEL, 1, 1, 0.0, 0.0)

    backend = BatchingBackend(Slow(), max_batch=1, max_wait=0.0,
                              max_pending=1)
    errors, oks = [], []
    mu = threading.Lock()

    def caller():
        try:
            backend.generate("p", meta={})
            with mu:
                oks.append(1)
        except AdmissionError:
            with mu:
                errors.append(1)

    first = threading.Thread(target=caller)
    first.start()
    time.sleep(0.15)  # worker is now busy with the first request
    rest = [threading.Thread(target=caller) for _ in range(4)]
    for t in rest:
        t.start()
    for t in [first, *rest]:
        t.join()
    assert errors, "queue never shed load"
    assert oks, "admitted requests must still complete"
    assert backend.stats.rejected == len(errors)
    backend.close()


# ---------------------------------------------------------------------------
# Wire schema + endpoints
# ---------------------------------------------------------------------------


def test_wire_roundtrip_preserves_result(tmp_path):
    svc = MappingService(cache=ArtifactCache(tmp_path),
                         backend_factory=MockLLMBackend,
                         n_validate=2000, sample_every=1)
    res = svc.derive("msimplex3", MODEL, 20)
    payload = json.loads(json.dumps(pipeline.wire_from_result(res)))
    back = pipeline.result_from_wire(payload)
    assert back.cache_key == res.cache_key
    assert back.source == res.source
    assert back.report == res.report
    assert back.domainobj.name == "msimplex3"
    assert back.artifact.to_record() == res.artifact.to_record()
    with pytest.raises(ValueError, match="wire version"):
        pipeline.result_from_wire({**payload, "wire": 999})


def test_grid_streams_and_second_client_hits_server_cache(tmp_path):
    factory = shared_factory()
    with make_server(tmp_path, factory) as server:
        c1 = RemoteMappingService(server.url)
        first = [(r.domain, r.stage, r.cache_hit)
                 for r in c1.run_grid(domains=["tri2d", "gasket2d"],
                                      models=[MODEL], stages=[20, 50])]
        assert len(first) == 4 and not any(hit for _, _, hit in first)
        c2 = RemoteMappingService(server.url)
        grid = c2.grid(domains=["tri2d", "gasket2d"], models=[MODEL],
                       stages=[20, 50])
        assert len(grid) == 4
        assert all(r.cache_hit for r in grid.values())
        assert c2.stats.server_cache_hits == 4
        assert factory.bank[MODEL].calls == 4  # nothing re-derived


def test_artifact_miss_is_structured_json(tmp_path):
    """GET /v1/artifact/<key> misses answer with a JSON error body carrying
    the key, under the JSON content type — same envelope as every other
    endpoint, so clients never special-case the miss path."""
    missing = "deadbeef" * 8  # well-formed content address, never stored
    factory = shared_factory()
    with make_server(tmp_path, factory) as server:
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{server.url}/v1/artifact/{missing}")
        e = err.value
        assert e.code == 404
        assert e.headers.get("Content-Type") == "application/json"
        body = json.loads(e.read())
        assert body["key"] == missing
        assert missing in body["error"]


def test_store_stats_and_delete_endpoints(tmp_path):
    factory = shared_factory()
    with make_server(tmp_path, factory) as server:
        client = RemoteMappingService(server.url)
        res = client.derive("tri2d", MODEL, 20)

        stats = client.store_stats()
        assert stats["store"]["memory"]["entries"] == 1
        assert stats["usage"]["records"] == 1 and stats["usage"]["bytes"] > 0

        deleted = client.delete_artifact(res.cache_key)
        assert deleted == {"key": res.cache_key, "deleted": True}
        assert client.store_stats()["usage"]["records"] == 0
        with pytest.raises(RemoteServiceError) as gone:
            client.delete_artifact(res.cache_key)  # idempotent via 404
        assert gone.value.status == 404
        with pytest.raises(RemoteServiceError) as miss:
            client.fetch_artifact(res.cache_key)
        assert miss.value.status == 404
        # the cell re-derives rather than serving the deleted record
        again = client.derive("tri2d", MODEL, 20)
        assert not again.cache_hit
        assert factory.bank[MODEL].calls == 2


# ---------------------------------------------------------------------------
# Peer replication: two servers, disjoint local stores, one inference
# ---------------------------------------------------------------------------


def two_servers(tmp_path, factory):
    """A <-> B with disjoint local stores and mutual peer wiring.  B's peer
    tier is wired at construction; A's is attached after B boots (ports are
    ephemeral, so somebody has to go second)."""
    store_a = build_store(root=tmp_path / "a")
    svc_a = MappingService(store=store_a, backend_factory=factory,
                           n_validate=2000, sample_every=1)
    srv_a = MappingHTTPServer(svc_a).start()
    store_b = build_store(root=tmp_path / "b", peers=[srv_a.url])
    svc_b = MappingService(store=store_b, backend_factory=factory,
                           n_validate=2000, sample_every=1)
    srv_b = MappingHTTPServer(svc_b).start()
    store_a.peer = PeerStore([srv_b.url])
    return srv_a, srv_b


def test_two_servers_one_inference_acceptance(tmp_path):
    """The acceptance scenario: derive on A, hit from B — one backend
    inference total across the fleet, verified by both servers' stats; and
    B's repeat is a memory-tier hit with zero disk reads."""
    factory = shared_factory()
    srv_a, srv_b = two_servers(tmp_path, factory)
    try:
        res_a = RemoteMappingService(srv_a.url).derive("carpet2d", MODEL, 100)
        assert not res_a.cache_hit

        # write-back: A pushed its publish to B's local tiers already
        store_b = srv_b.service.store
        assert store_b.load_local(res_a.cache_key) is not None
        assert store_b.disk.path(res_a.cache_key).exists()

        client_b = RemoteMappingService(srv_b.url)
        res_b = client_b.derive("carpet2d", MODEL, 100)
        assert res_b.cache_hit
        assert res_b.source == res_a.source
        assert factory.bank[MODEL].calls == 1          # ONE inference total
        assert srv_b.service.stats.derivations == 0    # B never ran a pipeline

        # hot repeat on B: memory tier, no disk read
        reads = store_b.disk.reads
        assert client_b.derive("carpet2d", MODEL, 100).cache_hit
        assert store_b.disk.reads == reads

        metrics = client_b.metrics()
        assert metrics["service"]["derivations"] == 0
        assert metrics["service"]["cache_hits"] >= 2
        assert metrics["store"]["tiers"]["memory"]["hits"] >= 1
    finally:
        srv_a.close()
        srv_b.close()


def test_peer_read_through_after_local_delete(tmp_path):
    """Delete on B, re-request on B: the record comes back through the peer
    tier (read-through from A) and replicates onto B — still zero extra
    inferences."""
    factory = shared_factory()
    srv_a, srv_b = two_servers(tmp_path, factory)
    try:
        client_b = RemoteMappingService(srv_b.url)
        res = RemoteMappingService(srv_a.url).derive("tri2d", MODEL, 50)
        client_b.delete_artifact(res.cache_key)       # drop B's local copy
        store_b = srv_b.service.store
        assert store_b.load_local(res.cache_key) is None

        res_b = client_b.derive("tri2d", MODEL, 50)
        assert res_b.cache_hit
        assert factory.bank[MODEL].calls == 1
        assert store_b.peer.hits == 1                 # served via peer pull
        assert store_b.load_local(res.cache_key) is not None  # replicated
        # the replication pull endpoint serves the raw record
        rec = client_b.pull_record(res.cache_key)
        assert rec["domain"] == "tri2d" and rec["key"] == res.cache_key
    finally:
        srv_a.close()
        srv_b.close()


def test_replicate_push_rejects_bad_checksum(tmp_path):
    """The push endpoint verifies the record envelope before storing —
    corruption (or a forged record) must not enter through the wire when
    the disk tier would quarantine the same bytes on read."""
    from repro_torch.core.store import finalize_record

    k1, k2, k3, k4 = ("a1" * 32, "b2" * 32, "c3" * 32, "d4" * 32)
    factory = shared_factory()
    with make_server(tmp_path, factory) as server:
        client = RemoteMappingService(server.url)
        good = finalize_record(k1, {"domain": "tri2d", "pad": "x"})
        assert client._call_json(f"/v1/replicate/{k1}", good) == {
            "key": k1, "stored": True}
        assert client.pull_record(k1)["pad"] == "x"

        tampered = {**good, "pad": "y"}  # payload changed, checksum stale
        with pytest.raises(RemoteServiceError) as bad:
            client._call_json(f"/v1/replicate/{k2}", tampered)
        assert bad.value.status == 400
        naked = {"domain": "tri2d", "pad": "z"}  # no envelope at all
        with pytest.raises(RemoteServiceError) as no_env:
            client._call_json(f"/v1/replicate/{k3}", naked)
        assert no_env.value.status == 400
        mismatched_key = finalize_record("e5" * 32, {"domain": "tri2d"})
        with pytest.raises(RemoteServiceError) as wrong_key:
            client._call_json(f"/v1/replicate/{k4}", mismatched_key)
        assert wrong_key.value.status == 400
        for key in (k2, k3, k4):
            with pytest.raises(RemoteServiceError):
                client.pull_record(key)  # nothing landed


def test_wire_keys_cannot_escape_the_store_root(tmp_path):
    """A wire-supplied key becomes a filesystem path component inside the
    store, so anything that is not a sha256 content address is rejected
    with 400 before it touches the store — ``../`` can neither read,
    delete, nor write outside the store root."""
    import http.client

    from repro_torch.core.store import finalize_record

    secret = tmp_path / "secret.json"
    secret.write_text(json.dumps({"outside": "the store"}))
    store = build_store(root=tmp_path / "store")
    svc = MappingService(store=store, backend_factory=shared_factory(),
                         n_validate=2000, sample_every=1)
    with MappingHTTPServer(svc) as server:
        def raw(method, path, body=None):
            # http.client sends the path verbatim (urllib would not let a
            # "../" segment through unmangled)
            conn = http.client.HTTPConnection(server.host, server.port)
            try:
                headers = {"Content-Type": "application/json"} if body else {}
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
                return resp.status, json.loads(resp.read())
            finally:
                conn.close()

        evil = "../secret"
        for method, path in (("GET", f"/v1/artifact/{evil}"),
                             ("DELETE", f"/v1/artifact/{evil}"),
                             ("GET", f"/v1/replicate/{evil}")):
            status, body = raw(method, path)
            assert status == 400, (method, path)
            assert "invalid key" in body["error"]
        assert secret.exists()  # nothing deleted it
        assert json.loads(secret.read_text()) == {"outside": "the store"}

        planted = finalize_record("../planted", {"domain": "tri2d"})
        status, body = raw("POST", "/v1/replicate/../planted",
                           json.dumps(planted))
        assert status == 400
        assert not (tmp_path / "planted.json").exists()  # nothing landed


def test_peer_absence_degrades_to_local_derivation(tmp_path):
    """A dead peer is a miss, not an error: the service derives locally and
    the peer tier just counts the failure."""
    factory = shared_factory()
    store = build_store(root=tmp_path, peers=["http://127.0.0.1:9"])
    store.peer.timeout = 0.2
    svc = MappingService(store=store, backend_factory=factory,
                         n_validate=2000, sample_every=1)
    res = svc.derive("gasket2d", MODEL, 20)
    assert res.compiled and svc.stats.derivations == 1
    assert store.peer.errors >= 1
    assert store.peer.push_errors >= 1  # write-back also failed quietly


def test_artifact_endpoint_and_error_codes(tmp_path):
    factory = shared_factory()
    with make_server(tmp_path, factory) as server:
        client = RemoteMappingService(server.url)
        res = client.derive("tri2d", MODEL, 100)
        fetched = client.fetch_artifact(res.cache_key)
        assert fetched["record"]["domain"] == "tri2d"
        assert fetched["artifact"]["source"] == res.source
        with pytest.raises(RemoteServiceError) as e404:
            client.fetch_artifact("f0" * 32)  # well-formed, never stored
        assert e404.value.status == 404
        with pytest.raises(RemoteServiceError) as ekey:
            client.fetch_artifact("no-such-key")  # malformed address
        assert ekey.value.status == 400
        with pytest.raises(RemoteServiceError) as edom:
            client.derive("not-a-domain", MODEL, 20)
        assert edom.value.status == 404
        with pytest.raises(RemoteServiceError) as ebad:
            client._call_json("/v1/derive", {"domain": "tri2d"})  # no model
        assert ebad.value.status == 400
        assert client.healthy()


def test_client_falls_back_to_local_service(tmp_path):
    """Unreachable server + configured fallback: the request is served
    locally instead of failing."""
    local = MappingService(cache=ArtifactCache(tmp_path),
                           backend_factory=MockLLMBackend,
                           n_validate=2000, sample_every=1)
    client = RemoteMappingService("http://127.0.0.1:9", retries=1,
                                  backoff=0.01, fallback=local)
    res = client.derive("gasket2d", MODEL, 20)
    assert res.compiled
    assert client.stats.fallbacks == 1
    assert client.stats.retries == 1
    assert not client.healthy()
    # grid falls back too, and without a fallback the error surfaces
    assert len(list(client.run_grid(domains=["gasket2d"], models=[MODEL],
                                    stages=[20]))) == 1
    bare = RemoteMappingService("http://127.0.0.1:9", retries=0, backoff=0.01)
    with pytest.raises(RemoteServiceError):
        bare.derive("gasket2d", MODEL, 20)


def test_service_stats_in_process_path(tmp_path):
    """The promoted ServiceStats counters on the plain in-process service:
    requests/errors/cache_hit_ratio move without any HTTP involved."""
    svc = MappingService(cache=ArtifactCache(tmp_path),
                         backend_factory=MockLLMBackend,
                         n_validate=2000, sample_every=1)
    svc.derive("tri2d", MODEL, 20)
    svc.derive("tri2d", MODEL, 20)
    snap = svc.stats_snapshot()
    assert snap.requests == 2
    assert snap.derivations == 1 and snap.cache_hits == 1
    assert snap.cache_hit_ratio == pytest.approx(0.5)
    assert snap.errors == 0
    with pytest.raises(ValueError):
        svc.derive("tri2d", "no-such-model", 20)
    assert svc.stats.errors == 1 and svc.stats.requests == 3
    assert svc.inflight_count() == 0
    d = snap.as_dict()
    assert set(d) >= {"requests", "derivations", "cache_hits", "coalesced",
                      "errors", "cache_hit_ratio"}
