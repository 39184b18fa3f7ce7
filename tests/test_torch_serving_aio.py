"""The port's async serving core end to end, as
``tests/test_async_serving.py`` holds the JAX package's: the event-loop
frontend speaks the same wire surface as the threaded server (pooled
keep-alive clients work against either unchanged), typed backend errors map
to 503/504 and surface as typed client errors after retry exhaustion, slow
readers stall only their own stream, and the frontend sheds with 503 under
admission pressure.  ``test_async_engine_backend_lifecycle`` drives the
continuous batcher's ``AsyncEngineBackend`` over an ``EngineBackend`` on the
CPU (``device="cpu"``); ``test_async_backend_lifecycle`` drives the same
server-managed lifecycle through ``AsyncBackendAdapter``."""
import json
import socket
import threading
import time
import urllib.request

import pytest

from repro_torch.core.artifact import ArtifactCache
from repro_torch.core.backends import (
    AsyncBackendAdapter, EngineBackend, LLMBusyError, LLMTimeoutError,
    MockLLMBackend,
)
from repro_torch.serving import (
    AsyncMappingHTTPServer, BatchingBackend, MappingHTTPServer,
    MappingService, RemoteBusyError, RemoteMappingService,
    RemoteTimeoutError,
)
from repro_torch.serving.async_engine import AsyncEngineBackend

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


class TimeoutBackend:
    """Backend whose every generate blows its deadline — the 504 story."""

    def __init__(self, model: str):
        self._inner = MockLLMBackend(model)
        self.name = self._inner.name
        self.calls = 0
        self._mu = threading.Lock()

    @property
    def cache_fingerprint(self):
        return self._inner.cache_fingerprint

    def generate(self, prompt, *, meta):
        with self._mu:
            self.calls += 1
        raise LLMTimeoutError(f"inference on {self.name!r} timed out")


def shared_factory(cls=CountingBackend, **bkw):
    bank: dict = {}
    mu = threading.Lock()

    def factory(model: str):
        with mu:
            if model not in bank:
                bank[model] = cls(model, **bkw)
            return bank[model]

    factory.bank = bank
    return factory


def make_service(tmp_path, factory, **kw):
    kw.setdefault("n_validate", 2000)
    kw.setdefault("sample_every", 1)
    return MappingService(cache=ArtifactCache(tmp_path),
                         backend_factory=factory, **kw)


def make_async(tmp_path, factory, *, service_kw=None, **kw):
    svc = make_service(tmp_path, factory, **(service_kw or {}))
    return AsyncMappingHTTPServer(svc, **kw)


def post_json(url, path, payload):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


# ---------------------------------------------------------------------------
# Wire parity: the pooled keep-alive client against the event loop
# ---------------------------------------------------------------------------


def test_async_frontend_serves_keepalive_client(tmp_path):
    """RemoteMappingService (pooled keep-alive transport) against the async
    frontend: derives round-trip, cache_hit is truthful (False exactly once),
    and /metrics carries the threaded payload shape plus the aio section."""
    factory = shared_factory()
    with make_async(tmp_path, factory) as server:
        client = RemoteMappingService(server.url)
        r1 = client.derive("tri2d", MODEL, 20)
        r2 = client.derive("tri2d", MODEL, 20)
        assert r1.cache_key == r2.cache_key
        assert factory.bank[MODEL].calls == 1

        # truthful cache_hit on the wire: fresh derivation says False, every
        # repeat (event-loop fast path) says True
        hits = [post_json(server.url, "/v1/derive",
                          {"domain": "cantor2d", "model": MODEL,
                           "stage": 20})["cache_hit"]
                for _ in range(3)]
        assert hits == [False, True, True]

        assert client.healthy()
        metrics = client.metrics()
        assert metrics["service"]["derivations"] == 2
        assert metrics["http"]["derive"]["requests"] == 5
        aio = metrics["aio"]
        assert aio["fast_hits"] >= 3      # r2 + the two repeats
        assert aio["wire_hits"] >= 1      # repeat #2 skipped serialization
        assert aio["offloaded"] == 2      # the two cold derivations
        assert aio["shed"] == 0

        # streamed /v1/grid through the client's NDJSON path
        cells = client.grid(["tri2d"], [MODEL], [20, 50])
        assert len(cells) == 2
        assert factory.bank[MODEL].calls == 3  # only stage 50 was new


def test_concurrent_same_cell_single_inference(tmp_path):
    """16 clients racing on one cell through the async frontend: the
    service's in-flight coalescing still guarantees exactly one backend
    inference, and every client gets the same content address."""
    factory = shared_factory()
    with make_async(tmp_path, factory) as server:
        out = {}
        mu = threading.Lock()
        gate = threading.Barrier(16)

        def client(i):
            c = RemoteMappingService(server.url)
            gate.wait()
            res = c.derive("tri2d", MODEL, 20)
            with mu:
                out[i] = res.cache_key

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

        assert factory.bank[MODEL].calls == 1
        assert len(set(out.values())) == 1
        assert len(out) == 16


def test_async_engine_backend_lifecycle(tmp_path):
    """The server drives AsyncLLMBackend lifecycles: health shows up in
    /healthz, and close() tears the batcher down with the loop."""
    inner = EngineBackend(MODEL, max_new_tokens=2, device="cpu")
    backend = AsyncEngineBackend(inner, decode_slots=2)
    factory = shared_factory()
    server = make_async(tmp_path, factory, async_backends=[backend])
    with server:
        with urllib.request.urlopen(server.url + "/healthz",
                                    timeout=10) as resp:
            payload = json.loads(resp.read())
        assert payload["loop"] == "asyncio"
        assert payload["backends"] == {MODEL: True}
    # server close() drove backend.close(): the batcher refuses new work
    with pytest.raises(LLMBusyError):
        backend.batcher.submit("p", {})


def test_async_backend_lifecycle(tmp_path):
    """The server drives AsyncLLMBackend lifecycles: start with the loop,
    health in /healthz, close() with the loop."""
    events = []

    class Recorded(MockLLMBackend):
        def start(self):
            events.append("start")

        def close(self):
            events.append("close")

    backend = AsyncBackendAdapter(Recorded(MODEL))
    factory = shared_factory()
    server = make_async(tmp_path, factory, async_backends=[backend])
    with server:
        with urllib.request.urlopen(server.url + "/healthz",
                                    timeout=10) as resp:
            payload = json.loads(resp.read())
        assert payload["loop"] == "asyncio"
        assert payload["backends"] == {MODEL: True}
        assert events == ["start"]
    assert events == ["start", "close"]


# ---------------------------------------------------------------------------
# Typed errors on the wire: 503 shed, 504 timeout, client-side surfacing
# ---------------------------------------------------------------------------


def test_async_frontend_sheds_503_when_saturated(tmp_path):
    """Past max_pending in-flight cold derives the frontend sheds with 503;
    a no-retry client surfaces it as RemoteBusyError — which IS an
    LLMBusyError, so remote saturation reads like local saturation."""
    factory = shared_factory(delay=0.5)
    with make_async(tmp_path, factory, max_pending=1) as server:
        domains = ["tri2d", "cantor2d", "carpet2d", "gasket2d"]
        results, errors = {}, {}
        mu = threading.Lock()
        gate = threading.Barrier(len(domains))

        def client(dom):
            c = RemoteMappingService(server.url, retries=0)
            gate.wait()
            try:
                res = c.derive(dom, MODEL, 20)
                with mu:
                    results[dom] = res
            except RemoteBusyError as e:
                with mu:
                    errors[dom] = e

        threads = [threading.Thread(target=client, args=(d,))
                   for d in domains]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

        assert results, "at least one derive should get the slot"
        assert errors, "the rest should be shed with 503"
        assert len(results) + len(errors) == len(domains)
        for err in errors.values():
            assert isinstance(err, LLMBusyError)
            assert err.status == 503
        assert server.shed == len(errors)


@pytest.mark.parametrize("frontend", ["threaded", "async"])
def test_backend_timeout_maps_to_504_and_surfaces_typed(tmp_path, frontend):
    """LLMTimeoutError in the backend → 504 on the wire → client retries
    with backoff → RemoteTimeoutError (an LLMTimeoutError) on exhaustion.
    Identical through either frontend."""
    factory = shared_factory(cls=TimeoutBackend)
    svc = make_service(tmp_path, factory)
    server = MappingHTTPServer(svc) if frontend == "threaded" \
        else AsyncMappingHTTPServer(svc)
    with server:
        client = RemoteMappingService(server.url, retries=2, backoff=0.01)
        with pytest.raises(RemoteTimeoutError) as exc:
            client.derive("tri2d", MODEL, 20)
        assert isinstance(exc.value, LLMTimeoutError)
        assert exc.value.status == 504
        # 504 is retryable: every attempt reached the backend
        assert factory.bank[MODEL].calls == 3


# ---------------------------------------------------------------------------
# Batching satellite: a full batch must not sleep out max_wait
# ---------------------------------------------------------------------------


def test_full_batch_dispatches_without_waiting():
    """The max_batch-th arrival dispatches the batch immediately — a burst
    never sleeps out max_wait (here 5s: failing the old gather loop's
    behavior by an order of magnitude, not a timing jitter)."""
    bb = BatchingBackend(MockLLMBackend(MODEL), max_batch=4, max_wait=5.0)
    meta = {"domain": "tri2d", "stage": 20}
    gate = threading.Barrier(4)
    done = []
    mu = threading.Lock()

    def go(i):
        gate.wait()
        r = bb.generate(f"prompt {i}", meta=meta)
        with mu:
            done.append(r)

    t0 = time.monotonic()
    threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.monotonic() - t0
    bb.close()

    assert len(done) == 4
    assert elapsed < 2.0, (
        f"full batch took {elapsed:.2f}s — it waited out max_wait instead "
        f"of dispatching on the 4th arrival")
    assert bb.stats.batches == 1
    assert bb.stats.max_batch_seen == 4
    assert bb.stats.batched_requests == 4


# ---------------------------------------------------------------------------
# Backpressure: a stalled reader pauses its own stream, nothing else
# ---------------------------------------------------------------------------


def test_slow_grid_reader_stalls_only_its_own_stream(tmp_path):
    """A client that stops reading mid /v1/grid NDJSON pauses *production*
    for that connection (bounded by the write buffer, not the sweep size),
    while other connections keep deriving; when it resumes it gets every
    line, and the server records the stall."""
    factory = shared_factory()
    server = make_async(tmp_path, factory, stream_buffer_bytes=4096,
                        stall_threshold=0.2)
    # shrink the kernel-side send buffer so backpressure reaches the
    # transport quickly (accepted sockets inherit from the listener)
    server._sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4096)
    with server:
        svc = server.service
        # warm the cell: every grid line below is then a cheap cache hit,
        # so production speed is bounded only by backpressure
        RemoteMappingService(server.url).derive("tri2d", MODEL, 20)

        body = json.dumps({"domains": ["tri2d"] * 200,
                           "models": [MODEL], "stages": [20]}).encode()
        raw = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        raw.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        raw.settimeout(30)
        raw.connect((server.host, server.port))
        raw.sendall(b"POST /v1/grid HTTP/1.1\r\nHost: t\r\n"
                    b"Content-Type: application/json\r\n"
                    b"Content-Length: " + str(len(body)).encode() +
                    b"\r\n\r\n" + body)
        buf = raw.recv(2048)  # headers + first lines, then... stall.

        time.sleep(0.6)  # let production hit the high-water mark
        s1 = svc.stats.requests
        time.sleep(0.4)
        s2 = svc.stats.requests
        # production is paused: at most one in-flight cell moved
        assert s2 - s1 <= 1, f"producer kept running while stalled ({s1}->{s2})"
        assert s2 < 150, f"sweep ran {s2} cells ahead of a stalled reader"

        # other connections are not behind this stream: a cold derive on a
        # second connection completes while the grid reader is stalled
        other = RemoteMappingService(server.url).derive("cantor2d", MODEL, 20)
        assert other.cache_key

        # resume: drain the whole stream to EOF (close-delimited)
        while True:
            chunk = raw.recv(65536)
            if not chunk:
                break
            buf += chunk
        raw.close()

        head, _, payload = buf.partition(b"\r\n\r\n")
        assert head.startswith(b"HTTP/1.1 200")
        lines = [ln for ln in payload.split(b"\n") if ln]
        assert len(lines) == 200
        assert all(json.loads(ln)["record"]["domain"] == "tri2d"
                   for ln in lines)
        assert server.stream_stalls >= 1
        # one inference for the whole exercise on this cell
        assert factory.bank[MODEL].calls == 2  # tri2d + cantor2d
