"""HTTP frontend for the MappingService — stdlib only, no new deps.

One derivation server, many cheap clients: the paper's one-time LLM
derivation cost only amortizes when every later GPU launch shares it, and
sharing across machines means a network surface.  This module wraps a
:class:`~repro_torch.serving.map_service.MappingService` in a
``ThreadingHTTPServer`` speaking JSON:

    POST   /v1/derive           {domain, model, stage}  -> wire payload
    POST   /v1/evaluate         batched map evaluation: {domain|key, tier,
                                n_points|extent, ...} single query, or
                                {queries: [...]} heterogeneous batch, or
                                {sweep: {domains, sizes}} NDJSON stream —
                                mapped coordinates, not mapping code
    GET    /v1/artifact/<key>   cached derivation record by content address
                                (local tiers only — no peer probe)
    DELETE /v1/artifact/<key>   drop one record from this node's tiers
    POST   /v1/grid             {domains, models, stages} -> NDJSON stream,
                                one wire payload per resolved cell
    GET    /v1/store/stats      per-tier store counters + disk usage
                                (+ cluster/ring state when clustered)
    GET    /v1/cluster          membership view exchange: this node's view
                                of the fleet + ring parameters (404 when
                                the node runs standalone)
    GET    /v1/replicate/manifest  this node's key manifest (local tiers) —
                                the anti-entropy repair surface
    GET    /v1/replicate/<key>  replication pull: the raw local record
                                (memory/disk only — a peer's question never
                                triggers our own peer fetch)
    POST   /v1/replicate/<key>  replication push: store a record published
                                by a sibling server into the local tiers
    GET    /healthz             liveness probe (+ uptime, serving mode)
    GET    /metrics             ServiceStats + per-endpoint latency
                                percentiles + batching/admission counters +
                                per-tier store counters + cluster state
                                (?format=prometheus -> text exposition)
    GET    /v1/trace/<id>       this node's span shard of one request trace
    GET    /v1/traces           recent trace IDs + ring-buffer stats

Every thread the server spawns funnels into the *same* service instance, so
the coalescing table and artifact-store file lock are exactly
the concurrency story here too: N concurrent POSTs for one cell still run
one pipeline.  Payload schemas live in ``core/pipeline.py``
(``wire_from_result``/``result_from_wire``) so the client rehydrates the
same record shape the store holds.  ``AdmissionError`` from the batching
queue maps to 503 — the server sheds load instead of queueing unboundedly.
The two /v1/replicate endpoints are the wire surface of
:class:`~repro_torch.core.store.PeerStore` — point two servers at each other with
``--peers`` and a derivation on either is a hit on both.

Responses speak HTTP/1.1 with explicit Content-Length, so a client holding
a pooled connection (``serving/client.py``) reuses it across requests
instead of paying a TCP handshake per derive; the /v1/grid NDJSON stream is
the one close-delimited response (its length is unknowable up front).

With a :class:`~repro_torch.serving.cluster.ClusterMembership` attached
(``--cluster-seed``), the node participates in a consistent-hash sharded
fleet: a POST /v1/derive whose content address this node does not own is
forwarded to the ring owner (one hop at most — forwarded requests carry
``X-Repro-Forwarded`` and are always served where they land), replication
pushes are scoped to the key's K replicas, and the anti-entropy loop
repairs owned-but-missing records through the manifest endpoint.
"""
from __future__ import annotations

import json
import socket
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

from repro_torch.core import pipeline
from repro_torch.core import store as store_mod
from repro_torch.core.backends import (
    LLMBusyError,
    LLMTimeoutError,
    LLMUnavailableError,
)
from repro_torch.core.domains import DOMAINS
from repro_torch.obs import Observability
from repro_torch.obs import trace as obs_trace
from repro_torch.serving import wire
from repro_torch.serving.map_service import MappingService

MAX_BODY_BYTES = 1 << 20  # a derive/grid request is tiny; refuse anything big

#: marks a derive that already took its one forwarding hop — the receiving
#: node serves it locally even if its ring view disagrees, so two nodes with
#: momentarily different views can never bounce a request between them
FORWARDED_HEADER = "X-Repro-Forwarded"


class _FleetHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a fleet-sized accept backlog.  The stdlib
    default (``request_queue_size = 5``) drops connections under the
    bursts a sharded fleet actually produces — 64 clients opening at
    once, or a router fanning forwarded hops into one hot owner — which
    surfaces as resets, spurious failure penalties in the replica
    selector, and needless local-degradation derives."""

    request_queue_size = 128


def map_error(e: BaseException) -> tuple[int, dict]:
    """Typed exception -> (status, JSON body), shared by the threaded and
    asyncio frontends so the two paths can never disagree on a wire code:

        LLMTimeoutError                    -> 504 retryable (deadline blown;
                                              derivations are idempotent)
        LLMBusyError (incl AdmissionError) -> 503 retryable (shed, back off)
        LLMUnavailableError                -> 503 retryable (backend down)
        KeyError                           -> 404 (unknown domain/model/key)
        ValueError / bad JSON              -> 400
        anything else                      -> 500
    """
    if isinstance(e, LLMTimeoutError):
        return 504, {"error": str(e), "retryable": True}
    if isinstance(e, (LLMBusyError, LLMUnavailableError)):
        return 503, {"error": str(e), "retryable": True}
    if isinstance(e, KeyError):
        return 404, {"error": f"unknown name: {e}"}
    if isinstance(e, (ValueError, json.JSONDecodeError)):
        return 400, {"error": str(e)}
    return 500, {"error": f"{type(e).__name__}: {e}"}


def collect_metrics(service: MappingService, http: dict, cluster=None,
                    forwarded: int = 0, forward_errors: int = 0,
                    evaluator=None, frontend: dict | None = None,
                    router=None, eval_wire=None) -> dict:
    """The shared /metrics payload shape — one builder for the threaded and
    asyncio frontends so scrapers see identical keys from either.  The
    per-endpoint ``http`` section comes from the observability plane's
    bounded histograms (``repro_torch.obs``); ``frontend`` is the mode/uptime/
    trace-buffer section both frontends emit with one key set (the metrics
    parity contract)."""
    out = {
        "service": service.stats_snapshot().as_dict(),
        "inflight": service.inflight_count(),
        "http": http,
        "batching": {},
    }
    if frontend is not None:
        out["frontend"] = frontend
    for model, backend in service.backends().items():
        # duck-typed: BatchingBackend.BatchStats and the continuous
        # batcher's ContinuousStats both publish as_dict()
        stats = getattr(backend, "stats", None)
        if hasattr(stats, "as_dict"):
            out["batching"][model] = stats.as_dict()
    if service.store is not None:
        # counters only — sizing the store (a directory glob) is the
        # explicit /v1/store/stats endpoint, not the scrape path
        out["store"] = {"hits": service.store.hits,
                        "misses": service.store.misses,
                        "tiers": service.store.stats()}
    if cluster is not None:
        out["cluster"] = {**cluster.stats(),
                          "forwarded": forwarded,
                          "forward_errors": forward_errors}
    if router is not None:
        # queue depth/expiry/retry gauges + per-replica selection counters
        # (the numbers the routing chaos CI leg asserts traffic shifts on)
        out["router"] = router.stats_dict()
    if evaluator is not None:
        # stats_dict embeds the compile-cache counters; surface them at
        # the top level too so scrapers find one well-known key
        ev = evaluator.stats_dict()
        out["compile_cache"] = ev.pop("compile_cache", None)
        out["evaluate"] = ev
    if eval_wire is not None:
        # the evaluate-plane response-bytes LRU (serving/wire.py)
        out["evaluate_wire"] = eval_wire.stats_dict()
    return out


class MappingHTTPServer:
    """The networked face of one MappingService.

    ``port=0`` binds an ephemeral port (read it back from ``.port`` /
    ``.url``).  ``start()`` serves from a daemon thread; ``close()`` shuts
    the listener down and joins it.  Usable as a context manager."""

    def __init__(self, service: MappingService, host: str = "127.0.0.1",
                 port: int = 0, observability: bool = True,
                 router=None, serve_delay: float = 0.0,
                 wire_cache_entries: int = 256):
        from repro_torch.serving.router import RequestRouter

        self.service = service
        self.cluster = None  # ClusterMembership once attach_cluster() ran
        self.forwarded = 0          # derives proxied to their ring owner
        self.forward_errors = 0     # owner unreachable -> served locally
        # below the client's default 60s timeout: a stalled owner must not
        # pin forwarding threads past the point the caller has given up —
        # the forward degrades to local derivation instead
        self.forward_timeout = 30.0
        #: per-node scheduler + load-aware replica selector (forwards go to
        #: the *best* owner, not the first; queue depth is advertised to
        #: peers via the cluster view and /healthz)
        self.router = router if router is not None else RequestRouter()
        #: chaos/benchmark knob: sleep this long before serving each derive
        #: (an artificially slowed replica the selector must route around)
        self.serve_delay = max(0.0, float(serve_delay))
        self.obs = Observability(mode="threaded", enabled=observability)
        #: encoded evaluate responses keyed by resolved executable group +
        #: λ-range (binary and JSON cached separately; see serving/wire.py)
        self.eval_wire = wire.WireCache(entries=wire_cache_entries)
        self._evaluator = None       # EvaluationService, built on first use
        self._evaluator_mu = threading.Lock()
        self._conn_sockets: set = set()  # live keep-alive connections
        self._conn_mu = threading.Lock()
        handler = _make_handler(self)
        self.httpd = _FleetHTTPServer((host, port), handler)
        self.httpd.daemon_threads = True
        self.host = host
        self.port = self.httpd.server_address[1]
        self.obs.node = self.url
        self._thread: threading.Thread | None = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    @property
    def evaluator(self):
        """The node's EvaluationService, constructed on first evaluate
        request — a derive-only node never loads the kernels for it."""
        with self._evaluator_mu:
            if self._evaluator is None:
                from repro_torch.serving.evaluate import EvaluationService

                self._evaluator = EvaluationService(
                    artifact_resolver=self.service.artifact_for_key)
            return self._evaluator

    def attach_cluster(self, cluster) -> "ClusterMembership":  # noqa: F821
        """Join this node to a sharded fleet: wire the membership's ring
        into the store's peer tier (owner-scoped pulls and pushes instead of
        the static broadcast mesh), hand the store to the anti-entropy loop,
        and start the heartbeat/sync threads.  Call after construction —
        membership identity is this server's URL, which an ephemeral-port
        bind only knows post-bind."""
        from repro_torch.core.store import PeerStore

        self.cluster = cluster
        store = self.service.store
        if store is not None:
            if store.peer is None:
                store.peer = PeerStore(router=cluster.replica_peers)
            else:
                store.peer.router = cluster.replica_peers
            cluster.store = store
        # load piggyback: our queue depth rides every view we serve, and
        # every successful probe feeds the peer's advertised depth into the
        # replica selector
        if cluster.load_provider is None:
            cluster.load_provider = self.router.load
        if cluster.on_load is None:
            cluster.on_load = self.router.advertise
        cluster.start()
        return cluster

    def start(self) -> "MappingHTTPServer":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="mapping-http", daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def track_connection(self, sock, alive: bool) -> None:
        with self._conn_mu:
            (self._conn_sockets.add if alive
             else self._conn_sockets.discard)(sock)

    def close(self) -> None:
        if self.cluster is not None:
            self.cluster.close()
        self.httpd.shutdown()
        self.httpd.server_close()
        # sever established keep-alive connections too — without this a
        # "killed" node keeps answering pooled clients through lingering
        # handler threads, which is not what killed means
        with self._conn_mu:
            sockets = list(self._conn_sockets)
            self._conn_sockets.clear()
        for sock in sockets:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def __enter__(self) -> "MappingHTTPServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- metrics -----------------------------------------------------------
    def observe(self, endpoint: str, seconds: float, ok: bool) -> None:
        self.obs.observe(endpoint, seconds, ok)

    def metrics(self) -> dict:
        """The /metrics payload: one shared ServiceStats view + HTTP-layer
        latency percentiles + batching queues + per-tier store counters."""
        with self._evaluator_mu:
            evaluator = self._evaluator
        return collect_metrics(
            self.service, self.obs.http_dict(), cluster=self.cluster,
            forwarded=self.forwarded, forward_errors=self.forward_errors,
            evaluator=evaluator, frontend=self.obs.frontend_dict(),
            router=self.router, eval_wire=self.eval_wire)

    def metrics_prometheus(self) -> str:
        """The same numbers as Prometheus text exposition: registered
        instruments (latency histograms) + every numeric leaf of the JSON
        payload flattened to ``repro_*`` gauges."""
        return self.obs.prometheus(self.metrics())


def _make_handler(server: MappingHTTPServer):
    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1: every JSON response carries Content-Length, so pooled
        # client connections stay open across requests (keep-alive).  The
        # one exception is /v1/grid, whose NDJSON stream has no knowable
        # length — it answers `Connection: close` and stays close-delimited.
        protocol_version = "HTTP/1.1"
        # reap idle keep-alive connections so abandoned clients don't pin
        # a handler thread forever (socket timeout -> close_connection)
        timeout = 60.0
        # TCP_NODELAY: headers and body go out as separate small writes,
        # and on a keep-alive connection Nagle holds the second one until
        # the peer's delayed ACK (~40ms per response on loopback); fresh
        # connections never showed it because close() flushes
        disable_nagle_algorithm = True

        def setup(self) -> None:
            super().setup()
            server.track_connection(self.connection, alive=True)

        def finish(self) -> None:
            server.track_connection(self.connection, alive=False)
            super().finish()

        def log_message(self, fmt, *args):  # quiet by default
            pass

        # -- plumbing ------------------------------------------------------
        def _request_body_len(self) -> int:
            try:
                return int(self.headers.get("Content-Length") or 0)
            except (TypeError, ValueError):
                return 0

        def _send_json(self, status: int, payload: dict) -> None:
            # default=str matches the store's checksum/publish serialization
            # (core/store.py), so a memory-tier record holding a value the
            # disk tier would stringify (e.g. a Path) serves identically
            # from either tier instead of 500ing from the hot one
            body = json.dumps(payload, default=str).encode()
            self._send_body(status, body, "application/json")

        def _send_body(self, status: int, body: bytes,
                       content_type: str) -> None:
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            trace_id = obs_trace.current_trace_id()
            if trace_id is not None:
                # echo the request's trace ID so callers learn the ID the
                # ingress node minted for them
                self.send_header(obs_trace.TRACE_HEADER, trace_id)
            if status >= 400 and self._request_body_len() > 0:
                # an error may have fired before the request body was read
                # (oversized body, unknown route): close-delimit so the
                # unread bytes can't be parsed as the next request on a
                # kept-alive connection (send_header flips close_connection)
                self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)

        def _read_body(self) -> dict:
            length = int(self.headers.get("Content-Length") or 0)
            if length > MAX_BODY_BYTES:
                raise ValueError(f"request body too large ({length} bytes)")
            raw = self.rfile.read(length) if length else b""
            if not raw:
                return {}
            if wire.is_binary(self.headers.get("Content-Type")):
                # a binary-framed request: malformed/truncated frames and
                # unknown wire versions raise WireFormatError (a
                # ValueError) -> structured 400 via _timed's map_error
                return wire.decode_request(raw)
            body = json.loads(raw)
            if not isinstance(body, dict):
                raise ValueError("request body must be a JSON object")
            return body

        def _key_from_path(self, prefix: str) -> str | None:
            """The content address from a /v1/.../<key> URL, or None after
            answering 400.  Keys are always sha256 hex digests (see
            ``store.cache_key``), so rejecting anything else is lossless —
            and it is the security boundary that keeps a wire-supplied
            ``../``-style key from ever reaching a filesystem path."""
            key = self.path[len(prefix):]
            if not store_mod.valid_key(key):
                self._send_json(400, {
                    "error": "invalid key: content addresses are 64 "
                             "lowercase hex characters",
                    "key": key})
                return None
            return key

        def _timed(self, endpoint: str, fn) -> None:
            t0 = time.monotonic()
            ok = True
            token = server.obs.begin_request(
                self.headers.get(obs_trace.TRACE_HEADER))
            try:
                fn()
            except (BrokenPipeError, ConnectionResetError):
                ok = False  # client went away mid-response: nothing to send
            except Exception as e:  # noqa: BLE001 — surface, don't kill thread
                ok = False
                status, payload = map_error(e)
                self._send_json(status, payload)
            finally:
                seconds = time.monotonic() - t0
                server.observe(endpoint, seconds, ok)
                server.obs.end_request(token, endpoint, seconds, ok)

        # -- endpoints -----------------------------------------------------
        def do_GET(self) -> None:  # noqa: N802 (http.server API)
            if self.path == "/healthz":
                self._timed("healthz", self._healthz)
            elif self.path == "/metrics" \
                    or self.path.startswith("/metrics?"):
                self._timed("metrics", self._metrics)
            elif self.path == "/v1/traces":
                self._timed("traces", self._traces)
            elif self.path.startswith("/v1/trace/"):
                self._timed("trace", self._trace)
            elif self.path == "/v1/store/stats":
                self._timed("store_stats", self._store_stats)
            elif self.path == "/v1/cluster" \
                    or self.path.startswith("/v1/cluster?"):
                self._timed("cluster", self._cluster_view)
            elif self.path == "/v1/replicate/manifest":
                self._timed("manifest", self._manifest)
            elif self.path.startswith("/v1/artifact/"):
                self._timed("artifact", self._artifact)
            elif self.path.startswith("/v1/replicate/"):
                self._timed("replicate_pull", self._replicate_pull)
            else:
                self._send_json(404, {"error": f"no route {self.path!r}"})

        def do_POST(self) -> None:  # noqa: N802
            if self.path == "/v1/derive":
                self._timed("derive", self._derive)
            elif self.path == "/v1/evaluate" \
                    or self.path.startswith("/v1/evaluate?"):
                self._timed("evaluate", self._evaluate)
            elif self.path == "/v1/grid":
                self._timed("grid", self._grid)
            elif self.path.startswith("/v1/replicate/"):
                self._timed("replicate_push", self._replicate_push)
            else:
                self._send_json(404, {"error": f"no route {self.path!r}"})

        def do_DELETE(self) -> None:  # noqa: N802
            if self.path.startswith("/v1/artifact/"):
                self._timed("artifact_delete", self._artifact_delete)
            else:
                self._send_json(404, {"error": f"no route {self.path!r}"})

        def _healthz(self) -> None:
            store = server.service.store
            peers = getattr(getattr(store, "peer", None), "peers", [])
            payload = {
                "status": "ok",
                "store": store is not None,
                "peers": len(peers),
                "domains": len(DOMAINS),
                "mode": server.obs.mode,
                "uptime_seconds": server.obs.uptime_seconds(),
                "started_unix": server.obs.started_unix,
                "backend_names": sorted(server.service.backends()),
                # the advertised load (same numbers the cluster view
                # piggybacks) — lets external LBs and siblings read queue
                # depth off the liveness probe
                "load": server.router.load(),
            }
            if server.cluster is not None:
                payload["cluster_nodes_up"] = \
                    len(server.cluster.live_peers()) + 1
            self._send_json(200, payload)

        def _metrics(self) -> None:
            query = parse_qs(urlsplit(self.path).query)
            if query.get("format", [""])[0] == "prometheus":
                self._send_body(200, server.metrics_prometheus().encode(),
                                "text/plain; version=0.0.4")
                return
            self._send_json(200, server.metrics())

        def _trace(self) -> None:
            trace_id = self.path[len("/v1/trace/"):]
            payload = server.obs.trace_payload(trace_id)
            if payload is None:
                self._send_json(404, {"error": f"no trace {trace_id!r} on "
                                               "this node",
                                      "trace_id": trace_id})
                return
            self._send_json(200, payload)

        def _traces(self) -> None:
            self._send_json(200, server.obs.traces_payload())

        def _store_stats(self) -> None:
            store = server.service.store
            if store is None:
                payload = {"store": None}
            else:
                payload = {"store": store.stats(), "usage": store.usage()}
            if server.cluster is not None:
                payload["cluster"] = {**server.cluster.stats(),
                                      "forwarded": server.forwarded,
                                      "forward_errors": server.forward_errors}
            with server._evaluator_mu:
                evaluator = server._evaluator
            if evaluator is not None and evaluator.cache is not None:
                payload["compile_cache"] = evaluator.cache.stats_dict()
            self._send_json(200, payload)

        def _cluster_view(self) -> None:
            """Membership view exchange: how peers (and ring-aware clients)
            discover the fleet.  A probing peer announces itself via
            ``?from=`` and is folded into our view (symmetric discovery —
            a seed learns its joiners the moment they first probe it).  A
            standalone node answers 404 — it has no view, and static-mesh
            callers never ask."""
            if server.cluster is None:
                self._send_json(404, {"error": "node runs standalone "
                                               "(no --cluster-seed)"})
                return
            query = urlsplit(self.path).query
            announced = parse_qs(query).get("from", [""])[0]
            if announced:
                server.cluster.observe(announced)
            self._send_json(200, server.cluster.view())

        def _manifest(self) -> None:
            """This node's key manifest (local tiers only): what the
            anti-entropy loop on a peer diffs against its own holdings."""
            store = server.service.store
            keys = store.keys() if store is not None else []
            self._send_json(200, {"keys": keys, "count": len(keys)})

        def _derive(self) -> None:
            body = self._read_body()
            domain = body.get("domain")
            model = body.get("model")
            if not isinstance(domain, str) or not isinstance(model, str):
                raise ValueError("body must carry string 'domain' and 'model'")
            stage = body.get("stage", 100)
            if not isinstance(stage, int) or isinstance(stage, bool):
                raise ValueError("'stage' must be an integer")
            if self._maybe_forward(body, domain, model, stage):
                return
            if server.serve_delay > 0:  # chaos knob: an artificially slow
                time.sleep(server.serve_delay)  # replica to route around
            with server.router.track():
                res = server.service.derive(domain, model, stage)
            self._send_json(200, pipeline.wire_from_result(res))

        def _maybe_forward(self, body: dict, domain: str, model: str,
                           stage: int) -> bool:
            """Forward a derive this node does not own to the *best* ring
            owner (True = response already relayed).  At most one hop:
            forwarded requests are marked and always served where they
            land.  A node that already holds the record serves it
            regardless of ownership — a local hit beats a network hop.
            Owner order comes from the router's replica selector (EWMA
            latency + advertised queue depth, epsilon-greedy), and the hop
            runs through its bounded scheduler: a failed owner books a
            retry, a full queue or blown TTL degrades to local derivation
            (the fleet may briefly hold an extra copy; correctness never
            depends on placement)."""
            cluster = server.cluster
            if cluster is None or self.headers.get(FORWARDED_HEADER):
                return False
            key = server.service.request_key(domain, model, stage)
            if cluster.owns(key):
                return False
            store = server.service.store
            if store is not None and key in store:
                return False  # resident locally: serve, don't hop
            candidates = cluster.replica_peers(key)

            def hop(owner: str) -> tuple[int, bytes]:
                req = urllib.request.Request(
                    f"{owner}/v1/derive", data=json.dumps(body).encode(),
                    method="POST",
                    headers={"Content-Type": "application/json",
                             FORWARDED_HEADER: "1",
                             # the hop carries the trace ID, so the owner
                             # records its spans under the same trace
                             **obs_trace.wire_headers()})
                try:
                    with obs_trace.span("forward", owner=owner), \
                            urllib.request.urlopen(  # noqa: S310 — fleet URL
                                req, timeout=server.forward_timeout) as resp:
                        return resp.status, resp.read()
                except urllib.error.HTTPError as e:
                    # the owner answered: relay its verdict (400/404/503…)
                    return e.code, e.read()

            def on_error(owner: str, exc: Exception) -> None:
                server.forward_errors += 1

            with obs_trace.span("route_decision", key=key[:16],
                                candidates=len(candidates),
                                policy=server.router.policy) as span:
                answer = server.router.dispatch(key, candidates, hop,
                                                on_error=on_error)
                span["forwarded"] = answer is not None
            if answer is None:
                return False  # every owner failed/shed: local degradation
            status, payload = answer
            server.forwarded += 1
            self._send_body(status, payload, "application/json")
            return True

        def _evaluate(self) -> None:
            """Batched map evaluation: mapped coordinates (or a BB
            membership mask), not mapping code.  Three body shapes:

              {domain|key, tier?, n_points|extent, ...}   one query
              {"queries": [...]}                           heterogeneous batch
              {"sweep": {"domains": [...], "sizes": [...],
                         "tier"?, "block_n"?, "interpret"?}}  NDJSON or
                                              binary frame stream

            ``Accept: application/x-repro-binary`` (or ``?format=binary``,
            or a binary-framed request body) answers binary frames instead
            of JSON; responses come through the encoded-bytes LRU.  Unknown
            domains / artifact keys answer 404, malformed bodies (JSON or
            binary frame) 400 — both via ``_timed``'s exception mapping."""
            from repro_torch.serving import evaluate as ev

            binary = wire.wants_binary(self.headers.get("Accept"),
                                       self.path,
                                       self.headers.get("Content-Type"))
            body = self._read_body()
            evaluator = server.evaluator
            sweep = body.get("sweep")
            if sweep is not None:
                if not isinstance(sweep, dict):
                    raise ValueError("'sweep' must be a JSON object")
                self._evaluate_sweep(evaluator, sweep, binary)
                return
            queries = body.get("queries")
            if queries is not None and not isinstance(queries, list):
                raise ValueError("'queries' must be a list")
            if self._maybe_forward_evaluate(
                    body, [body] if queries is None else queries, binary):
                return
            blob = ev.encoded_batch_response(
                evaluator, server.eval_wire,
                [body] if queries is None else queries,
                single=queries is None, binary=binary)
            self._send_body(200, blob, wire.CONTENT_TYPE if binary
                            else "application/json")

        def _maybe_forward_evaluate(self, body: dict, queries: list,
                                    binary: bool) -> bool:
            """One-hop forward for artifact-key evaluates this node neither
            owns nor holds: the ring owner has the artifact resident (and
            its kernel launchers warm), so the hop beats a local 404.
            The owner's bytes and Content-Type are relayed *verbatim* —
            binary passthrough, a forwarded evaluate is never re-encoded.
            Domain-only queries (any node computes ground truth) and
            mixed-key batches serve locally."""
            cluster = server.cluster
            if cluster is None or self.headers.get(FORWARDED_HEADER):
                return False
            keys = {q.get("key") for q in queries if isinstance(q, dict)}
            keys.discard(None)
            if len(keys) != 1:
                return False
            key = keys.pop()
            if not isinstance(key, str) or not store_mod.valid_key(key):
                return False  # the evaluator raises the structured 400
            if cluster.owns(key):
                return False
            store = server.service.store
            if store is not None and key in store:
                return False  # resident locally: serve, don't hop
            candidates = cluster.replica_peers(key)
            accept = wire.CONTENT_TYPE if binary else "application/json"

            def hop(owner: str) -> tuple[int, bytes, str]:
                req = urllib.request.Request(
                    f"{owner}/v1/evaluate", data=json.dumps(body).encode(),
                    method="POST",
                    headers={"Content-Type": "application/json",
                             "Accept": accept,
                             FORWARDED_HEADER: "1",
                             **obs_trace.wire_headers()})
                try:
                    with obs_trace.span("forward_evaluate", owner=owner), \
                            urllib.request.urlopen(  # noqa: S310 — fleet URL
                                req, timeout=server.forward_timeout) as resp:
                        return (resp.status, resp.read(),
                                resp.headers.get("Content-Type")
                                or "application/json")
                except urllib.error.HTTPError as e:
                    return (e.code, e.read(),
                            e.headers.get("Content-Type")
                            or "application/json")

            def on_error(owner: str, exc: Exception) -> None:
                server.forward_errors += 1

            answer = server.router.dispatch(key, candidates, hop,
                                            on_error=on_error)
            if answer is None:
                return False  # every owner failed: serve (404) locally
            status, payload, ctype = answer
            server.forwarded += 1
            self._send_body(status, payload, ctype)
            return True

        def _evaluate_sweep(self, evaluator, sweep: dict,
                            binary: bool = False) -> None:
            """Streamed grid sweep: one result per (domain, n_points) cell
            as it resolves — NDJSON lines, or length-prefixed binary frames
            when negotiated.  Both framings are close-delimited (length
            unknowable up front)."""
            from repro_torch.serving import evaluate as ev

            domains = sweep.get("domains")
            sizes = sweep.get("sizes")
            if not isinstance(domains, list) or not domains:
                raise ValueError("'sweep.domains' must be a non-empty list")
            if not isinstance(sizes, list) or not sizes:
                raise ValueError("'sweep.sizes' must be a non-empty list")
            cells = evaluator.sweep(
                domains, sizes, tier=sweep.get("tier", "map"),
                block_n=sweep.get("block_n"),
                interpret=sweep.get("interpret"))
            if binary:
                ctype = wire.STREAM_CONTENT_TYPE

                def encode(res: dict) -> bytes:
                    return wire.stream_chunk(wire.encode_frame(res))
            else:
                ctype = "application/x-ndjson"

                def encode(res: dict) -> bytes:
                    return (json.dumps(ev.wire_result(res)) + "\n").encode()
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            # stream length unknowable up front: close-delimit (matches
            # /v1/grid; send_header flips close_connection)
            self.send_header("Connection", "close")
            self.end_headers()
            try:
                for res in cells:
                    self.wfile.write(encode(res))
                    self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                raise
            except Exception as e:  # noqa: BLE001 — headers are gone
                self.wfile.write(
                    encode({"error": f"{type(e).__name__}: {e}"}))

        def _artifact(self) -> None:
            key = self._key_from_path("/v1/artifact/")
            if key is None:
                return
            store = server.service.store
            if store is None:
                self._send_json(404, {"error": "server runs without a store "
                                               "(REPRO_ARTIFACT_CACHE=off)",
                                      "key": key})
                return
            # local tiers only: this is a cache-inspection endpoint, and a
            # miss must not cost an uncoalesced peer sweep per request —
            # peer read-through belongs to the coalesced derive path (and
            # the explicit /v1/replicate surface)
            rec = store.load(key, local_only=True)
            if rec is None:
                self._send_json(404, {"error": f"no record for key {key!r}",
                                      "key": key})
                return
            res = pipeline.result_from_record(rec, DOMAINS[rec["domain"]], key)
            art = res.artifact
            self._send_json(200, {
                "key": key,
                "record": rec,
                "artifact": art.to_record() if art is not None else None,
            })

        def _artifact_delete(self) -> None:
            key = self._key_from_path("/v1/artifact/")
            if key is None:
                return
            store = server.service.store
            if store is None:
                self._send_json(404, {"error": "server runs without a store "
                                               "(REPRO_ARTIFACT_CACHE=off)",
                                      "key": key})
                return
            # cached evaluate responses embedding this artifact's
            # coordinates must die with it
            server.eval_wire.invalidate_artifact(key)
            if store.delete(key):
                self._send_json(200, {"key": key, "deleted": True})
            else:
                self._send_json(404, {"error": f"no record for key {key!r}",
                                      "key": key})

        def _replicate_pull(self) -> None:
            """The raw local record for a sibling server's PeerStore.
            Local tiers only — peers asking each other can never recurse."""
            key = self._key_from_path("/v1/replicate/")
            if key is None:
                return
            store = server.service.store
            rec = store.load_local(key) if store is not None else None
            if rec is None:
                self._send_json(404, {"error": f"no record for key {key!r}",
                                      "key": key})
                return
            self._send_json(200, rec)

        def _replicate_push(self) -> None:
            """Accept a record a sibling just published (its write-back).
            Stored into the local tiers only — no push echo back out.  The
            envelope is verified before anything lands: a mismatched or
            missing checksum is a 400, same bytes DiskStore would
            quarantine on read — corruption must not enter via the wire."""
            key = self._key_from_path("/v1/replicate/")
            if key is None:
                return
            store = server.service.store
            if store is None:
                self._send_json(404, {"error": "server runs without a store "
                                               "(REPRO_ARTIFACT_CACHE=off)",
                                      "key": key})
                return
            rec = self._read_body()
            if not rec or "domain" not in rec:
                raise ValueError("replication push body must be a derivation "
                                 "record (JSON object with 'domain')")
            if not store_mod.verify_envelope(key, rec):
                raise ValueError(
                    "replication push rejected: record envelope must carry "
                    f"schema {store_mod.SCHEMA_VERSION}, the URL key, and a "
                    "matching payload checksum")
            store.store_local(key, rec)
            self._send_json(200, {"key": key, "stored": True})

        def _grid(self) -> None:
            body = self._read_body()

            def names(field):
                val = body.get(field)
                if val is None:
                    return None
                if not isinstance(val, list):
                    raise ValueError(f"{field!r} must be a list")
                return val

            domains, models, stages = (names("domains"), names("models"),
                                       names("stages"))
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            # the stream's length is unknowable up front: close-delimit this
            # one response (send_header flips close_connection for us)
            self.send_header("Connection", "close")
            self.end_headers()
            # stream one line per resolved cell; a mid-stream failure becomes
            # a terminal error line (headers are already gone)
            try:
                for res in server.service.run_grid(domains, models, stages):
                    line = json.dumps(pipeline.wire_from_result(res)) + "\n"
                    self.wfile.write(line.encode())
                    self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                raise
            except Exception as e:  # noqa: BLE001
                self.wfile.write(
                    (json.dumps({"error": f"{type(e).__name__}: {e}"}) +
                     "\n").encode())

    return Handler


def serve(service: MappingService | None = None, host: str = "127.0.0.1",
          port: int = 8000) -> MappingHTTPServer:
    """Boot a server in the calling thread (the CLI path)."""
    server = MappingHTTPServer(service or MappingService(), host, port)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.httpd.server_close()
    return server
