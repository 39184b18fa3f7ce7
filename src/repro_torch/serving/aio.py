"""Asyncio event-loop frontend for the MappingService — stdlib only.

The threaded frontend (``serving/http.py``) spends one OS thread per open
connection; at C10K-scale concurrency those threads are mostly parked on
socket reads, burning memory and scheduler time (the serving-tier analogue of
the paper's wasted GPU blocks).  :class:`AsyncMappingHTTPServer` serves the
same wire surface from a single event loop:

  * **hot path inline** — a derive whose cell is already resident resolves on
    the event loop itself via :meth:`MappingService.try_cached` (two dict
    lookups once warm) plus a wire-bytes LRU that skips re-serialization, so
    the common request costs no thread handoff at all;
  * **cold path offloaded** — pipeline runs, evaluation launches and
    forwarding hops execute on a bounded worker pool behind frontend
    admission control: past ``max_pending`` in-flight offloads the server
    sheds with 503 exactly like the threaded path's batching queue;
  * **backpressure-aware streaming** — /v1/grid and /v1/evaluate sweeps are
    *pull*-driven: the producer advances one cell per ``await drain()``, so a
    stalled reader pauses production at the write-buffer high-water mark
    (``stream_buffer_bytes``) instead of buffering the rest of the sweep, and
    never blocks other connections.

Route surface, status codes (via :func:`~repro_torch.serving.http.map_error`) and
the /metrics payload shape are identical to the threaded server, so the
pooled keep-alive client (``serving/client.py``) and the cluster fabric work
against either frontend unchanged.  Typed backend errors map to wire codes:
``LLMBusyError`` → 503 retryable, ``LLMTimeoutError`` → 504 retryable.
"""
from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import contextvars
import json
import socket
import threading
import time
import urllib.error
import urllib.request

from repro_torch.core import pipeline
from repro_torch.core import store as store_mod
from repro_torch.core.backends import LLMBusyError
from repro_torch.core.domains import DOMAINS
from repro_torch.obs import Observability
from repro_torch.obs import trace as obs_trace
from repro_torch.serving import wire
from repro_torch.serving.http import (
    FORWARDED_HEADER,
    MAX_BODY_BYTES,
    collect_metrics,
    map_error,
)
from repro_torch.serving.map_service import MappingService

_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    500: "Internal Server Error", 503: "Service Unavailable",
    504: "Gateway Timeout",
}

_SENTINEL = object()


def _head(status: int, content_type: str, length: int | None,
          close: bool, extra: dict | None = None) -> bytes:
    lines = [f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}",
             f"Content-Type: {content_type}"]
    if length is not None:
        lines.append(f"Content-Length: {length}")
    if extra:
        lines.extend(f"{name}: {value}" for name, value in extra.items())
    if close:
        lines.append("Connection: close")
    return ("\r\n".join(lines) + "\r\n\r\n").encode()


class _Conn:
    """One keep-alive connection's parsed-request context + reply helpers."""

    __slots__ = ("reader", "writer", "method", "path", "headers", "raw",
                 "keep_alive", "responded")

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self.method = ""
        self.path = ""
        self.headers: dict[str, str] = {}
        self.raw = b""
        self.keep_alive = True
        self.responded = False

    def body(self) -> dict:
        if not self.raw:
            return {}
        body = json.loads(self.raw)
        if not isinstance(body, dict):
            raise ValueError("request body must be a JSON object")
        return body

    async def send_bytes(self, status: int, body: bytes,
                         content_type: str = "application/json",
                         close: bool = False) -> None:
        if close:
            self.keep_alive = False
        self.responded = True
        # echo the active trace ID (set by _dispatch) back to the caller
        extra = obs_trace.wire_headers() or None
        self.writer.write(
            _head(status, content_type, len(body), close, extra) + body)
        await self.writer.drain()

    async def send_json(self, status: int, payload: dict,
                        close: bool = False) -> None:
        # default=str matches the store's serialization (see serving/http.py)
        body = json.dumps(payload, default=str).encode()
        if status >= 400 and self.raw:
            # error responses on keep-alive connections whose body might not
            # have been consumed close-delimit, mirroring the threaded server
            close = True
        await self.send_bytes(status, body, close=close)


class AsyncMappingHTTPServer:
    """Event-loop face of one MappingService.

    ``port=0`` binds an ephemeral port in ``__init__`` (read ``.port`` /
    ``.url`` immediately).  ``start()`` spins the loop in a daemon thread
    (the test/embedding shape); ``serve_forever()`` blocks the caller (the
    CLI shape).  Usable as a context manager.  ``async_backends`` is an
    optional list of ``AsyncLLMBackend`` instances whose lifecycle
    (``start``/``warm``/``health_check``/``close``) the server drives."""

    def __init__(self, service: MappingService, host: str = "127.0.0.1",
                 port: int = 0, max_workers: int = 16,
                 max_pending: int = 256, idle_timeout: float = 60.0,
                 stream_buffer_bytes: int = 256 * 1024,
                 stall_threshold: float = 0.25,
                 wire_cache_entries: int = 1024,
                 async_backends: list | None = None,
                 observability: bool = True,
                 router=None, serve_delay: float = 0.0):
        from repro_torch.serving.router import RequestRouter

        self.service = service
        self.cluster = None
        self.forwarded = 0
        self.forward_errors = 0
        self.forward_timeout = 30.0
        #: per-node scheduler + load-aware replica selector (see the
        #: threaded frontend — forwards go to the *best* owner)
        self.router = router if router is not None else RequestRouter()
        #: chaos/benchmark knob: delay every derive this long (an
        #: artificially slowed replica the selector must route around);
        #: awaited on the loop, so other connections keep being served
        self.serve_delay = max(0.0, float(serve_delay))
        self.obs = Observability(mode="async", enabled=observability)
        self.max_pending = max_pending
        self.idle_timeout = idle_timeout
        self.stream_buffer_bytes = stream_buffer_bytes
        self.stall_threshold = stall_threshold
        self.async_backends = list(async_backends or [])
        # frontend counters (the "aio" section of /metrics)
        self.fast_hits = 0        # derives served inline off try_cached
        self.wire_hits = 0        # ... without even re-serializing
        self.offloaded = 0        # requests that took the worker pool
        self.shed = 0             # 503s from frontend admission control
        self.stream_stalls = 0    # drains that exceeded stall_threshold
        self.connections = 0      # open connections right now
        self._pending = 0         # in-flight offloads (loop-thread only)
        self._wire_cache: "collections.OrderedDict[tuple, tuple[str, bytes]]" \
            = collections.OrderedDict()
        self._wire_cache_entries = wire_cache_entries
        #: encoded evaluate responses (binary or JSON), keyed by resolved
        #: executable group + λ-range — warm hits serve inline on the loop
        self.eval_wire = wire.WireCache(entries=wire_cache_entries)
        self.eval_wire_hits = 0   # evaluates served inline off eval_wire
        self._eval_served = False  # first evaluate (kernel build) completed
        self._evaluator = None
        self._evaluator_mu = threading.Lock()
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="aio-worker")
        # fleet-sized accept backlog, matching the threaded frontend's
        # _FleetHTTPServer: connection bursts must queue, not reset
        self._sock = socket.create_server((host, port), backlog=128,
                                          reuse_port=False)
        self.host = host
        self.port = self._sock.getsockname()[1]
        self.obs.node = self.url
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._started = threading.Event()
        self._stopping = False
        self._shutdown: asyncio.Event | None = None
        self._server: asyncio.AbstractServer | None = None
        self._writers: set[asyncio.StreamWriter] = set()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    @property
    def evaluator(self):
        with self._evaluator_mu:
            if self._evaluator is None:
                from repro_torch.serving.evaluate import EvaluationService

                self._evaluator = EvaluationService(
                    artifact_resolver=self.service.artifact_for_key)
            return self._evaluator

    def attach_cluster(self, cluster):
        """Join a sharded fleet — same wiring as the threaded server (ring
        into the peer tier, store to anti-entropy, heartbeats on)."""
        from repro_torch.core.store import PeerStore

        self.cluster = cluster
        store = self.service.store
        if store is not None:
            if store.peer is None:
                store.peer = PeerStore(router=cluster.replica_peers)
            else:
                store.peer.router = cluster.replica_peers
            cluster.store = store
        # load piggyback + selector feedback, same as the threaded server
        if cluster.load_provider is None:
            cluster.load_provider = self.router.load
        if cluster.on_load is None:
            cluster.on_load = self.router.advertise
        cluster.start()
        return cluster

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "AsyncMappingHTTPServer":
        self._thread = threading.Thread(
            target=self._run_loop, name="mapping-aio", daemon=True)
        self._thread.start()
        if not self._started.wait(timeout=30.0):
            raise RuntimeError("async server failed to start")
        return self

    def serve_forever(self) -> None:
        if self._thread is None:
            self.start()
        try:
            while self._thread is not None and self._thread.is_alive():
                self._thread.join(timeout=0.5)
        except KeyboardInterrupt:
            pass
        finally:
            self.close()

    def _run_loop(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        try:
            loop.run_until_complete(self._main())
        finally:
            loop.close()

    async def _main(self) -> None:
        self._shutdown = asyncio.Event()
        for backend in self.async_backends:
            await backend.start()
        self._server = await asyncio.start_server(
            self._handle, sock=self._sock)
        self._started.set()
        await self._shutdown.wait()
        self._server.close()
        # idle keep-alive connections first: since Python 3.12.1
        # wait_closed() also waits for every open connection to end
        for writer in list(self._writers):
            writer.close()
        await self._server.wait_closed()
        for backend in self.async_backends:
            try:
                await backend.close()
            except Exception:  # noqa: BLE001 — shutdown is best-effort
                pass
        # reap in-flight connection tasks so loop.close() is clean
        tasks = [t for t in asyncio.all_tasks()
                 if t is not asyncio.current_task()]
        for task in tasks:
            task.cancel()
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)

    async def warm(self, timeout_s: float = 120.0) -> None:
        for backend in self.async_backends:
            await backend.warm(timeout_s=timeout_s)

    def close(self) -> None:
        if self._stopping:
            return
        self._stopping = True
        if self.cluster is not None:
            self.cluster.close()
        loop, shutdown = self._loop, self._shutdown
        if loop is not None and shutdown is not None and loop.is_running():
            loop.call_soon_threadsafe(shutdown.set)
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._executor.shutdown(wait=False, cancel_futures=True)
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "AsyncMappingHTTPServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- metrics -----------------------------------------------------------
    def observe(self, endpoint: str, seconds: float, ok: bool) -> None:
        self.obs.observe(endpoint, seconds, ok)

    def metrics(self) -> dict:
        with self._evaluator_mu:
            evaluator = self._evaluator
        out = collect_metrics(
            self.service, self.obs.http_dict(), cluster=self.cluster,
            forwarded=self.forwarded, forward_errors=self.forward_errors,
            evaluator=evaluator, frontend=self.obs.frontend_dict(),
            router=self.router, eval_wire=self.eval_wire)
        # event-loop frontend counters ride inside the shared "frontend"
        # section (parity with the threaded server's key set) and stay
        # aliased at the legacy top-level "aio" key for existing consumers
        out["frontend"]["aio"] = out["aio"] = {
            "fast_hits": self.fast_hits,
            "wire_hits": self.wire_hits,
            "eval_wire_hits": self.eval_wire_hits,
            "offloaded": self.offloaded,
            "shed": self.shed,
            "stream_stalls": self.stream_stalls,
            "connections": self.connections,
            "pending": self._pending,
            "max_pending": self.max_pending,
        }
        return out

    def metrics_prometheus(self) -> str:
        """Prometheus text exposition of the same numbers (see the threaded
        server's ``metrics_prometheus``)."""
        return self.obs.prometheus(self.metrics())

    # -- offload with admission control -------------------------------------
    async def _offload(self, fn, *args, admitted: bool = True):
        """Run blocking work on the worker pool.  ``admitted=True`` paths
        count against ``max_pending`` and shed with LLMBusyError → 503 when
        the frontend is saturated (mirror of the batching queue's story).
        The call runs under a copy of the event loop's context so the
        active trace (a contextvar) survives the thread handoff —
        ``run_in_executor`` alone would drop it."""
        if admitted:
            if self._pending >= self.max_pending:
                self.shed += 1
                raise LLMBusyError(
                    f"async frontend at capacity ({self.max_pending} "
                    f"requests in flight)")
            self._pending += 1
            self.offloaded += 1
        ctx = contextvars.copy_context()
        try:
            return await asyncio.get_running_loop().run_in_executor(
                self._executor, ctx.run, fn, *args)
        finally:
            if admitted:
                self._pending -= 1

    # -- wire-bytes hot cache ------------------------------------------------
    def _wire_get(self, cell: tuple) -> bytes | None:
        hit = self._wire_cache.get(cell)
        if hit is None:
            return None
        self._wire_cache.move_to_end(cell)
        return hit[1]

    def _wire_put(self, cell: tuple, key: str, blob: bytes) -> None:
        self._wire_cache[cell] = (key, blob)
        self._wire_cache.move_to_end(cell)
        while len(self._wire_cache) > self._wire_cache_entries:
            self._wire_cache.popitem(last=False)

    def _wire_invalidate(self, key: str) -> None:
        stale = [cell for cell, (k, _) in self._wire_cache.items()
                 if k == key]
        for cell in stale:
            self._wire_cache.pop(cell, None)

    # -- connection handling -------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        transport = writer.transport
        if transport is not None:
            # the backpressure knob: drain() blocks once this much response
            # is unsent, pausing the producer for that one connection
            transport.set_write_buffer_limits(high=self.stream_buffer_bytes)
        self._writers.add(writer)
        self.connections += 1
        try:
            while not self._stopping:
                conn = _Conn(reader, writer)
                try:
                    blob = await asyncio.wait_for(
                        reader.readuntil(b"\r\n\r\n"), self.idle_timeout)
                except (asyncio.IncompleteReadError, ConnectionResetError,
                        asyncio.TimeoutError, TimeoutError):
                    break  # client closed or went idle past the reaper
                except asyncio.LimitOverrunError:
                    await conn.send_json(
                        400, {"error": "request header block too large"},
                        close=True)
                    break
                if not self._parse(conn, blob):
                    await conn.send_json(
                        400, {"error": "malformed request line"}, close=True)
                    break
                try:
                    length = int(conn.headers.get("content-length") or 0)
                except ValueError:
                    length = 0
                if length > MAX_BODY_BYTES:
                    await conn.send_json(400, {
                        "error": f"request body too large ({length} bytes)",
                    }, close=True)
                    break
                if length:
                    try:
                        conn.raw = await asyncio.wait_for(
                            reader.readexactly(length), self.idle_timeout)
                    except (asyncio.IncompleteReadError,
                            ConnectionResetError, asyncio.TimeoutError,
                            TimeoutError):
                        break
                await self._dispatch(conn)
                if not conn.keep_alive:
                    break
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            self._writers.discard(writer)
            self.connections -= 1
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError, OSError):
                pass

    @staticmethod
    def _parse(conn: _Conn, blob: bytes) -> bool:
        try:
            head = blob.decode("latin-1")
        except UnicodeDecodeError:
            return False
        lines = head.split("\r\n")
        parts = lines[0].split()
        if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
            return False
        conn.method, conn.path, version = parts
        for line in lines[1:]:
            if not line:
                continue
            name, sep, value = line.partition(":")
            if sep:
                conn.headers[name.strip().lower()] = value.strip()
        wants_close = conn.headers.get("connection", "").lower() == "close"
        conn.keep_alive = version == "HTTP/1.1" and not wants_close
        return True

    async def _dispatch(self, conn: _Conn) -> None:
        endpoint, handler = self._route(conn)
        # activate the request trace on this task's context: handlers (and
        # context-copied offloads) record spans under it, send_bytes echoes
        # the ID, end_request records the request-level span + deactivates
        token = self.obs.begin_request(
            conn.headers.get(obs_trace.TRACE_HEADER.lower()))
        t0 = time.monotonic()
        ok = True
        try:
            await handler(conn)
        except (BrokenPipeError, ConnectionResetError):
            ok = False
            conn.keep_alive = False
        except Exception as e:  # noqa: BLE001 — surface, don't kill the loop
            ok = False
            status, payload = map_error(e)
            if not conn.responded:
                try:
                    await conn.send_json(status, payload)
                except (BrokenPipeError, ConnectionResetError):
                    conn.keep_alive = False
            else:
                conn.keep_alive = False
        finally:
            seconds = time.monotonic() - t0
            self.observe(endpoint, seconds, ok)
            self.obs.end_request(token, endpoint, seconds, ok)

    def _route(self, conn: _Conn):
        method, path = conn.method, conn.path
        if method == "GET":
            if path == "/healthz":
                return "healthz", self._healthz
            if path == "/metrics" or path.startswith("/metrics?"):
                return "metrics", self._metrics_route
            if path == "/v1/traces":
                return "traces", self._traces_route
            if path.startswith("/v1/trace/"):
                return "trace", self._trace_route
            if path == "/v1/store/stats":
                return "store_stats", self._store_stats
            if path == "/v1/cluster" or path.startswith("/v1/cluster?"):
                return "cluster", self._cluster_view
            if path == "/v1/replicate/manifest":
                return "manifest", self._manifest
            if path.startswith("/v1/artifact/"):
                return "artifact", self._artifact
            if path.startswith("/v1/replicate/"):
                return "replicate_pull", self._replicate_pull
        elif method == "POST":
            if path == "/v1/derive":
                return "derive", self._derive
            if path == "/v1/evaluate" or path.startswith("/v1/evaluate?"):
                return "evaluate", self._evaluate
            if path == "/v1/grid":
                return "grid", self._grid
            if path.startswith("/v1/replicate/"):
                return "replicate_push", self._replicate_push
        elif method == "DELETE":
            if path.startswith("/v1/artifact/"):
                return "artifact_delete", self._artifact_delete
        return "unknown", self._not_found

    async def _not_found(self, conn: _Conn) -> None:
        await conn.send_json(404, {"error": f"no route {conn.path!r}"})

    # -- endpoints -----------------------------------------------------------
    async def _healthz(self, conn: _Conn) -> None:
        store = self.service.store
        peers = getattr(getattr(store, "peer", None), "peers", [])
        payload = {
            "status": "ok",
            "store": store is not None,
            "peers": len(peers),
            "domains": len(DOMAINS),
            "loop": "asyncio",
            "mode": self.obs.mode,
            "uptime_seconds": self.obs.uptime_seconds(),
            "started_unix": self.obs.started_unix,
            "backend_names": sorted(self.service.backends()),
            # advertised load, same numbers the cluster view piggybacks
            "load": self.router.load(),
        }
        if self.cluster is not None:
            payload["cluster_nodes_up"] = len(self.cluster.live_peers()) + 1
        if self.async_backends:
            checks = await asyncio.gather(
                *(b.health_check() for b in self.async_backends),
                return_exceptions=True)
            payload["backends"] = {
                b.name: c is True
                for b, c in zip(self.async_backends, checks)}
        await conn.send_json(200, payload)

    async def _metrics_route(self, conn: _Conn) -> None:
        from urllib.parse import parse_qs, urlsplit

        fmt = parse_qs(urlsplit(conn.path).query).get("format", [""])[0]
        if fmt == "prometheus":
            text = await self._offload(self.metrics_prometheus,
                                       admitted=False)
            await conn.send_bytes(
                200, text.encode(),
                content_type="text/plain; version=0.0.4")
            return
        await conn.send_json(200, self.metrics())

    async def _traces_route(self, conn: _Conn) -> None:
        await conn.send_json(200, self.obs.traces_payload())

    async def _trace_route(self, conn: _Conn) -> None:
        trace_id = conn.path[len("/v1/trace/"):]
        payload = self.obs.trace_payload(trace_id)
        if payload is None:
            await conn.send_json(404, {
                "error": f"no trace {trace_id!r} on this node",
                "trace_id": trace_id})
            return
        await conn.send_json(200, payload)

    async def _store_stats(self, conn: _Conn) -> None:
        def build() -> dict:
            store = self.service.store
            if store is None:
                payload = {"store": None}
            else:
                payload = {"store": store.stats(), "usage": store.usage()}
            if self.cluster is not None:
                payload["cluster"] = {**self.cluster.stats(),
                                      "forwarded": self.forwarded,
                                      "forward_errors": self.forward_errors}
            with self._evaluator_mu:
                evaluator = self._evaluator
            if evaluator is not None and evaluator.cache is not None:
                payload["compile_cache"] = evaluator.cache.stats_dict()
            return payload

        await conn.send_json(200, await self._offload(build, admitted=False))

    async def _cluster_view(self, conn: _Conn) -> None:
        from urllib.parse import parse_qs, urlsplit

        if self.cluster is None:
            await conn.send_json(404, {"error": "node runs standalone "
                                                "(no --cluster-seed)"})
            return
        query = urlsplit(conn.path).query
        announced = parse_qs(query).get("from", [""])[0]
        if announced:
            self.cluster.observe(announced)
        await conn.send_json(200, self.cluster.view())

    async def _manifest(self, conn: _Conn) -> None:
        store = self.service.store
        keys = await self._offload(store.keys, admitted=False) \
            if store is not None else []
        await conn.send_json(200, {"keys": keys, "count": len(keys)})

    def _key_from_path(self, conn: _Conn, prefix: str) -> str | None:
        key = conn.path[len(prefix):]
        if not store_mod.valid_key(key):
            return None
        return key

    async def _bad_key(self, conn: _Conn, key: str) -> None:
        await conn.send_json(400, {
            "error": "invalid key: content addresses are 64 lowercase hex "
                     "characters",
            "key": key})

    async def _artifact(self, conn: _Conn) -> None:
        key = self._key_from_path(conn, "/v1/artifact/")
        if key is None:
            await self._bad_key(conn, conn.path[len("/v1/artifact/"):])
            return
        store = self.service.store
        if store is None:
            await conn.send_json(404, {
                "error": "server runs without a store "
                         "(REPRO_ARTIFACT_CACHE=off)", "key": key})
            return
        rec = await self._offload(
            lambda: store.load(key, local_only=True), admitted=False)
        if rec is None:
            await conn.send_json(404, {
                "error": f"no record for key {key!r}", "key": key})
            return
        res = pipeline.result_from_record(rec, DOMAINS[rec["domain"]], key)
        art = res.artifact
        await conn.send_json(200, {
            "key": key,
            "record": rec,
            "artifact": art.to_record() if art is not None else None,
        })

    async def _artifact_delete(self, conn: _Conn) -> None:
        key = self._key_from_path(conn, "/v1/artifact/")
        if key is None:
            await self._bad_key(conn, conn.path[len("/v1/artifact/"):])
            return
        store = self.service.store
        if store is None:
            await conn.send_json(404, {
                "error": "server runs without a store "
                         "(REPRO_ARTIFACT_CACHE=off)", "key": key})
            return
        self._wire_invalidate(key)
        # cached evaluate responses embedding this artifact die with it
        self.eval_wire.invalidate_artifact(key)
        if await self._offload(store.delete, key, admitted=False):
            await conn.send_json(200, {"key": key, "deleted": True})
        else:
            await conn.send_json(404, {
                "error": f"no record for key {key!r}", "key": key})

    async def _replicate_pull(self, conn: _Conn) -> None:
        key = self._key_from_path(conn, "/v1/replicate/")
        if key is None:
            await self._bad_key(conn, conn.path[len("/v1/replicate/"):])
            return
        store = self.service.store
        rec = await self._offload(store.load_local, key, admitted=False) \
            if store is not None else None
        if rec is None:
            await conn.send_json(404, {
                "error": f"no record for key {key!r}", "key": key})
            return
        await conn.send_json(200, rec)

    async def _replicate_push(self, conn: _Conn) -> None:
        key = self._key_from_path(conn, "/v1/replicate/")
        if key is None:
            await self._bad_key(conn, conn.path[len("/v1/replicate/"):])
            return
        store = self.service.store
        if store is None:
            await conn.send_json(404, {
                "error": "server runs without a store "
                         "(REPRO_ARTIFACT_CACHE=off)", "key": key})
            return
        rec = conn.body()
        if not rec or "domain" not in rec:
            raise ValueError("replication push body must be a derivation "
                             "record (JSON object with 'domain')")
        if not store_mod.verify_envelope(key, rec):
            raise ValueError(
                "replication push rejected: record envelope must carry "
                f"schema {store_mod.SCHEMA_VERSION}, the URL key, and a "
                "matching payload checksum")
        await self._offload(store.store_local, key, rec, admitted=False)
        await conn.send_json(200, {"key": key, "stored": True})

    # -- derive --------------------------------------------------------------
    @staticmethod
    def _derive_cell(body: dict) -> tuple[str, str, int]:
        domain = body.get("domain")
        model = body.get("model")
        if not isinstance(domain, str) or not isinstance(model, str):
            raise ValueError("body must carry string 'domain' and 'model'")
        stage = body.get("stage", 100)
        if not isinstance(stage, int) or isinstance(stage, bool):
            raise ValueError("'stage' must be an integer")
        return domain, model, stage

    async def _derive(self, conn: _Conn) -> None:
        body = conn.body()
        domain, model, stage = self._derive_cell(body)
        cell = (domain, model, stage)
        if self.serve_delay > 0:  # chaos knob: a slowed replica — awaited,
            await asyncio.sleep(self.serve_delay)  # other conns unaffected
        # hot path, entirely on the event loop: memoized content address +
        # memory-tier result + cached wire bytes — no thread handoff
        res = self.service.try_cached(domain, model, stage)
        if res is not None:
            self.fast_hits += 1
            blob = self._wire_get(cell)
            if blob is not None:
                self.wire_hits += 1
            else:
                blob = json.dumps(
                    pipeline.wire_from_result(res), default=str).encode()
                self._wire_put(cell, res.cache_key or "", blob)
            await conn.send_bytes(200, blob)
            return
        if await self._maybe_forward(conn, body, domain, model, stage):
            return
        # cold path: pipeline run on the worker pool behind admission
        # control.  The fresh response is NOT wire-cached: its payload says
        # cache_hit=false, which is only true once — repeats take the
        # try_cached path above and cache the truthful rehydrated bytes.
        def run() -> bytes:
            with self.router.track():
                r = self.service.derive(domain, model, stage)
            return json.dumps(
                pipeline.wire_from_result(r), default=str).encode()

        blob = await self._offload(run)
        await conn.send_bytes(200, blob)

    async def _maybe_forward(self, conn: _Conn, body: dict, domain: str,
                             model: str, stage: int) -> bool:
        """One-hop ownership forwarding, same policy as the threaded server
        (serve locally when resident or owned; degrade to local derivation
        when every replica is unreachable).  Owner order comes from the
        router's replica selector; the blocking hop runs on the worker pool
        under admission control — a slow owner consumes one offload slot,
        never the event loop."""
        cluster = self.cluster
        if cluster is None or conn.headers.get(FORWARDED_HEADER.lower()):
            return False
        key = await self._offload(
            self.service.request_key, domain, model, stage, admitted=False)
        if cluster.owns(key):
            return False
        store = self.service.store
        if store is not None and key in store:
            return False
        candidates = cluster.replica_peers(key)

        def attempt(owner: str) -> tuple[int, bytes]:
            req = urllib.request.Request(
                f"{owner}/v1/derive", data=json.dumps(body).encode(),
                method="POST",
                headers={"Content-Type": "application/json",
                         FORWARDED_HEADER: "1",
                         **obs_trace.wire_headers()})
            try:
                with obs_trace.span("forward", owner=owner), \
                        urllib.request.urlopen(  # noqa: S310 — fleet URL
                            req, timeout=self.forward_timeout) as resp:
                    return resp.status, resp.read()
            except urllib.error.HTTPError as e:
                return e.code, e.read()  # the owner answered: relay verdict

        def on_error(owner: str, exc: Exception) -> None:
            self.forward_errors += 1

        def hop() -> tuple[int, bytes] | None:
            with obs_trace.span("route_decision", key=key[:16],
                                candidates=len(candidates),
                                policy=self.router.policy) as span:
                answer = self.router.dispatch(key, candidates, attempt,
                                              on_error=on_error)
                span["forwarded"] = answer is not None
            return answer

        relayed = await self._offload(hop)
        if relayed is None:
            return False
        self.forwarded += 1
        status, payload = relayed
        await conn.send_bytes(status, payload)
        return True

    # -- evaluate ------------------------------------------------------------
    async def _evaluate(self, conn: _Conn) -> None:
        from repro_torch.serving import evaluate as ev

        ctype = conn.headers.get("content-type")
        if wire.is_binary(ctype):
            # binary-framed request body: WireFormatError (a ValueError)
            # surfaces as a structured 400 through _dispatch's map_error
            body = wire.decode_request(conn.raw)
        else:
            body = conn.body()
        binary = wire.wants_binary(conn.headers.get("accept"),
                                   conn.path, ctype)
        evaluator = self.evaluator
        sweep = body.get("sweep")
        if sweep is not None:
            if not isinstance(sweep, dict):
                raise ValueError("'sweep' must be a JSON object")
            await self._evaluate_sweep(conn, evaluator, sweep, binary)
            return
        queries = body.get("queries")
        if queries is not None and not isinstance(queries, list):
            raise ValueError("'queries' must be a list")
        single = queries is None
        batch = [body] if single else queries
        response_type = wire.CONTENT_TYPE if binary else "application/json"
        # hot path, entirely on the event loop: once the batch's executable
        # identity is resolvable (dict lookups + arithmetic when the
        # artifact store is warm), a cached encoded response sends with no
        # thread handoff and no re-serialization — the evaluate analogue of
        # the derive fast path above.  Gated on one completed evaluate:
        # the first one may nvcc-build the kernel libraries, and that
        # multi-second build belongs on the worker pool, not the loop.
        if self._eval_served:
            identity = evaluator.batch_cache_key(batch)
            if identity is not None:
                cell = ("bin" if binary else "json",
                        "single" if single else "batch", identity[0])
                blob = self.eval_wire.get(cell,
                                          evaluator.cache_generation())
                if blob is not None:
                    self.eval_wire_hits += 1
                    await conn.send_bytes(200, blob,
                                          content_type=response_type)
                    return
        if await self._maybe_forward_evaluate(conn, body, batch, binary):
            return
        blob = await self._offload(
            lambda: ev.encoded_batch_response(
                evaluator, self.eval_wire, batch,
                single=single, binary=binary))
        self._eval_served = True
        await conn.send_bytes(200, blob, content_type=response_type)

    async def _maybe_forward_evaluate(self, conn: _Conn, body: dict,
                                      queries: list, binary: bool) -> bool:
        """One-hop forward for artifact-key evaluates this node neither
        owns nor holds (the owner has the artifact and its launchers
        warm).  The owner's bytes and Content-Type relay verbatim — binary
        passthrough, never re-encoded.  Same policy as the threaded
        frontend; the blocking hop rides the worker pool."""
        cluster = self.cluster
        if cluster is None or conn.headers.get(FORWARDED_HEADER.lower()):
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
        store = self.service.store
        if store is not None and key in store:
            return False
        candidates = cluster.replica_peers(key)
        accept = wire.CONTENT_TYPE if binary else "application/json"

        def attempt(owner: str) -> tuple[int, bytes, str]:
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
                            req, timeout=self.forward_timeout) as resp:
                    return (resp.status, resp.read(),
                            resp.headers.get("Content-Type")
                            or "application/json")
            except urllib.error.HTTPError as e:
                return (e.code, e.read(),
                        e.headers.get("Content-Type") or "application/json")

        def on_error(owner: str, exc: Exception) -> None:
            self.forward_errors += 1

        def hop() -> tuple[int, bytes, str] | None:
            return self.router.dispatch(key, candidates, attempt,
                                        on_error=on_error)

        relayed = await self._offload(hop)
        if relayed is None:
            return False  # every owner failed: serve (404) locally
        self.forwarded += 1
        status, payload, ctype = relayed
        await conn.send_bytes(status, payload, content_type=ctype)
        return True

    async def _evaluate_sweep(self, conn: _Conn, evaluator,
                              sweep: dict, binary: bool = False) -> None:
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
            await self._stream(
                conn, cells,
                lambda res: wire.stream_chunk(wire.encode_frame(res)),
                wire.STREAM_CONTENT_TYPE)
            return
        await self._stream_ndjson(conn, cells, ev.wire_result)

    # -- streaming -----------------------------------------------------------
    async def _grid(self, conn: _Conn) -> None:
        body = conn.body()

        def names(field):
            val = body.get(field)
            if val is None:
                return None
            if not isinstance(val, list):
                raise ValueError(f"{field!r} must be a list")
            return val

        domains, models, stages = (names("domains"), names("models"),
                                   names("stages"))
        cells = self.service.run_grid(domains, models, stages)
        await self._stream_ndjson(conn, cells, pipeline.wire_from_result)

    async def _stream_ndjson(self, conn: _Conn, cells, wire_fn) -> None:
        await self._stream(
            conn, cells,
            lambda res: (json.dumps(wire_fn(res)) + "\n").encode(),
            "application/x-ndjson")

    async def _stream(self, conn: _Conn, cells, encode,
                      content_type: str) -> None:
        """Pull-driven close-delimited stream with real backpressure:
        the producer (a blocking generator) is advanced one cell per loop
        turn on the worker pool, and each cell's bytes (an NDJSON line or
        a length-prefixed binary frame — ``encode`` decides) are followed
        by ``await drain()`` — once a slow reader's write buffer passes
        the high-water mark, production for *that* connection pauses until
        the client reads.  Other connections keep being served; nothing is
        buffered beyond the transport's ``stream_buffer_bytes``."""
        conn.responded = True
        conn.keep_alive = False  # length unknowable: close-delimited
        conn.writer.write(_head(200, content_type, None, True))
        loop = asyncio.get_running_loop()
        stalled = False
        # one context snapshot for the whole stream: every generator step
        # runs under the request's trace regardless of which pool thread
        # picks it up
        ctx = contextvars.copy_context()
        try:
            while True:
                res = await loop.run_in_executor(
                    self._executor, ctx.run, next, cells, _SENTINEL)
                if res is _SENTINEL:
                    break
                conn.writer.write(encode(res))
                t0 = time.monotonic()
                await conn.writer.drain()  # the backpressure point
                if not stalled and \
                        time.monotonic() - t0 > self.stall_threshold:
                    stalled = True
                    self.stream_stalls += 1
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away mid-stream: stop producing
        except Exception as e:  # noqa: BLE001 — headers are gone
            try:
                conn.writer.write(
                    encode({"error": f"{type(e).__name__}: {e}"}))
                await conn.writer.drain()
            except (BrokenPipeError, ConnectionResetError):
                pass


def serve(service: MappingService | None = None, host: str = "127.0.0.1",
          port: int = 8000, **kw) -> AsyncMappingHTTPServer:
    """Boot an async server and block the calling thread (the CLI path)."""
    server = AsyncMappingHTTPServer(service or MappingService(), host, port,
                                    **kw)
    server.serve_forever()
    return server
