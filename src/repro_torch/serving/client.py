"""RemoteMappingService — the client half of the networked serving stack.

Same ``derive`` / ``run_grid`` / ``artifact`` / ``grid`` surface as the
in-process :class:`~repro_torch.serving.map_service.MappingService`, resolved over
HTTP against a :mod:`repro_torch.serving.http` server instead of a local pipeline.
Callers can therefore swap `MappingService()` for
`RemoteMappingService(url)` without touching anything downstream — results
rehydrate through the same wire schema the cache stores
(``pipeline.result_from_wire``), so a remote ``DerivationResult`` carries
the same artifact, report, and content address a local one would.

Transport: one pooled keep-alive ``http.client`` connection per host (and
per thread), so a hot derive costs a request/response on a warm socket
instead of a TCP handshake + connect per call.  A pooled socket that died
while idle (server restart, keep-alive reaped) reconnects once silently
before the normal retry/backoff machinery sees anything.  Constructing with
``keep_alive=False`` sends ``Connection: close`` per request — the
unpooled behavior, kept as a baseline.

Cluster awareness: against a sharded fleet (``--cluster-seed``), the client
fetches the ``GET /v1/cluster`` view once, builds the same weighted
placement the servers use (ring or rendezvous — the view says which), and —
as soon as a cell's content address is known from its first response —
hashes locally and sends repeat derives straight to the key's owners,
skipping the server-side forwarding hop.  Among the K owners it ranks by
its *own* observed per-host latency (EWMA, seeded by the view's advertised
queue depths) before the ring-order fallback, so a slow replica loses this
client's traffic without any server-side help.  Against a standalone
server (404 on /v1/cluster) all of this degrades to plain single-host
behavior.

Failure policy, in order:

  * transport errors (connection refused / reset / timeout) retry with
    exponential backoff up to ``retries`` times;
  * ``503`` (admission shed) and ``504`` (backend deadline blown) are
    retryable the same way — derivations are idempotent by content address,
    so a resend is always safe; when every retry ends on one of these the
    terminal error is *typed* (:class:`RemoteBusyError` /
    :class:`RemoteTimeoutError`, which are also ``LLMBusyError`` /
    ``LLMTimeoutError``) so callers branch without parsing messages;
  * other HTTP errors (400/404/500) raise :class:`RemoteServiceError`
    immediately — retrying a malformed or failing request won't help;
  * an owner-routed request whose owner is unreachable falls back to the
    configured home URL (and refreshes the cluster view);
  * when every attempt fails *and* a ``fallback`` service was provided, the
    request is served locally (graceful degradation: the client machine
    re-derives rather than erroring out, at local inference cost).
"""
from __future__ import annotations

import dataclasses
import http.client
import json
import threading
import time
from typing import Callable, Iterable, Iterator, Sequence
from urllib.parse import urlsplit

from repro_torch.core import pipeline
from repro_torch.core.artifact import MappingArtifact
from repro_torch.core.backends import LLMBusyError, LLMTimeoutError
from repro_torch.core.domains import Domain
from repro_torch.core.store import valid_key
from repro_torch.obs import trace as obs_trace
from repro_torch.serving.map_service import MappingService

#: 503 = admission shed (server asked us to back off); 504 = generation
#: deadline blown server-side — both are safe to resend because derivations
#: are idempotent by content address
_RETRYABLE_STATUS = (503, 504)
_TRANSPORT_ERRORS = (http.client.HTTPException, ConnectionError,
                     TimeoutError, OSError)


class RemoteServiceError(RuntimeError):
    """Terminal client-side failure (bad request, server fault, or transport
    failure with no fallback configured)."""

    def __init__(self, message: str, status: int | None = None):
        super().__init__(message)
        self.status = status


class RemoteBusyError(RemoteServiceError, LLMBusyError):
    """Every retry was answered 503: the server is persistently shedding.
    Doubly typed so ``except LLMBusyError`` works across the process
    boundary — the remote stack raises what the local stack would."""


class RemoteTimeoutError(RemoteServiceError, LLMTimeoutError):
    """Every retry was answered 504: the backend kept blowing its deadline.
    ``except LLMTimeoutError`` catches it, local or remote."""


def _exhausted_error(path: str, attempts: int, status: int | None,
                     last: Exception) -> RemoteServiceError:
    """The terminal error after retries run dry — typed by the last status
    so callers can branch on busy/timeout without parsing messages."""
    cls = {503: RemoteBusyError, 504: RemoteTimeoutError}.get(
        status or 0, RemoteServiceError)
    return cls(f"{path} unreachable after {attempts} attempts: {last}",
               status=status)


class _StatusError(Exception):
    """Internal: the server answered with a definite HTTP error status."""

    def __init__(self, status: int, reason: str, detail: str):
        super().__init__(f"HTTP {status}: {detail or reason}")
        self.status = status
        self.reason = reason
        self.detail = detail


def _falls_back(e: RemoteServiceError) -> bool:
    """Only server-absent / server-overloaded failures degrade to the local
    fallback; a definite HTTP answer (400/404/500) is the server speaking
    and must surface to the caller."""
    return e.status is None or e.status in _RETRYABLE_STATUS


@dataclasses.dataclass
class ClientStats:
    """Client-side counters (the remote complement of ServiceStats)."""

    remote_requests: int = 0   # HTTP calls that returned a result
    retries: int = 0           # extra attempts after a retryable failure
    fallbacks: int = 0         # requests served by the local fallback
    server_cache_hits: int = 0  # results the server marked cache_hit
    reconnects: int = 0        # pooled sockets found dead + reopened
    routed: int = 0            # requests sent straight to the ring owner
    reroutes: int = 0          # owner unreachable -> retried via home URL

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class _Response:
    """Keep-alive-aware response wrapper.  The connection is *checked out*
    of the pool for the response's whole lifetime (so a nested call made
    while a grid stream is suspended gets its own connection instead of
    clobbering the in-flight one); ``close`` checks a fully-drained
    response's connection back in, and drops an abandoned (mid-stream) or
    close-marked one — a half-read socket can never be reused."""

    def __init__(self, owner: "RemoteMappingService", netloc: str,
                 conn, resp):
        self._owner = owner
        self._netloc = netloc
        self._conn = conn
        self._resp = resp
        self._closed = False
        self.status = resp.status
        #: what the server actually sent — the client's binary-vs-JSON
        #: dispatch point (an old server ignores Accept and answers JSON)
        self.content_type = resp.getheader("Content-Type", "") or ""

    def read(self, amt: int | None = None) -> bytes:
        return self._resp.read() if amt is None else self._resp.read(amt)

    def readline(self) -> bytes:
        return self._resp.readline()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        resp = self._resp
        reusable = resp.isclosed() and not resp.will_close
        resp.close()
        if reusable:
            self._owner._checkin(self._netloc, self._conn)
        else:
            try:
                self._conn.close()
            except Exception:  # noqa: BLE001 — teardown is best-effort
                pass

    def __enter__(self) -> "_Response":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class RemoteMappingService:
    """MappingService surface over a remote derivation server."""

    def __init__(
        self,
        url: str,
        timeout: float = 60.0,
        retries: int = 3,
        backoff: float = 0.1,
        fallback: MappingService | Callable[[], MappingService] | None = None,
        keep_alive: bool = True,
        binary: bool = True,
    ):
        self.url = url.rstrip("/")
        self.timeout = timeout
        self.retries = retries
        self.backoff = backoff
        self.keep_alive = keep_alive
        #: negotiate the binary evaluate wire (Accept:
        #: application/x-repro-binary); an older server answers JSON and
        #: the client parses whatever Content-Type actually came back, so
        #: this is a preference, never a compatibility break
        self.binary = binary
        self.stats = ClientStats()
        self._fallback = fallback
        self._fallback_service: MappingService | None = None
        self._tls = threading.local()  # per-thread connection pool
        self._ring = None              # Placement once the view is fetched
        self._ring_checked = False     # 404 = standalone server: stay plain
        self._cell_keys: dict[tuple[str, str, int], str] = {}
        self._local_evaluator = None   # lazy EvaluationService fallback
        # client-side replica ranking: EWMA of *this client's* observed
        # per-host latency (no exploration — ring order is the tiebreak and
        # the fallback, so an unknown owner is simply tried in ring order)
        from repro_torch.serving.router import ReplicaSelector

        self._selector = ReplicaSelector(epsilon=0.0, seed=0)

    # -- connection pool ---------------------------------------------------
    def _conns(self) -> dict:
        conns = getattr(self._tls, "conns", None)
        if conns is None:
            conns = self._tls.conns = {}
        return conns

    def _checkout(self, netloc: str, scheme: str):
        """Take the pooled connection for ``netloc`` (or build a fresh one).
        Checked-out connections are owned by exactly one in-flight response
        — a concurrent/nested call finds the pool slot empty and gets its
        own connection instead of corrupting the stream in progress."""
        conn = self._conns().pop(netloc, None)
        if conn is None:
            cls = (http.client.HTTPSConnection if scheme == "https"
                   else http.client.HTTPConnection)
            conn = cls(netloc, timeout=self.timeout)
        return conn

    def _checkin(self, netloc: str, conn) -> None:
        conns = self._conns()
        if netloc in conns:  # a nested call repopulated the slot meanwhile
            try:
                conn.close()
            except Exception:  # noqa: BLE001 — teardown is best-effort
                pass
        else:
            conns[netloc] = conn

    def close(self) -> None:
        """Close this thread's pooled connections (other threads' pools are
        reaped when the client is collected)."""
        conns = self._conns()
        for netloc in list(conns):
            conn = conns.pop(netloc, None)
            try:
                conn.close()
            except Exception:  # noqa: BLE001 — teardown is best-effort
                pass

    # -- transport ---------------------------------------------------------
    def _request_once(self, base: str, method: str, path: str,
                      data: bytes | None, headers: dict) -> _Response:
        parts = urlsplit(base)
        netloc = parts.netloc
        conn = self._checkout(netloc, parts.scheme)
        pooled = conn.sock is not None
        try:
            conn.request(method, path, body=data, headers=headers)
            resp = conn.getresponse()
        except _TRANSPORT_ERRORS:
            try:
                conn.close()
            except Exception:  # noqa: BLE001
                pass
            if not pooled:
                raise  # a fresh connect failed: genuine transport failure
            # the pooled socket died while idle (keep-alive reaped, server
            # restarted): reconnect once before the retry/backoff machinery
            # hears about it — derives are idempotent, so a resend is safe
            self.stats.reconnects += 1
            conn = self._checkout(netloc, parts.scheme)
            try:
                conn.request(method, path, body=data, headers=headers)
                resp = conn.getresponse()
            except _TRANSPORT_ERRORS:
                try:
                    conn.close()
                except Exception:  # noqa: BLE001
                    pass
                raise
        return _Response(self, netloc, conn, resp)

    def _open(self, path: str, body: dict | None = None,
              method: str | None = None, base: str | None = None,
              headers: dict | None = None) -> _Response:
        data = json.dumps(body).encode() if body is not None else None
        all_headers = {"Content-Type": "application/json"} if data else {}
        # propagate the caller's active trace (no-op outside one); an
        # explicit per-call header (derive's trace_id) wins over it
        all_headers.update(obs_trace.wire_headers())
        if headers:
            all_headers.update(headers)
        if not self.keep_alive:
            all_headers["Connection"] = "close"
        method = method or ("POST" if data is not None else "GET")
        resp = self._request_once(base or self.url, method, path, data,
                                  all_headers)
        if resp.status >= 400:
            raw = resp.read()
            resp.close()
            detail = ""
            try:
                detail = json.loads(raw).get("error", "")
            except Exception:  # noqa: BLE001 — detail is best-effort
                pass
            raise _StatusError(resp.status, "", detail)
        return resp

    def _attempts(self, path: str, body: dict | None,
                  method: str | None = None,
                  base: str | None = None,
                  headers: dict | None = None) -> _Response:
        """Open a response, retrying transport/503 failures with backoff;
        raises the terminal error when attempts are exhausted."""
        last: Exception | None = None
        for attempt in range(self.retries + 1):
            if attempt:
                time.sleep(self.backoff * (2 ** (attempt - 1)))
                self.stats.retries += 1
            try:
                return self._open(path, body, method, base=base,
                                  headers=headers)
            except _StatusError as e:
                if e.status in _RETRYABLE_STATUS:
                    last = e
                    continue
                raise RemoteServiceError(
                    f"{path} -> {e}", status=e.status) from e
            except _TRANSPORT_ERRORS as e:
                last = e
                continue
        status = last.status if isinstance(last, _StatusError) else None
        raise _exhausted_error(path, self.retries + 1, status, last) from last

    def _call_json(self, path: str, body: dict | None = None,
                   method: str | None = None, base: str | None = None,
                   headers: dict | None = None) -> dict:
        with self._attempts(path, body, method, base=base,
                            headers=headers) as resp:
            payload = json.loads(resp.read())
        self.stats.remote_requests += 1
        return payload

    # -- cluster routing ---------------------------------------------------
    def _cluster_ring(self):
        """The fleet's hash ring, fetched lazily from ``GET /v1/cluster``
        (None against a standalone server).  Cached until an owner-routed
        request fails, which invalidates and refetches.  A definite 404 is
        remembered (the server *is* standalone); a transport failure is
        not — one restart blip must not disable owner routing for the
        client's whole lifetime."""
        if self._ring_checked:
            return self._ring
        self._ring_checked = True
        try:
            with self._open("/v1/cluster") as resp:
                view = json.loads(resp.read())
        except _StatusError:
            self._ring = None  # standalone node: stay plain, don't re-ask
            return None
        except (*_TRANSPORT_ERRORS, ValueError):
            self._ring = None
            self._ring_checked = False  # transient: retry on the next call
            return None
        from repro_torch.serving.cluster import (
            DEFAULT_REPLICAS, DEFAULT_VNODES, make_placement,
        )
        nodes = []
        for n in view.get("nodes", []):
            if not (isinstance(n, dict) and n.get("status") == "up"
                    and n.get("url")):
                continue
            nodes.append((n["url"], n.get("weight", 1.0)))
            # seed the latency ranking with the fleet's advertised queue
            # depths — useful before this client has observed anything
            self._selector.advertise(n["url"], n.get("load"))
        try:
            self._ring = make_placement(
                str(view.get("placement", "ring")), nodes,
                vnodes=int(view.get("vnodes", DEFAULT_VNODES)),
                replicas=int(view.get("replicas", DEFAULT_REPLICAS)))
        except ValueError:
            self._ring = None  # a placement this client doesn't speak:
            return None        # plain single-host behavior, still correct
        return self._ring

    def _invalidate_ring(self) -> None:
        self._ring = None
        self._ring_checked = False

    def _owner_urls(self, key: str | None) -> list[str]:
        """Where a request for ``key`` should land, best first: the key's
        K owners ranked by this client's own observed latency (ring order
        breaks ties and covers never-observed owners).  Empty when unknown
        / unclustered; a leading home URL means "don't route"."""
        if key is None:
            return []
        ring = self._cluster_ring()
        if ring is None:
            return []
        return self._selector.rank(ring.owners(key))

    def _call_routed(self, path: str, body: dict | None, key: str | None,
                     method: str | None = None,
                     headers: dict | None = None) -> dict:
        """``_call_json`` addressed to ``key``'s best ring owner when one
        is known, walking down the latency ranking and finally degrading to
        the home URL when every owner is unreachable — a definite answer
        from an owner (400/404/500) stands.  Every attempt's latency feeds
        the ranking, so a slowing replica loses this client's preference
        without any server-side help."""
        owners = self._owner_urls(key)
        if not owners or owners[0] == self.url:
            return self._call_json(path, body, method, headers=headers)
        for owner in owners:
            if owner == self.url:
                break  # the home URL is next-best: take the plain path
            t0 = time.monotonic()
            try:
                payload = self._call_json(path, body, method, base=owner,
                                          headers=headers)
            except RemoteServiceError as e:
                self._selector.observe(owner, time.monotonic() - t0,
                                       ok=False)
                if not _falls_back(e):
                    raise
                self.stats.reroutes += 1
                self._invalidate_ring()  # the view that routed us is stale
                continue                 # next-best owner, then home
            self._selector.observe(owner, time.monotonic() - t0)
            self.stats.routed += 1
            return payload
        return self._call_json(path, body, method, headers=headers)

    # -- fallback ----------------------------------------------------------
    def _local(self) -> MappingService | None:
        if self._fallback is None:
            return None
        if self._fallback_service is None:
            fb = self._fallback
            self._fallback_service = fb() if callable(fb) and not isinstance(
                fb, MappingService) else fb  # type: ignore[assignment]
        return self._fallback_service

    def _local_eval(self):
        """Local EvaluationService for evaluate fallback — enabled exactly
        when a derive ``fallback`` was configured (same degradation policy:
        the client machine computes rather than erroring out).  Artifact-key
        queries resolve against the fallback service's store."""
        if self._fallback is None:
            return None
        if self._local_evaluator is None:
            from repro_torch.serving.evaluate import EvaluationService

            local = self._local()
            self._local_evaluator = EvaluationService(
                artifact_resolver=local.artifact_for_key
                if local is not None else None)
        return self._local_evaluator

    # -- key validation ----------------------------------------------------
    def _require_key(self, key: str) -> None:
        """Fail fast on a malformed content address — the server would
        answer 400 anyway, so don't pay the round-trip to hear it."""
        if not valid_key(key):
            raise RemoteServiceError(
                f"invalid key {key!r}: content addresses are 64 lowercase "
                "hex characters", status=400)

    # -- MappingService surface --------------------------------------------
    def derive(self, domain: str | Domain, model: str, stage: int = 100,
               trace_id: str | None = None) -> pipeline.DerivationResult:
        name = domain.name if isinstance(domain, Domain) else domain
        cell = (name, model, stage)
        headers = {obs_trace.TRACE_HEADER: trace_id} if trace_id else None
        try:
            payload = self._call_routed(
                "/v1/derive", {"domain": name, "model": model,
                               "stage": stage},
                key=self._cell_keys.get(cell), headers=headers)
        except RemoteServiceError as e:
            local = self._local()
            if local is None or not _falls_back(e):
                raise
            self.stats.fallbacks += 1
            return local.derive(domain, model, stage)
        key = payload.get("key")
        if isinstance(key, str) and valid_key(key):
            # remember the cell's content address: repeats hash locally and
            # go straight to the owner, skipping the forwarding hop
            self._cell_keys[cell] = key
        res = pipeline.result_from_wire(payload)
        if res.cache_hit:
            self.stats.server_cache_hits += 1
        return res

    def artifact(self, domain: str | Domain, model: str,
                 stage: int = 100) -> MappingArtifact | None:
        return self.derive(domain, model, stage).artifact

    # -- evaluation (mapped coordinates over the wire) ---------------------
    def evaluate(self, domain: str | Domain | None = None, *,
                 key: str | None = None, tier: str = "map",
                 n_points: int | None = None, start: int = 0,
                 extent: Sequence[int] | None = None,
                 block_n: int | None = None,
                 interpret: bool | None = None) -> dict:
        """POST /v1/evaluate (single query): mapped coordinates for a
        λ-range (map tier) or a membership mask over a box (membership
        tier), computed by the server's cached-launcher hot path.
        Returns the result dict with ``coords``/``mask`` as numpy arrays.

        Transport policy is identical to :meth:`derive`: transport errors
        and 503 retry with backoff; with a ``fallback`` configured, a dead
        server degrades to local evaluation (same kernels, same bytes)."""
        query: dict = {"tier": tier}
        if key is not None:
            self._require_key(key)
            query["key"] = key
        elif domain is not None:
            query["domain"] = domain.name if isinstance(domain, Domain) \
                else domain
        else:
            raise ValueError("evaluate() needs 'domain' or 'key'")
        if n_points is not None:
            query["n_points"] = n_points
        if start:
            query["start"] = start
        if extent is not None:
            query["extent"] = list(extent)
        if block_n is not None:
            query["block_n"] = block_n
        if interpret is not None:
            query["interpret"] = interpret
        return self.evaluate_batch([query])[0]

    def evaluate_batch(self, queries: Sequence[dict]) -> list[dict]:
        """POST /v1/evaluate with a heterogeneous query batch: one HTTP
        round-trip, server-side executable grouping, results in query
        order (``coords``/``mask`` hydrated to numpy arrays).

        With ``binary=True`` (the default) the request carries ``Accept:
        application/x-repro-binary`` and a binary-speaking server answers
        raw little-endian frames, hydrated zero-copy via ``np.frombuffer``
        with the exact dtype/shape the server computed.  An older server
        ignores the header and answers JSON — detected from the response
        Content-Type, parsed through the unchanged JSON path."""
        from repro_torch.serving import evaluate as ev
        from repro_torch.serving import wire

        headers = {"Accept": wire.CONTENT_TYPE} if self.binary else None
        try:
            with self._attempts("/v1/evaluate", {"queries": list(queries)},
                                headers=headers) as resp:
                ctype = resp.content_type
                raw = resp.read()
        except RemoteServiceError as e:
            local = self._local_eval()
            if local is None or not _falls_back(e):
                raise
            self.stats.fallbacks += 1
            results, _ = local.evaluate_batch(list(queries))
            return results
        self.stats.remote_requests += 1
        if wire.is_binary(ctype):
            payload = wire.decode_frame(raw)
            if not isinstance(payload, dict):
                raise RemoteServiceError(
                    "/v1/evaluate answered a non-object binary frame")
            return list(payload.get("results", []))
        payload = json.loads(raw)
        return [ev.hydrate_result(r) for r in payload.get("results", [])]

    def evaluate_sweep(self, domains: Sequence[str], sizes: Sequence[int],
                       tier: str = "map", block_n: int | None = None,
                       interpret: bool | None = None) -> Iterator[dict]:
        """Streamed evaluation sweep over (domain × n_points): one hydrated
        result per stream cell, as the server resolves them (the /v1/grid
        close-delimited framing, applied to the evaluation plane).

        With ``binary=True`` the request asks for the length-prefixed
        binary frame stream and each cell hydrates via ``np.frombuffer``;
        an older server streams NDJSON instead, which the Content-Type
        check routes through the unchanged line parser."""
        from repro_torch.serving import evaluate as ev
        from repro_torch.serving import wire

        sweep: dict = {"domains": list(domains), "sizes": list(sizes),
                       "tier": tier}
        if block_n is not None:
            sweep["block_n"] = block_n
        if interpret is not None:
            sweep["interpret"] = interpret
        headers = {"Accept": wire.STREAM_CONTENT_TYPE} if self.binary \
            else None
        try:
            resp = self._attempts("/v1/evaluate", {"sweep": sweep},
                                  headers=headers)
        except RemoteServiceError as e:
            local = self._local_eval()
            if local is None or not _falls_back(e):
                raise
            self.stats.fallbacks += 1
            yield from local.sweep(domains, sizes, tier=tier,
                                   block_n=block_n, interpret=interpret)
            return
        with resp:
            self.stats.remote_requests += 1
            if wire.is_binary(resp.content_type):
                try:
                    for payload in wire.iter_stream(resp.read):
                        if isinstance(payload, dict) and "error" in payload \
                                and "tier" not in payload:
                            raise RemoteServiceError(
                                "/v1/evaluate failed mid-stream: "
                                f"{payload['error']}")
                        yield payload
                except _TRANSPORT_ERRORS as e:
                    raise RemoteServiceError(
                        f"/v1/evaluate stream broke mid-sweep: {e}") from e
                return
            while True:
                try:
                    raw = resp.readline()
                except _TRANSPORT_ERRORS as e:
                    raise RemoteServiceError(
                        f"/v1/evaluate stream broke mid-sweep: {e}") from e
                if not raw:
                    break
                line = raw.strip()
                if not line:
                    continue
                payload = json.loads(line)
                if "error" in payload and "tier" not in payload:
                    raise RemoteServiceError(
                        f"/v1/evaluate failed mid-stream: {payload['error']}")
                yield ev.hydrate_result(payload)

    def fetch_artifact(self, key: str) -> dict:
        """GET /v1/artifact/<key>: the raw {record, artifact} payload for a
        content address (no derivation is triggered)."""
        self._require_key(key)
        return self._call_json(f"/v1/artifact/{key}")

    def delete_artifact(self, key: str) -> dict:
        """DELETE /v1/artifact/<key>: drop one record from the server's
        local tiers (per-node ops action; peers keep their copies)."""
        self._require_key(key)
        return self._call_json(f"/v1/artifact/{key}", method="DELETE")

    def pull_record(self, key: str) -> dict:
        """GET /v1/replicate/<key>: the raw local record (the same surface
        PeerStore reads — memory/disk only, no peer recursion server-side)."""
        self._require_key(key)
        return self._call_json(f"/v1/replicate/{key}")

    def manifest(self) -> dict:
        """GET /v1/replicate/manifest: the server's local key manifest."""
        return self._call_json("/v1/replicate/manifest")

    def cluster_view(self) -> dict:
        """GET /v1/cluster: the server's membership view (404 -> error on a
        standalone node)."""
        return self._call_json("/v1/cluster")

    def store_stats(self) -> dict:
        """GET /v1/store/stats: per-tier counters + disk usage."""
        return self._call_json("/v1/store/stats")

    def run_grid(
        self,
        domains: Iterable[str | Domain] | None = None,
        models: Iterable[str] | None = None,
        stages: Sequence[int] | None = None,
    ) -> Iterator[pipeline.DerivationResult]:
        """Streamed sweep: one rehydrated result per NDJSON line, as the
        server resolves cells."""
        body = {}
        if domains is not None:
            body["domains"] = [d.name if isinstance(d, Domain) else d
                               for d in domains]
        if models is not None:
            body["models"] = list(models)
        if stages is not None:
            body["stages"] = list(stages)
        try:
            resp = self._attempts("/v1/grid", body)
        except RemoteServiceError as e:
            local = self._local()
            if local is None or not _falls_back(e):
                raise
            self.stats.fallbacks += 1
            yield from local.run_grid(domains, models, stages)
            return
        with resp:
            self.stats.remote_requests += 1
            while True:
                # wrap per-line reads so a server dying mid-stream surfaces
                # as the documented error type, not a raw socket exception
                try:
                    raw = resp.readline()
                except _TRANSPORT_ERRORS as e:
                    raise RemoteServiceError(
                        f"/v1/grid stream broke mid-sweep: {e}") from e
                if not raw:
                    break
                line = raw.strip()
                if not line:
                    continue
                payload = json.loads(line)
                if "error" in payload and "record" not in payload:
                    raise RemoteServiceError(
                        f"/v1/grid failed mid-stream: {payload['error']}")
                res = pipeline.result_from_wire(payload)
                if res.cache_hit:
                    self.stats.server_cache_hits += 1
                yield res

    def grid(self, domains=None, models=None, stages=None,
             ) -> dict[tuple[str, str, int], pipeline.DerivationResult]:
        return {(r.domain, r.model, r.stage): r
                for r in self.run_grid(domains, models, stages)}

    # -- server introspection ----------------------------------------------
    def healthy(self) -> bool:
        try:
            return self._call_json("/healthz").get("status") == "ok"
        except RemoteServiceError:
            return False

    def metrics(self) -> dict:
        """The server's /metrics payload (ServiceStats + latency + batching)."""
        return self._call_json("/metrics")

    def metrics_prometheus(self) -> str:
        """GET /metrics?format=prometheus: the text exposition."""
        with self._attempts("/metrics?format=prometheus", None) as resp:
            text = resp.read().decode()
        self.stats.remote_requests += 1
        return text

    def trace(self, trace_id: str, base: str | None = None) -> dict:
        """GET /v1/trace/<id>: one node's span shard of a request trace.
        ``base`` asks a specific fleet node (each node holds only the spans
        it executed); default is the home URL."""
        return self._call_json(f"/v1/trace/{trace_id}", base=base)

    def traces(self, base: str | None = None) -> dict:
        """GET /v1/traces: recent trace IDs + ring-buffer stats."""
        return self._call_json("/v1/traces", base=base)
