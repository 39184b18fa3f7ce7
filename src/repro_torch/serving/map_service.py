"""MappingService — the many-clients front end of the derivation pipeline.

The paper's economics hinge on one-time derivation amortized across many GPU
workloads; this service makes the "many clients share one artifact store"
scenario safe and cheap:

  * process-safety — writers serialize per content address through the
    store's ``FileLock`` (atomic-rename publish keeps readers lock-free, and
    stale locks from crashed holders are broken after a threshold), so two
    *processes* deriving the same cell yield one derivation + one record;
  * request coalescing — an in-flight table keyed by the cell's content
    address means N concurrent *threads* asking for the same (domain, model,
    stage) trigger exactly one pipeline run and all receive the shared
    ``DerivationResult``;
  * streaming sweeps — ``run_grid`` yields each cell's result as soon as it
    resolves (cache hit or fresh derivation) instead of buffering the whole
    (domain x model x stage) grid.

The service composes the pipeline's stage functions (``prepare_request`` /
``run_stages``) rather than reimplementing them, so the served path and the
local ``derive_mapping`` path share one content-address scheme by
construction.  ``REPRO_ARTIFACT_CACHE=off`` degrades the service to
coalescing-only: concurrent requests for one cell still share a single
derivation, but nothing persists, so sequential repeats re-derive.

Storage is the tiered :class:`~repro_torch.core.store.TieredStore` (memory LRU ->
checksummed disk with TTL/size eviction -> peer replication): a hot hit
resolves from the memory tier with no disk read and no JSON parse, and once
a result has been rehydrated it is remembered on the entry so repeats skip
dataclass reconstruction too.  A bare disk-level store passed as ``store=``
(or the legacy ``cache=``) gains a memory tier automatically.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Iterable, Iterator, Sequence

import numpy as np

from repro_torch.core import pipeline
from repro_torch.core.artifact import MappingArtifact
from repro_torch.core.backends import LLMBackend, MockLLMBackend
from repro_torch.core.domains import DOMAINS, Domain
from repro_torch.core.store import (
    ArtifactStore, as_tiered, default_store, finalize_record,
)
from repro_torch.obs import trace as obs_trace

_USE_DEFAULT_CACHE = object()


@dataclasses.dataclass
class ServiceStats:
    """Operational counters: where each served request was resolved.

    This is the one stats surface shared by the in-process path and the HTTP
    path — ``MappingService.stats`` mutates it under the service lock, and
    ``GET /metrics`` publishes a :meth:`snapshot` of the same object, so the
    two views can never drift."""

    requests: int = 0        # derive() calls admitted (any resolution)
    derivations: int = 0     # pipeline actually ran (this process was leader)
    cache_hits: int = 0      # resolved from the shared artifact store
    coalesced: int = 0       # piggybacked on another thread's in-flight run
    errors: int = 0          # derive() raised (pipeline/backend/lock failure)
    stale_locks_broken: int = 0

    @property
    def cache_hit_ratio(self) -> float:
        """Fraction of admitted requests served without running the pipeline
        in this thread (store hits + coalesced waits)."""
        if self.requests == 0:
            return 0.0
        return (self.cache_hits + self.coalesced) / self.requests

    def snapshot(self) -> "ServiceStats":
        return dataclasses.replace(self)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["cache_hit_ratio"] = self.cache_hit_ratio
        return d


class _InFlight:
    """One in-progress derivation: followers wait on the event and share the
    leader's result (or its exception)."""

    __slots__ = ("event", "result", "error")

    def __init__(self):
        self.event = threading.Event()
        self.result: pipeline.DerivationResult | None = None
        self.error: BaseException | None = None


class MappingService:
    """Concurrency-safe artifact serving for (domain, model, stage) cells.

    One instance per process is the intended shape — its in-flight table
    coalesces threads, while the file lock in the artifact store coordinates
    across processes sharing the same cache root."""

    def __init__(
        self,
        store: ArtifactStore | None = _USE_DEFAULT_CACHE,  # type: ignore[assignment]
        backend_factory: Callable[[str], LLMBackend] = MockLLMBackend,
        n_validate: int = 100_000,
        sample_every: int = 50,
        lock_timeout: float = 300.0,
        stale_lock_seconds: float = 60.0,
        memory_entries: int = 256,
        cache: ArtifactStore | None = _USE_DEFAULT_CACHE,  # type: ignore[assignment]
    ):
        # lock_timeout bounds how long a follower process waits on a *live*
        # leader (whose heartbeat keeps the lock fresh) — it must comfortably
        # exceed a worst-case derivation, not a worst-case crash
        # (stale_lock_seconds covers crashes).
        if store is _USE_DEFAULT_CACHE:
            store = cache  # legacy keyword (older call sites)
        if store is _USE_DEFAULT_CACHE:
            store = default_store()
        # normalize to the tiered shape: a bare disk store gains a memory
        # hot tier, an existing TieredStore is used as-is, None stays None
        # (coalescing-only degradation)
        self.store = as_tiered(store, memory_entries)
        self.backend_factory = backend_factory
        self.n_validate = n_validate
        self.sample_every = sample_every
        self.lock_timeout = lock_timeout
        self.stale_lock_seconds = stale_lock_seconds
        self.stats = ServiceStats()
        self._backends: dict[str, LLMBackend] = {}
        self._inflight: dict[str, _InFlight] = {}
        self._request_keys: dict[tuple[str, str, int], str] = {}
        self._mu = threading.Lock()

    @property
    def cache(self):
        """Legacy name for :attr:`store` (kept for older call sites)."""
        return self.store

    # -- request identity --------------------------------------------------
    def _backend(self, model: str) -> LLMBackend:
        backend = self._backends.get(model)
        if backend is None:
            # construct outside the service lock (a real backend may load
            # weights / open sessions); first insert wins
            built = self.backend_factory(model)
            with self._mu:
                backend = self._backends.setdefault(model, built)
        return backend

    def _domain(self, domain: str | Domain) -> Domain:
        if isinstance(domain, Domain):
            return domain
        return DOMAINS[domain]

    def request(self, domain: str | Domain, model: str,
                stage: int = 100) -> pipeline.DerivationRequest:
        """The fully-addressed request for one cell — its ``key`` is both the
        cache address and the coalescing identity."""
        return pipeline.prepare_request(
            self._domain(domain), self._backend(model), stage,
            n_validate=self.n_validate, sample_every=self.sample_every)

    def request_key(self, domain: str | Domain, model: str,
                    stage: int = 100) -> str:
        """The content address one cell would derive under — what the HTTP
        layer hashes onto the cluster ring to decide whether this node owns
        an incoming derive or should forward it to the owner.

        The first call for a model constructs (and registers) its backend,
        because the address includes ``backend.name`` and
        ``cache_fingerprint`` — attributes only a live backend carries.
        That is the same work a local serve would do, and it happens once:
        repeats hit the memo below without touching the backend."""
        name = domain.name if isinstance(domain, Domain) else domain
        key = self._request_keys.get((name, model, stage))
        if key is None:
            key = self.request(domain, model, stage).key
            with self._mu:
                self._request_keys[(name, model, stage)] = key
        return key

    # -- serving -----------------------------------------------------------
    def try_cached(self, domain: str | Domain, model: str,
                   stage: int = 100) -> pipeline.DerivationResult | None:
        """Non-blocking hot path: the cell's result if it is already resident
        in the local tiers, else ``None`` — never coalesces, never locks,
        never probes peers, never runs the pipeline.

        This is the path an event-loop frontend can serve *inline*: after the
        first request for a (domain, model, stage) the memoized content
        address plus the memory tier make this a pair of dict lookups, so a
        hot cell costs no thread hop.  A miss means the caller should fall
        through to :meth:`derive` (off the event loop)."""
        if self.store is None:
            return None
        name = domain.name if isinstance(domain, Domain) else domain
        key = self._request_keys.get((name, model, stage))
        if key is None:
            return None  # cold cell: derive() will build + memoize the key
        res = self.store.load_result(key)
        if res is None:
            rec = self.store.load(key, local_only=True)
            if rec is None:
                return None
            res = pipeline.result_from_record(
                rec, self._domain(domain), key)
            self.store.remember_result(key, res)
        with self._mu:
            self.stats.requests += 1
            self.stats.cache_hits += 1
        return res

    def derive(
        self,
        domain: str | Domain,
        model: str,
        stage: int = 100,
        gt: np.ndarray | Callable[[], np.ndarray] | None = None,
    ) -> pipeline.DerivationResult:
        """Serve one cell: cache -> coalesce -> (locked) pipeline run."""
        try:
            req = self.request(domain, model, stage)
        except BaseException:
            with self._mu:
                self.stats.requests += 1
                self.stats.errors += 1
            raise
        name = domain.name if isinstance(domain, Domain) else domain
        with self._mu:
            self.stats.requests += 1
            # memoize the cell's content address so later try_cached()
            # calls (the event-loop fast path) resolve without rebuilding
            # the request
            self._request_keys.setdefault((name, model, stage), req.key)
        try:
            return self._derive_admitted(req, gt)
        except BaseException:
            with self._mu:
                self.stats.errors += 1
            raise

    def _derive_admitted(self, req: pipeline.DerivationRequest, gt):
        # lock-free fast path: a locally-published record needs no
        # coordination.  Local tiers only — N concurrent cold requests
        # must not each pay the peer probe (timeout x peers); the
        # coalescing leader probes peers exactly once under the lock.
        res = self._from_cache(req, local_only=True)
        if res is not None:
            return res

        with self._mu:
            fl = self._inflight.get(req.key)
            leader = fl is None
            if leader:
                fl = self._inflight[req.key] = _InFlight()
        if not leader:
            with obs_trace.span("coalesced_wait"):
                fl.event.wait()
            with self._mu:
                self.stats.coalesced += 1
            if fl.error is not None:
                raise fl.error
            return fl.result  # type: ignore[return-value]

        push = None
        try:
            fl.result, push = self._derive_locked(req, gt)
            return fl.result
        except BaseException as e:
            fl.error = e
            raise
        finally:
            with self._mu:
                self._inflight.pop(req.key, None)
            fl.event.set()
            if push is not None:
                # peer write-back last: after the file lock (cross-process
                # waiters) AND after the event (coalesced threads) are both
                # released — a slow or dead peer (timeout x N peers) delays
                # only the leader's own response, never the followers.
                # PeerStore.store never raises (push failures are counted).
                push()

    def _from_cache(self, req: pipeline.DerivationRequest,
                    local_only: bool = False):
        if self.store is None:
            return None
        # hottest path: a previously-rehydrated result resident in the
        # memory tier — no disk read, no JSON parse, no reconstruction
        res = self.store.load_result(req.key)
        if res is None:
            rec = self.store.load(req.key, local_only=local_only)
            if rec is None:
                return None
            res = pipeline.result_from_record(rec, req.domain, req.key)
            # rehydrated results carry cache_hit=True, so remembering one
            # (never a fresh derivation) keeps repeat serves truthful
            self.store.remember_result(req.key, res)
        with self._mu:
            self.stats.cache_hits += 1
        return res

    def _derive_locked(self, req: pipeline.DerivationRequest, gt):
        """Leader path: under the store's per-key file lock, re-check the
        store (another process may have published while we waited), then run
        the pipeline stages and publish atomically.  Returns ``(result,
        push)`` where ``push`` is the deferred peer write-back (or None) —
        best-effort replication must run only after both the file lock and
        the coalescing event are released, so the caller sequences it."""
        if self.store is None:
            with self._mu:
                self.stats.derivations += 1
            return pipeline.run_stages(req, gt), None
        lock = self.store.lock(req.key, timeout=self.lock_timeout,
                               stale_seconds=self.stale_lock_seconds)
        with lock:
            if lock.broke_stale:
                with self._mu:
                    self.stats.stale_locks_broken += 1
            res = self._from_cache(req)
            if res is not None:
                return res, None
            res = pipeline.run_stages(req, gt)
            record = finalize_record(req.key,
                                     pipeline.record_from_result(res))
            self.store.store_local(req.key, record)
            with self._mu:
                self.stats.derivations += 1
        peer = self.store.peer
        push = (lambda: peer.store(req.key, record)) \
            if peer is not None else None
        return res, push

    def backends(self) -> dict[str, LLMBackend]:
        """The per-model backends built so far (read-only view — the HTTP
        metrics endpoint reports batching-queue counters from these)."""
        with self._mu:
            return dict(self._backends)

    def stats_snapshot(self) -> ServiceStats:
        """A consistent copy of the counters (safe to serialize while other
        threads keep serving)."""
        with self._mu:
            return self.stats.snapshot()

    def inflight_count(self) -> int:
        """Cells currently being derived (coalescing table size) — the
        instantaneous companion to the cumulative ``stats.coalesced``."""
        with self._mu:
            return len(self._inflight)

    def store_stats(self) -> dict | None:
        """Per-tier store counters (memory/disk/peer hits, evictions,
        migrations, quarantines) — None when running store-less."""
        return self.store.stats() if self.store is not None else None

    def artifact(self, domain: str | Domain, model: str,
                 stage: int = 100) -> MappingArtifact | None:
        """The persistent product of a served cell (None if it failed)."""
        return self.derive(domain, model, stage).artifact

    def result_for_key(self, key: str) -> pipeline.DerivationResult | None:
        """Rehydrate a stored derivation by content address (local tiers
        only — no derivation is triggered, no peer sweep is paid).  This is
        how the evaluation plane resolves ``key`` queries: a client that
        learned a cell's content address from a derive can ask for mapped
        coordinates without respelling (domain, model, stage)."""
        if self.store is None:
            return None
        res = self.store.load_result(key)
        if res is not None:
            return res
        rec = self.store.load(key, local_only=True)
        if rec is None:
            return None
        res = pipeline.result_from_record(rec, DOMAINS[rec["domain"]], key)
        self.store.remember_result(key, res)
        return res

    def artifact_for_key(self, key: str) -> MappingArtifact | None:
        """The stored artifact for a content address (None when the record
        is absent or the derivation failed) — the ``artifact_resolver``
        the HTTP layer hands to its EvaluationService."""
        res = self.result_for_key(key)
        return res.artifact if res is not None else None

    # -- streaming sweeps --------------------------------------------------
    def run_grid(
        self,
        domains: Iterable[str | Domain] | None = None,
        models: Iterable[str] | None = None,
        stages: Sequence[int] | None = None,
    ) -> Iterator[pipeline.DerivationResult]:
        """Served grid sweep, streaming per-cell results as they resolve.

        Ground truth is enumerated lazily once per domain and shared across
        that domain's cells; fully-cached sweeps never enumerate at all.
        Defaults match ``pipeline.run_grid`` (the paper's measured grid)."""
        from repro_torch.core import paper_tables as pt

        domains = list(domains) if domains is not None else sorted(pt.ACCURACY)
        models = list(models) if models is not None else list(pt.MODELS)
        stages = list(stages) if stages is not None else list(pt.STAGES)
        for dom_name in domains:
            dom = self._domain(dom_name)
            gt_memo: dict[str, np.ndarray] = {}

            def lazy_gt(d=dom, memo=gt_memo):
                if "gt" not in memo:
                    memo["gt"] = d.enumerate_points(self.n_validate)
                return memo["gt"]

            for model in models:
                for stage in stages:
                    yield self.derive(dom, model, stage, gt=lazy_gt)

    def grid(self, domains=None, models=None, stages=None,
             ) -> dict[tuple[str, str, int], pipeline.DerivationResult]:
        """Collected (non-streaming) form of :meth:`run_grid`."""
        return {(r.domain, r.model, r.stage): r
                for r in self.run_grid(domains, models, stages)}
