"""Load-aware request routing: a bounded per-node scheduler + a latency/
queue-depth replica selector.

The ring (:mod:`repro_torch.serving.cluster`) decides *who may* serve a key — a
static, placement-only answer.  This module decides *who should serve it
right now*: among the K owners, a slow or queue-saturated replica must
re-earn traffic instead of receiving its static hash share while idle
siblings starve.  Three pieces:

  * :class:`RequestQueue`    — a bounded FIFO with TTL expiry and a retry
    lane.  ``offer`` refuses when full (the caller sheds — for forwards
    that means graceful local degradation, never an error), ``take``
    drains the retry lane first and silently drops entries whose deadline
    passed, and ``requeue`` moves a failed entry into the retry lane so a
    transient peer error gets one more shot ahead of fresh arrivals.
  * :class:`ReplicaSelector` — per-replica EWMA of *observed* latency
    blended with the *advertised* queue depth each peer piggybacks on
    heartbeats and ``/healthz``.  Ranking is epsilon-greedy: with
    probability ``epsilon`` a non-best candidate is promoted, so a
    recovered replica (whose stale EWMA still remembers the bad times)
    re-earns traffic instead of being starved forever.  Unknown replicas
    score optimistically (cost 0) — a fresh joiner is tried immediately.
  * :class:`RequestRouter`   — composes the two per node and exposes the
    frontends' integration surface: ``dispatch`` runs one request's
    forward attempts through the scheduler (admission -> ranked candidates
    -> per-attempt latency observation -> retry lane on failure -> TTL
    give-up), ``track`` counts local in-flight work, and ``load`` is what
    the cluster advertises to peers as this node's queue depth.

Everything is stdlib, thread-safe, and deterministic under a seeded RNG so
tests can pin the exploration schedule.  ``policy="static"`` preserves the
pre-adaptive ring-order behavior — it is both the benchmark baseline and
the escape hatch.
"""
from __future__ import annotations

import contextlib
import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable

__all__ = ["RequestQueue", "ReplicaSelector", "RequestRouter", "RouterStats"]

#: router policies selectable via ``--route-policy``
POLICIES = ("loaded", "static")


@dataclass
class RouterStats:
    """Scheduler counters (the gauges ``/metrics`` exposes)."""

    enqueued: int = 0   # offers accepted
    dequeued: int = 0   # entries handed to a consumer
    expired: int = 0    # entries dropped past their deadline
    retried: int = 0    # entries moved to the retry lane
    shed: int = 0       # offers refused because the queue was full

    def as_dict(self) -> dict[str, int]:
        return {"enqueued": self.enqueued, "dequeued": self.dequeued,
                "expired": self.expired, "retried": self.retried,
                "shed": self.shed}


class _Entry:
    __slots__ = ("item", "deadline")

    def __init__(self, item: Any, deadline: float):
        self.item = item
        self.deadline = deadline


class RequestQueue:
    """Bounded FIFO with TTL expiry and a retry lane.

    Capacity covers both lanes together — a retry burst cannot grow the
    queue past what admission agreed to.  Expiry is lazy (checked on
    ``take``/``depth``): an entry that waited out its TTL is dropped and
    counted, never handed to a consumer, so a consumer can trust that
    whatever it takes still has budget left."""

    def __init__(self, capacity: int = 256, ttl: float = 30.0):
        self.capacity = max(1, int(capacity))
        self.ttl = float(ttl)
        self.stats = RouterStats()
        self._main: list[_Entry] = []
        self._retry: list[_Entry] = []
        self._mu = threading.Lock()

    def _drop_expired(self, now: float) -> None:
        """Callers hold ``_mu``."""
        for lane in (self._retry, self._main):
            kept = [e for e in lane if e.deadline > now]
            self.stats.expired += len(lane) - len(kept)
            lane[:] = kept

    def offer(self, item: Any, ttl: float | None = None) -> bool:
        """Admit ``item`` (False = full, caller sheds)."""
        now = time.monotonic()
        with self._mu:
            self._drop_expired(now)
            if len(self._main) + len(self._retry) >= self.capacity:
                self.stats.shed += 1
                return False
            self._main.append(_Entry(item, now + (self.ttl if ttl is None
                                                  else ttl)))
            self.stats.enqueued += 1
            return True

    def requeue(self, item: Any) -> bool:
        """Move ``item`` into the retry lane (ahead of fresh arrivals),
        keeping its original deadline when it is already queued — a retry
        must not extend the request's budget.  False when the item is
        unknown and the queue is full."""
        now = time.monotonic()
        with self._mu:
            self._drop_expired(now)
            entry = None
            for lane in (self._main, self._retry):
                for e in lane:
                    if e.item is item:
                        lane.remove(e)
                        entry = e
                        break
                if entry is not None:
                    break
            if entry is None:
                if len(self._main) + len(self._retry) >= self.capacity:
                    self.stats.shed += 1
                    return False
                entry = _Entry(item, now + self.ttl)
            self._retry.append(entry)
            self.stats.retried += 1
            return True

    def take(self) -> Any:
        """The oldest live entry, retry lane first (None when empty)."""
        now = time.monotonic()
        with self._mu:
            self._drop_expired(now)
            for lane in (self._retry, self._main):
                if lane:
                    self.stats.dequeued += 1
                    return lane.pop(0).item
            return None

    def remove(self, item: Any) -> bool:
        """Withdraw a specific item (admission release), expired or not."""
        with self._mu:
            for lane in (self._main, self._retry):
                for e in lane:
                    if e.item is item:
                        lane.remove(e)
                        return True
            return False

    def depth(self) -> int:
        now = time.monotonic()
        with self._mu:
            self._drop_expired(now)
            return len(self._main) + len(self._retry)


class _Replica:
    __slots__ = ("ewma_ms", "last_ms", "samples", "queue_depth",
                 "selections", "failures")

    def __init__(self):
        self.ewma_ms = 0.0
        self.last_ms = 0.0
        self.samples = 0
        self.queue_depth = 0
        self.selections = 0
        self.failures = 0


class ReplicaSelector:
    """EWMA-latency + advertised-queue-depth ranking with epsilon-greedy
    exploration.

    ``cost(url) = ewma_ms + depth_penalty_ms * advertised_queue_depth``;
    never-observed replicas cost 0 (optimism: fresh joiners and recovered
    nodes get tried immediately).  A failed attempt books at least
    ``failure_penalty_ms`` into the EWMA so a dead replica decays out of
    the rotation fast — and re-earns its way back via exploration plus the
    optimistic reset when membership forgets and re-adds it."""

    def __init__(self, alpha: float = 0.3, epsilon: float = 0.05,
                 depth_penalty_ms: float = 5.0,
                 failure_penalty_ms: float = 250.0,
                 seed: int | None = None):
        self.alpha = min(max(float(alpha), 0.01), 1.0)
        self.epsilon = min(max(float(epsilon), 0.0), 1.0)
        self.depth_penalty_ms = float(depth_penalty_ms)
        self.failure_penalty_ms = float(failure_penalty_ms)
        self.explorations = 0
        self._rng = random.Random(seed)
        self._replicas: dict[str, _Replica] = {}
        self._mu = threading.Lock()

    def _get(self, url: str) -> _Replica:
        """Callers hold ``_mu``."""
        replica = self._replicas.get(url)
        if replica is None:
            replica = self._replicas[url] = _Replica()
        return replica

    def observe(self, url: str, seconds: float, ok: bool = True) -> None:
        """Fold one attempt's measured latency into the replica's EWMA."""
        ms = max(0.0, seconds * 1e3)
        with self._mu:
            replica = self._get(url)
            if not ok:
                replica.failures += 1
                ms = max(ms, self.failure_penalty_ms)
            if replica.samples == 0:
                replica.ewma_ms = ms
            else:
                replica.ewma_ms += self.alpha * (ms - replica.ewma_ms)
            replica.last_ms = ms
            replica.samples += 1

    def advertise(self, url: str, load: dict | None) -> None:
        """Fold in a queue-depth advertisement (heartbeat piggyback or a
        ``/healthz`` answer)."""
        if not isinstance(load, dict):
            return
        try:
            depth = max(0, int(load.get("queue_depth", 0)))
        except (TypeError, ValueError):
            return
        with self._mu:
            self._get(url).queue_depth = depth

    def record_selection(self, url: str) -> None:
        with self._mu:
            self._get(url).selections += 1

    def forget(self, url: str) -> None:
        """Drop learned state (e.g. the fleet forgot the node) — if it
        comes back it restarts optimistic."""
        with self._mu:
            self._replicas.pop(url, None)

    def cost(self, url: str) -> float:
        with self._mu:
            replica = self._replicas.get(url)
            if replica is None or replica.samples == 0:
                depth = 0 if replica is None else replica.queue_depth
                return self.depth_penalty_ms * depth
            return replica.ewma_ms + self.depth_penalty_ms * \
                replica.queue_depth

    def rank(self, urls: Iterable[str]) -> list[str]:
        """Candidates in serving preference order: cost-ascending with the
        caller's (ring) order as the tiebreak; with probability ``epsilon``
        one non-best candidate is promoted to the front instead."""
        urls = list(urls)
        if len(urls) <= 1:
            return urls
        costs = {u: self.cost(u) for u in urls}
        ranked = [u for _, _, u in
                  sorted((costs[u], i, u) for i, u in enumerate(urls))]
        if self.epsilon > 0 and self._rng.random() < self.epsilon:
            with self._mu:
                self.explorations += 1
                j = self._rng.randrange(1, len(ranked))
            ranked.insert(0, ranked.pop(j))
        return ranked

    def snapshot(self) -> dict[str, dict]:
        """Per-replica state for ``/metrics`` (the selection counters the
        chaos CI asserts traffic shifts on)."""
        with self._mu:
            return {url: {"ewma_ms": round(r.ewma_ms, 3),
                          "last_ms": round(r.last_ms, 3),
                          "samples": r.samples,
                          "queue_depth": r.queue_depth,
                          "selections": r.selections,
                          "failures": r.failures}
                    for url, r in self._replicas.items()}


class RequestRouter:
    """Per-node composition of scheduler + selector, plus the in-flight
    gauge the cluster advertises as this node's queue depth.

    ``policy="loaded"`` ranks owners by the selector; ``policy="static"``
    keeps ring order (the pre-adaptive behavior, also the benchmark
    baseline).  Either way every forward attempt is measured and fed back,
    so flipping a static fleet to loaded starts from a warm model."""

    def __init__(self, policy: str = "loaded", max_pending: int = 256,
                 ttl: float = 30.0, epsilon: float = 0.05,
                 alpha: float = 0.3, depth_penalty_ms: float = 5.0,
                 failure_penalty_ms: float = 250.0,
                 seed: int | None = None):
        policy = (policy or "loaded").strip().lower()
        if policy not in POLICIES:
            raise ValueError(f"unknown route policy {policy!r} (expected "
                             f"one of {', '.join(POLICIES)})")
        self.policy = policy
        self.queue = RequestQueue(capacity=max_pending, ttl=ttl)
        self.selector = ReplicaSelector(
            alpha=alpha, epsilon=epsilon, depth_penalty_ms=depth_penalty_ms,
            failure_penalty_ms=failure_penalty_ms, seed=seed)
        self._inflight = 0
        self._mu = threading.Lock()

    # -- local load accounting (what peers see) ----------------------------
    @contextlib.contextmanager
    def track(self):
        """Count one unit of local in-flight work (a derive being served)
        toward the advertised queue depth."""
        with self._mu:
            self._inflight += 1
        try:
            yield
        finally:
            with self._mu:
                self._inflight -= 1

    def inflight(self) -> int:
        with self._mu:
            return self._inflight

    def load(self) -> dict:
        """This node's advertisement: piggybacked on every ``/v1/cluster``
        view and served on ``/healthz``."""
        return {"queue_depth": self.inflight() + self.queue.depth(),
                "inflight": self.inflight()}

    # -- selection ---------------------------------------------------------
    def rank_owners(self, owners: Iterable[str]) -> list[str]:
        owners = list(owners)
        if self.policy == "static":
            return owners
        return self.selector.rank(owners)

    def observe(self, url: str, seconds: float, ok: bool = True) -> None:
        self.selector.observe(url, seconds, ok=ok)

    def advertise(self, url: str, load: dict | None) -> None:
        self.selector.advertise(url, load)

    # -- the forward-hop scheduler -----------------------------------------
    def dispatch(self, key: str, candidates: Iterable[str],
                 attempt: Callable[[str], Any],
                 on_error: Callable[[str, Exception], Any] | None = None):
        """Run one request's forward attempts through the scheduler.

        Admission first: a full queue sheds the *hop* (returns None — the
        caller degrades to serving locally, which is always correct).
        Candidates are then tried best-first; a failed attempt books the
        failure into the selector, moves the request to the retry lane,
        and tries the next candidate — until the TTL budget expires.
        Returns the first successful attempt's result, else None."""
        candidates = list(candidates)
        if not candidates:
            return None
        token = object()
        if not self.queue.offer(token):
            return None
        deadline = time.monotonic() + self.queue.ttl
        try:
            for url in self.rank_owners(candidates):
                if time.monotonic() >= deadline:
                    self.queue.stats.expired += 1
                    break
                self.selector.record_selection(url)
                t0 = time.monotonic()
                try:
                    result = attempt(url)
                except Exception as exc:  # noqa: BLE001 — any hop failure
                    self.observe(url, time.monotonic() - t0, ok=False)
                    if on_error is not None:
                        on_error(url, exc)
                    self.queue.requeue(token)  # retry lane: next candidate
                    continue
                self.observe(url, time.monotonic() - t0, ok=True)
                return result
            return None
        finally:
            self.queue.remove(token)

    # -- metrics -----------------------------------------------------------
    def stats_dict(self) -> dict:
        return {"policy": self.policy,
                "epsilon": self.selector.epsilon,
                "inflight": self.inflight(),
                "queue_depth": self.load()["queue_depth"],
                "queue": {"capacity": self.queue.capacity,
                          "ttl_seconds": self.queue.ttl,
                          "depth": self.queue.depth(),
                          **self.queue.stats.as_dict()},
                "explorations": self.selector.explorations,
                "replicas": self.selector.snapshot()}
