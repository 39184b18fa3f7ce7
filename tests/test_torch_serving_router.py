"""The port (``repro_torch.serving``) under the cases of
``tests/test_router.py``, which hold the JAX package's.

Load-aware request routing: RequestQueue admission/TTL/retry-lane
semantics, ReplicaSelector EWMA + queue-depth ranking and epsilon-greedy
exploration, RequestRouter dispatch, and the end-to-end traffic shift —
a fleet with one artificially slowed replica routes around it."""
import threading
import time

import pytest

from repro_torch.core.backends import MockLLMBackend
from repro_torch.core.store import build_store
from repro_torch.serving import (
    ClusterMembership, MappingHTTPServer, MappingService,
    RemoteMappingService, ReplicaSelector, RequestQueue, RequestRouter,
)

MODEL = "OSS:120b"


# ---------------------------------------------------------------------------
# RequestQueue
# ---------------------------------------------------------------------------


def test_queue_fifo_and_retry_lane_priority():
    q = RequestQueue(capacity=8, ttl=10.0)
    for item in ("a", "b", "c"):
        assert q.offer(item)
    assert q.depth() == 3
    assert q.requeue("c")                 # failed once: jumps the line
    assert q.take() == "c"
    assert q.take() == "a" and q.take() == "b"
    assert q.take() is None
    assert q.stats.enqueued == 3
    assert q.stats.dequeued == 3
    assert q.stats.retried == 1


def test_queue_capacity_covers_both_lanes_and_sheds():
    q = RequestQueue(capacity=2, ttl=10.0)
    assert q.offer("a") and q.offer("b")
    assert not q.offer("c")               # full: shed
    assert q.stats.shed == 1
    assert q.requeue("a")                 # already queued: lane move, free
    assert not q.requeue("x")             # unknown + full: shed
    assert q.stats.shed == 2
    assert q.depth() == 2


def test_queue_ttl_expiry_is_lazy_and_counted():
    q = RequestQueue(capacity=8, ttl=0.05)
    q.offer("stale")
    q.offer("fresh", ttl=10.0)            # per-item override
    time.sleep(0.08)
    assert q.take() == "fresh"            # stale was dropped, not served
    assert q.stats.expired == 1
    assert q.take() is None


def test_queue_requeue_keeps_original_deadline():
    """A retry must not extend the request's TTL budget."""
    q = RequestQueue(capacity=8, ttl=10.0)
    q.offer("a", ttl=0.05)
    q.requeue("a")                        # lane move, same deadline
    time.sleep(0.08)
    assert q.take() is None
    assert q.stats.expired == 1


def test_queue_remove_withdraws_admission():
    q = RequestQueue(capacity=2, ttl=10.0)
    token = object()
    q.offer(token)
    assert q.remove(token)
    assert not q.remove(token)
    assert q.depth() == 0 and q.offer("next")


# ---------------------------------------------------------------------------
# ReplicaSelector
# ---------------------------------------------------------------------------


def test_selector_ewma_and_failure_penalty():
    sel = ReplicaSelector(alpha=0.3, epsilon=0.0, failure_penalty_ms=250.0)
    sel.observe("u", 0.010)
    assert sel.cost("u") == pytest.approx(10.0)
    sel.observe("u", 0.020)               # 10 + 0.3 * (20 - 10)
    assert sel.cost("u") == pytest.approx(13.0)
    sel.observe("u", 0.001, ok=False)     # books >= failure_penalty_ms
    assert sel.cost("u") > 70.0
    snap = sel.snapshot()["u"]
    assert snap["samples"] == 3 and snap["failures"] == 1
    assert snap["last_ms"] == 250.0


def test_selector_rank_blends_latency_and_advertised_depth():
    sel = ReplicaSelector(epsilon=0.0, depth_penalty_ms=5.0)
    sel.observe("fast", 0.010)
    sel.observe("slow", 0.030)
    assert sel.rank(["slow", "fast"]) == ["fast", "slow"]
    # 20ms of advertised queue depth flips the 20ms latency edge
    sel.advertise("fast", {"queue_depth": 5})
    assert sel.cost("fast") == pytest.approx(35.0)
    assert sel.rank(["slow", "fast"]) == ["slow", "fast"]
    sel.advertise("fast", {"queue_depth": 0})
    assert sel.rank(["slow", "fast"]) == ["fast", "slow"]
    # malformed advertisements are ignored, never raise
    sel.advertise("fast", None)
    sel.advertise("fast", {"queue_depth": "soup"})
    assert sel.cost("fast") == pytest.approx(10.0)


def test_selector_unknown_replicas_are_optimistic():
    """A fresh joiner (no samples) outranks every measured replica, and
    forget() resets a replica back to optimism."""
    sel = ReplicaSelector(epsilon=0.0)
    sel.observe("old", 0.005)
    assert sel.rank(["old", "new"]) == ["new", "old"]
    sel.observe("new", 0.050)
    assert sel.rank(["old", "new"]) == ["old", "new"]
    sel.forget("new")
    assert sel.rank(["old", "new"]) == ["new", "old"]


def test_selector_epsilon_exploration_is_seeded():
    sel = ReplicaSelector(epsilon=1.0, seed=7)
    sel.observe("a", 0.001)
    sel.observe("b", 0.100)
    ranks = [sel.rank(["a", "b"]) for _ in range(8)]
    assert all(r[0] == "b" for r in ranks)   # epsilon=1: always explore
    assert sel.explorations == 8
    twin = ReplicaSelector(epsilon=1.0, seed=7)
    twin.observe("a", 0.001)
    twin.observe("b", 0.100)
    assert [twin.rank(["a", "b"]) for _ in range(8)] == ranks
    greedy = ReplicaSelector(epsilon=0.0, seed=7)
    greedy.observe("a", 0.001)
    greedy.observe("b", 0.100)
    assert greedy.rank(["a", "b"]) == ["a", "b"]
    assert greedy.explorations == 0


# ---------------------------------------------------------------------------
# RequestRouter dispatch
# ---------------------------------------------------------------------------


def test_dispatch_prefers_measured_fast_replica():
    router = RequestRouter(policy="loaded", epsilon=0.0, seed=0)
    router.observe("slow", 0.200)
    router.observe("fast", 0.002)
    hops = []

    def attempt(url):
        hops.append(url)
        return f"ok:{url}"

    out = router.dispatch("k", ["slow", "fast"], attempt)
    assert out == "ok:fast" and hops == ["fast"]
    assert router.selector.snapshot()["fast"]["selections"] == 1
    assert router.queue.depth() == 0      # admission released


def test_dispatch_walks_candidates_on_failure():
    router = RequestRouter(policy="loaded", epsilon=0.0, seed=0)
    errors = []

    def attempt(url):
        if url == "dead":
            raise OSError("refused")
        return url

    router.observe("dead", 0.001)         # looks best until it fails
    router.observe("alive", 0.050)
    out = router.dispatch("k", ["dead", "alive"], attempt,
                          on_error=lambda u, e: errors.append((u, str(e))))
    assert out == "alive"
    assert errors == [("dead", "refused")]
    assert router.queue.stats.retried == 1
    assert router.selector.snapshot()["dead"]["failures"] == 1
    # the failure penalty reorders the next dispatch
    assert router.rank_owners(["dead", "alive"]) == ["alive", "dead"]


def test_dispatch_sheds_when_queue_full_and_expires_on_ttl():
    full = RequestRouter(policy="loaded", max_pending=1)
    full.queue.offer("occupant")
    assert full.dispatch("k", ["u"], lambda u: "x") is None
    assert full.queue.stats.shed == 1

    expired = RequestRouter(policy="loaded", ttl=0.0)
    assert expired.dispatch("k", ["u"], lambda u: "x") is None
    assert expired.queue.stats.expired >= 1

    assert full.dispatch("nope", [], lambda u: "x") is None  # no candidates


def test_static_policy_keeps_ring_order_but_still_measures():
    router = RequestRouter(policy="static")
    router.observe("b", 0.001)            # would win under "loaded"
    router.observe("a", 0.500)
    assert router.rank_owners(["a", "b"]) == ["a", "b"]
    out = router.dispatch("k", ["a", "b"], lambda u: u)
    assert out == "a"
    assert router.selector.snapshot()["a"]["samples"] == 2
    with pytest.raises(ValueError):
        RequestRouter(policy="mystery")


def test_track_and_load_advertisement():
    router = RequestRouter()
    assert router.load() == {"queue_depth": 0, "inflight": 0}
    with router.track():
        with router.track():
            assert router.load()["inflight"] == 2
        assert router.inflight() == 1
    assert router.inflight() == 0
    stats = router.stats_dict()
    assert stats["policy"] == "loaded"
    assert stats["queue"]["capacity"] == 256
    assert "replicas" in stats


# ---------------------------------------------------------------------------
# End to end: the fleet routes around a slowed replica
# ---------------------------------------------------------------------------


class CountingBackend:
    calls = 0
    _mu = threading.Lock()

    def __init__(self, model: str):
        self._inner = MockLLMBackend(model)
        self.name = self._inner.name

    @property
    def cache_fingerprint(self):
        return self._inner.cache_fingerprint

    def generate(self, prompt, *, meta):
        with CountingBackend._mu:
            CountingBackend.calls += 1
        return self._inner.generate(prompt, meta=meta)


def _boot(tmp_path, name, seeds, port=0, serve_delay=0.0, router=None):
    svc = MappingService(store=build_store(root=tmp_path / name),
                         backend_factory=CountingBackend,
                         n_validate=2000, sample_every=1)
    server = MappingHTTPServer(svc, port=port, router=router,
                               serve_delay=serve_delay).start()
    server.attach_cluster(ClusterMembership(
        server.url, seeds=seeds, replicas=2, vnodes=64,
        heartbeat_interval=0.15, down_after=1.0, sync_interval=0.3,
        probe_timeout=1.0))
    return server


def _await(predicate, timeout=20.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def test_traffic_shifts_away_from_slow_replica(tmp_path):
    """3-node fleet, one cell owned by two replicas, one of them slowed by
    the chaos knob: the non-owner's router must concentrate forwards on
    the fast owner (selection counters prove it), the slow owner's latency
    is learned from real observations, and the whole run costs exactly one
    inference.  The healthz/heartbeat load piggyback is live too."""
    import json
    import urllib.request

    CountingBackend.calls = 0
    # boot the seed first, pick the slow node after placement is known
    seed = _boot(tmp_path, "n0", [])
    b = _boot(tmp_path, "n1", [seed.url])
    c = _boot(tmp_path, "n2", [seed.url])
    servers = [seed, b, c]
    try:
        _await(lambda: all(len(s.cluster.ring.nodes) == 3 for s in servers),
               what="3-node convergence")
        key = seed.service.request_key("tri2d", MODEL, 20)
        owners = seed.cluster.owners(key)
        non_owner = next(s for s in servers if s.url not in owners)
        slow = next(s for s in servers if s.url == owners[0])
        fast = next(s for s in servers if s.url == owners[1])
        slow.serve_delay = 0.25           # the chaos knob, applied live
        # deterministic selection on the forwarding node: no exploration
        non_owner.router.selector.epsilon = 0.0

        body = json.dumps({"domain": "tri2d", "model": MODEL,
                           "stage": 20}).encode()
        for _ in range(6):
            req = urllib.request.Request(
                f"{non_owner.url}/v1/derive", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30.0) as resp:
                assert json.loads(resp.read())["key"] == key
        assert CountingBackend.calls == 1

        snap = non_owner.router.selector.snapshot()
        sel_fast = snap[fast.url]["selections"]
        sel_slow = snap.get(slow.url, {}).get("selections", 0)
        # first hop probes optimistically; every later hop goes fast
        assert sel_fast >= 4, snap
        assert sel_slow <= 2, snap
        assert snap[fast.url]["ewma_ms"] < 250.0
        if slow.url in snap and snap[slow.url]["samples"]:
            assert snap[slow.url]["ewma_ms"] >= 200.0

        # healthz piggybacks the advertised load
        with urllib.request.urlopen(f"{fast.url}/healthz",
                                    timeout=5.0) as resp:
            health = json.loads(resp.read())
        assert "load" in health and "queue_depth" in health["load"]

        # /metrics exposes the router block both frontends share
        with urllib.request.urlopen(f"{non_owner.url}/metrics",
                                    timeout=5.0) as resp:
            metrics = json.loads(resp.read())
        assert metrics["router"]["policy"] == "loaded"
        assert fast.url in metrics["router"]["replicas"]
    finally:
        for s in servers:
            s.close()


def test_heartbeat_piggybacks_load_between_peers(tmp_path):
    """The cluster view carries each node's advertised queue depth, and a
    peer's selector learns it without any request traffic."""
    seed = _boot(tmp_path, "h0", [])
    other = _boot(tmp_path, "h1", [seed.url])
    try:
        _await(lambda: len(seed.cluster.ring.nodes) == 2
               and len(other.cluster.ring.nodes) == 2,
               what="2-node convergence")
        with other.router.track():        # fake one in-flight derive
            _await(lambda: seed.router.selector.snapshot()
                   .get(other.url, {}).get("queue_depth") == 1,
                   timeout=5.0,
                   what="load piggyback via heartbeat")
        _await(lambda: seed.router.selector.snapshot()
               .get(other.url, {}).get("queue_depth") == 0,
               timeout=5.0, what="load decay after the work drains")
        loads = seed.cluster.node_loads()
        assert other.url in loads and "queue_depth" in loads[other.url]
    finally:
        seed.close()
        other.close()
