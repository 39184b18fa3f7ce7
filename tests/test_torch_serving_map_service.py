"""The port (``repro_torch.serving``) under the cases of
``tests/test_map_service.py``, which hold the JAX package's.

MappingService: concurrency-safe artifact serving — request coalescing,
cross-process file locking, stale-lock recovery, cache-off degradation, and
streamed grid sweeps (the 'many clients share one artifact store' scenario)."""
import json
import os
import threading
import time

import pytest

from repro_torch.core.artifact import ArtifactCache, FileLock
from repro_torch.core.backends import MockLLMBackend
from repro_torch.core.pipeline import derive_mapping
from repro_torch.serving import MappingService

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
    """One backend per model, shared across every service built from this
    factory — lets a test count derivations across 'processes'."""
    bank: dict[str, CountingBackend] = {}
    mu = threading.Lock()

    def factory(model: str) -> CountingBackend:
        with mu:
            if model not in bank:
                bank[model] = CountingBackend(model)
            return bank[model]

    factory.bank = bank
    return factory


def service(tmp_path, factory, **kw) -> MappingService:
    kw.setdefault("n_validate", 2000)
    kw.setdefault("sample_every", 1)
    return MappingService(cache=ArtifactCache(tmp_path), backend_factory=factory,
                          **kw)


# ---------------------------------------------------------------------------
# In-process coalescing (threads on one service)
# ---------------------------------------------------------------------------


def test_concurrent_threads_one_derivation(tmp_path):
    """N threads asking for the same cell: one generate call, one cached
    record, and every caller receives an identical DerivationResult."""
    factory = shared_factory()
    svc = service(tmp_path, factory)
    results = []
    mu = threading.Lock()

    def client():
        r = svc.derive("tri2d", MODEL, 20)
        with mu:
            results.append(r)

    threads = [threading.Thread(target=client) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert factory.bank[MODEL].calls == 1
    assert svc.stats.derivations == 1
    assert svc.stats.coalesced == 7
    assert len(results) == 8
    first = results[0]
    for r in results:
        assert r.cache_key == first.cache_key
        assert r.report == first.report
        assert r.complexity_class == first.complexity_class
    # exactly one well-formed record on disk
    records = list(tmp_path.glob("*.json"))
    assert len(records) == 1
    rec = json.loads(records[0].read_text())
    assert rec["domain"] == "tri2d" and rec["compiled"]
    # no leftover lock or temp files
    assert not list(tmp_path.glob("*.lock")) and not list(tmp_path.glob("*.tmp"))


def test_concurrent_distinct_cells_all_derive(tmp_path):
    factory = shared_factory()
    svc = service(tmp_path, factory)
    cells = [("tri2d", 20), ("tri2d", 50), ("gasket2d", 50)]
    threads = [threading.Thread(target=svc.derive, args=(d, MODEL, s))
               for d, s in cells]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert factory.bank[MODEL].calls == 3
    assert len(list(tmp_path.glob("*.json"))) == 3


# ---------------------------------------------------------------------------
# Cross-process safety (two services sharing one store, file-locked)
# ---------------------------------------------------------------------------


def test_two_services_share_one_derivation(tmp_path):
    """Two service instances (distinct in-flight tables — the two-process
    scenario) racing on one cell: the file lock serializes them, the loser
    is served from the store, and both results are identical."""
    factory = shared_factory()
    s1 = service(tmp_path, factory)
    s2 = service(tmp_path, factory)
    out = {}

    def client(tag, svc):
        out[tag] = svc.derive("carpet2d", MODEL, 100)

    t1 = threading.Thread(target=client, args=("a", s1))
    t2 = threading.Thread(target=client, args=("b", s2))
    t1.start()
    t2.start()
    t1.join()
    t2.join()
    assert factory.bank[MODEL].calls == 1
    assert s1.stats.derivations + s2.stats.derivations == 1
    assert out["a"].cache_key == out["b"].cache_key
    assert out["a"].report == out["b"].report
    assert out["a"].source == out["b"].source
    assert len(list(tmp_path.glob("*.json"))) == 1


def test_hammered_store_never_corrupts(tmp_path):
    """Threaded writers + readers on one key: the atomic-rename publish means
    a reader only ever sees a complete record or a miss — never a torn one."""
    cache = ArtifactCache(tmp_path)
    record = {"domain": "tri2d", "payload": "x" * 4096}
    stop = threading.Event()
    seen_bad = []

    def writer():
        while not stop.is_set():
            cache.store("k", record)

    def reader():
        while not stop.is_set():
            rec = cache.load("k")
            if rec is not None and rec.get("payload") != record["payload"]:
                seen_bad.append(rec)

    threads = [threading.Thread(target=writer) for _ in range(3)] + \
              [threading.Thread(target=reader) for _ in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.5)
    stop.set()
    for t in threads:
        t.join()
    assert not seen_bad
    assert json.loads(cache.path("k").read_text())["payload"] == record["payload"]


def test_clear_skips_live_locks_and_inflight_tmp_files(tmp_path):
    """clear() drops published records only: a live writer's .lock sentinel
    and an in-flight .tmp file must survive untouched (deleting the sentinel
    would let a second writer race the holder)."""
    cache = ArtifactCache(tmp_path)
    cache.store("k1", {"domain": "tri2d", "payload": "a"})
    cache.store("k2", {"domain": "gasket2d", "payload": "b"})
    lock = cache.lock("k1").acquire()
    inflight = tmp_path / "inflight01234.tmp"
    inflight.write_text('{"partial":')  # a writer mid-publish
    try:
        assert cache.clear() == 2
        assert not list(tmp_path.glob("*.json"))
        assert lock.path.exists()
        assert lock.path.read_text() == lock.token  # still the holder's
        assert inflight.exists()
    finally:
        lock.release()
    assert not lock.path.exists()


# ---------------------------------------------------------------------------
# Lock lifecycle
# ---------------------------------------------------------------------------


def test_stale_lock_is_broken(tmp_path):
    """A lock left by a crashed holder must not wedge the service."""
    factory = shared_factory()
    svc = service(tmp_path, factory, stale_lock_seconds=5.0)
    req = svc.request("gasket2d", MODEL, 20)
    lock_path = tmp_path / f"{req.key}.lock"
    lock_path.write_text("424242 0.0\n")
    old = time.time() - 600
    os.utime(lock_path, (old, old))
    res = svc.derive("gasket2d", MODEL, 20)
    assert res.compiled
    assert svc.stats.stale_locks_broken == 1
    assert not lock_path.exists()


def test_fresh_lock_makes_waiter_use_published_record(tmp_path):
    """A *live* lock blocks the second writer until the leader publishes;
    the waiter then reads the record instead of re-deriving."""
    factory = shared_factory()
    svc = service(tmp_path, factory, lock_timeout=10.0)
    req = svc.request("tri2d", MODEL, 50)
    with svc.cache.lock(req.key):
        t = threading.Thread(target=svc.derive, args=("tri2d", MODEL, 50))
        t.start()
        time.sleep(0.15)  # waiter is now polling the held lock
        assert factory.bank[MODEL].calls == 0
        # the "other process" publishes while still holding the lock
        derive_mapping(req.domain, factory(MODEL), 50, n_validate=2000,
                       cache=svc.cache)
        calls_after_publish = factory.bank[MODEL].calls
    # lock released: the waiter acquires it, re-checks the store, and hits
    t.join(timeout=10.0)
    assert not t.is_alive()
    assert factory.bank[MODEL].calls == calls_after_publish  # no re-derivation
    assert svc.stats.cache_hits == 1


def test_lock_timeout_raises(tmp_path):
    lock = FileLock(tmp_path / "k.lock", timeout=0.2, stale_seconds=60.0)
    (tmp_path / "k.lock").write_text("1 0\n")
    with pytest.raises(TimeoutError):
        lock.acquire()


def test_heartbeat_keeps_long_held_lock_alive(tmp_path):
    """A live holder running past stale_seconds must not be broken — the
    heartbeat refreshes the sentinel's mtime while held."""
    holder = FileLock(tmp_path / "k.lock", stale_seconds=0.3)
    holder.acquire()
    try:
        time.sleep(0.8)  # well past stale_seconds without a heartbeat
        contender = FileLock(tmp_path / "k.lock", timeout=0.2,
                             stale_seconds=0.3)
        with pytest.raises(TimeoutError):
            contender.acquire()
        assert not contender.broke_stale
        assert (tmp_path / "k.lock").read_text() == holder.token
    finally:
        holder.release()
    assert not (tmp_path / "k.lock").exists()


def test_release_never_deletes_foreign_lock(tmp_path):
    """A holder whose lock was broken (stale) must not delete the sentinel
    of whoever holds the lock now — release verifies the ownership token."""
    a = FileLock(tmp_path / "k.lock", stale_seconds=60.0)
    a.acquire()
    # simulate: a was deemed stale, broken, and b acquired
    (tmp_path / "k.lock").write_text("somebody-else")
    a.release()
    assert (tmp_path / "k.lock").read_text() == "somebody-else"


# ---------------------------------------------------------------------------
# Cache-off degradation + streamed sweeps
# ---------------------------------------------------------------------------


def test_cache_off_env_serves_without_store(monkeypatch, tmp_path):
    """REPRO_ARTIFACT_CACHE=off: the service degrades to coalescing-only —
    concurrent same-cell requests still trigger one derivation, but nothing
    is persisted and a second service re-derives."""
    monkeypatch.setenv("REPRO_ARTIFACT_CACHE", "off")
    factory = shared_factory()
    svc = MappingService(backend_factory=factory, n_validate=2000,
                         sample_every=1)
    assert svc.cache is None
    threads = [threading.Thread(target=svc.derive, args=("tri2d", MODEL, 20))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert factory.bank[MODEL].calls == 1
    assert svc.stats.coalesced == 3
    assert not list(tmp_path.glob("*.json"))
    svc2 = MappingService(backend_factory=factory, n_validate=2000,
                          sample_every=1)
    svc2.derive("tri2d", MODEL, 20)
    assert factory.bank[MODEL].calls == 2  # nothing was shared


def test_run_grid_streams_and_reuses_cache(tmp_path):
    factory = shared_factory()
    svc = service(tmp_path, factory)
    seen = []
    for res in svc.run_grid(domains=["tri2d", "msimplex3"], models=[MODEL],
                            stages=(20, 50)):
        seen.append((res.domain, res.stage, res.cache_hit))
    assert len(seen) == 4
    assert factory.bank[MODEL].calls == 4
    assert not any(hit for _, _, hit in seen)
    # a second client over the same store: streamed entirely from cache
    svc2 = service(tmp_path, factory)
    grid = svc2.grid(domains=["tri2d", "msimplex3"], models=[MODEL],
                     stages=(20, 50))
    assert len(grid) == 4
    assert all(r.cache_hit for r in grid.values())
    assert factory.bank[MODEL].calls == 4
    assert svc2.stats.derivations == 0


def test_service_artifact_roundtrip(tmp_path):
    factory = shared_factory()
    svc = service(tmp_path, factory)
    art = svc.artifact("msimplex4", MODEL, 20)
    assert art is not None and art.deployable
    assert art.domain == "msimplex4"
    # the derived scalar agrees with the registry's ground truth
    from repro_torch.core.registry import REGISTRY
    gt = REGISTRY.tier("msimplex4", None, "scalar")
    for lam in (0, 9, 1234, 10**6):
        assert tuple(art.scalar_fn()(lam)) == tuple(gt(lam))
