"""The port's tiered ArtifactStore (``repro_torch.core.store``), held
against the JAX package's: the lifecycle cases of ``tests/test_store.py``
(memory-LRU eviction order, disk TTL + max-bytes eviction over the
access-time index, schema-version migration, checksum-mismatch quarantine,
read-through promotion, the env/CLI construction surface, and the two
served-lifecycle cases on the port's ``MappingService``) run against the
port, and the record format is shared: a record either package's
``DiskStore`` writes loads in the other's, envelope and checksum equal."""
import json
import os
import threading
import time
from pathlib import Path

import pytest

from repro.core import store as ref_store
from repro_torch.core.store import (
    SCHEMA_VERSION, DiskStore, MemoryStore, NullLock, PeerStore, TieredStore,
    build_store, default_store, finalize_record, record_checksum, valid_key,
)

REC = {"domain": "tri2d", "model": "OSS:120b", "stage": 20, "compiled": True}


def padded(n_bytes: int = 1024, **over) -> dict:
    return {**REC, "pad": "x" * n_bytes, **over}


# ---------------------------------------------------------------------------
# MemoryStore — bounded LRU
# ---------------------------------------------------------------------------


def test_memory_lru_evicts_least_recently_used():
    m = MemoryStore(max_entries=2)
    m.store("a", padded(8))
    m.store("b", padded(8))
    m.load("a")            # refresh a: b is now the LRU entry
    m.store("c", padded(8))
    assert "a" in m and "c" in m and "b" not in m
    assert m.evictions == 1
    assert m.keys() == ["a", "c"]  # least-recent first
    # store-refresh moves an existing key to MRU as well
    m.store("a", padded(8))
    m.store("d", padded(8))
    assert m.keys() == ["a", "d"] and "c" not in m


def test_memory_store_remembers_rehydrated_results():
    m = MemoryStore(max_entries=4)
    m.store("k", padded(8))
    assert m.load_result("k") is None
    token = object()
    m.remember_result("k", token)
    assert m.load_result("k") is token
    assert m.result_hits == 1
    m.delete("k")
    assert m.load_result("k") is None
    # remembering against an evicted/absent key is a silent no-op
    m.remember_result("gone", token)
    assert m.load_result("gone") is None


def test_memory_zero_entries_disables_tier():
    m = MemoryStore(max_entries=0)
    m.store("k", padded(8))
    assert m.load("k") is None and len(m) == 0


# ---------------------------------------------------------------------------
# DiskStore — versioned records, TTL/size eviction, migration, quarantine
# ---------------------------------------------------------------------------


def test_disk_roundtrip_stamps_versioned_checksummed_envelope(tmp_path):
    d = DiskStore(tmp_path)
    d.store("k", padded(16))
    on_disk = json.loads(d.path("k").read_text())
    assert on_disk["schema"] == SCHEMA_VERSION
    assert on_disk["key"] == "k"
    assert on_disk["checksum"] == record_checksum(on_disk)
    rec = d.load("k")
    assert rec["domain"] == "tri2d" and d.hits == 1


def test_disk_ttl_evicts_idle_records(tmp_path):
    d = DiskStore(tmp_path, ttl_seconds=0.2)
    d.store("old", padded(16))
    time.sleep(0.3)
    d.store("fresh", padded(16))  # publish triggers opportunistic eviction
    assert "old" not in d and "fresh" in d
    assert d.evictions_ttl == 1
    # a loaded (touched) record is not idle: access refreshes the clock
    time.sleep(0.15)
    assert d.load("fresh") is not None
    time.sleep(0.15)
    assert d.evict()["ttl"] == 0  # accessed 0.15s ago < 0.2s ttl
    assert "fresh" in d


def test_disk_max_bytes_evicts_least_recently_accessed(tmp_path):
    probe = DiskStore(tmp_path / "probe")
    probe.store("k", padded(1024))
    size = probe.path("k").stat().st_size

    d = DiskStore(tmp_path / "store", max_bytes=int(size * 2.5))
    d.store("a", padded(1024))
    time.sleep(0.05)
    d.store("b", padded(1024))
    time.sleep(0.05)
    assert d.load("a") is not None  # refresh a: b becomes the LRA record
    time.sleep(0.05)
    d.store("c", padded(1024))      # 3 records > budget for 2.5
    assert "a" in d and "c" in d and "b" not in d
    assert d.evictions_bytes == 1


def test_disk_migrates_schema1_record_in_place(tmp_path):
    d = DiskStore(tmp_path)
    legacy = {"schema": 1, "key": "k", **padded(16)}
    d.path("k").write_text(json.dumps(legacy))
    rec = d.load("k")
    assert rec["schema"] == SCHEMA_VERSION and rec["domain"] == "tri2d"
    assert d.migrated == 1 and d.hits == 1
    on_disk = json.loads(d.path("k").read_text())
    assert on_disk["schema"] == SCHEMA_VERSION
    assert on_disk["checksum"] == record_checksum(on_disk)
    # the migrated record now round-trips through the normal verified path
    d2 = DiskStore(tmp_path)
    assert d2.load("k")["domain"] == "tri2d"
    assert d2.migrated == 0


def test_disk_quarantines_checksum_mismatch(tmp_path):
    d = DiskStore(tmp_path)
    d.store("k", padded(16))
    on_disk = json.loads(d.path("k").read_text())
    on_disk["pad"] = "tampered"  # payload changed, checksum stale
    d.path("k").write_text(json.dumps(on_disk))
    assert d.load("k") is None
    assert d.quarantined == 1
    assert not d.path("k").exists()
    quarantined = tmp_path / "k.quarantined"
    assert quarantined.exists()
    assert json.loads(quarantined.read_text())["pad"] == "tampered"
    # quarantined bytes are set aside, not destroyed: clear() and an
    # unbounded store's evict() leave them for inspection
    d.store("other", padded(16))
    d.evict()
    d.clear()
    assert quarantined.exists()
    usage = d.usage()
    assert usage["quarantined_records"] == 1
    assert usage["total_bytes"] == usage["quarantined_bytes"] > 0


def test_quarantined_bytes_count_against_disk_budget(tmp_path):
    """Under byte pressure quarantined files are reclaimed *first* — a
    corrupting disk must not let set-aside bytes exceed the budget while
    live records get evicted around them."""
    probe = DiskStore(tmp_path / "probe")
    probe.store("k", padded(1024))
    size = probe.path("k").stat().st_size

    d = DiskStore(tmp_path / "store", max_bytes=int(size * 2.5))
    d.store("bad", padded(1024))
    on_disk = json.loads(d.path("bad").read_text())
    on_disk["pad"] = "y" * 1024  # same size, stale checksum
    d.path("bad").write_text(json.dumps(on_disk))
    assert d.load("bad") is None  # quarantined, still on disk
    time.sleep(0.05)
    d.store("a", padded(1024))
    time.sleep(0.05)
    d.store("b", padded(1024))   # 2 records + 1 quarantine > 2.5x budget
    assert not (tmp_path / "store" / "bad.quarantined").exists()
    assert "a" in d and "b" in d  # live records survived
    assert d.evictions_bytes == 1
    assert d.usage()["total_bytes"] <= int(size * 2.5)


def test_disk_unknown_future_schema_is_a_miss(tmp_path):
    d = DiskStore(tmp_path)
    d.path("k").write_text(json.dumps({"schema": 99, **padded(8)}))
    assert d.load("k") is None and d.misses == 1
    assert d.path("k").exists()  # not quarantined — just not ours to parse


def test_evict_reclaims_abandoned_tmp_files(tmp_path):
    """A crashed writer's orphaned ``.tmp`` (hours old) is reclaimed by
    evict(); an in-flight one (fresh mtime) is never touched."""
    d = DiskStore(tmp_path, ttl_seconds=3600.0)
    d.store("aa" * 32, padded(8))
    old = tmp_path / "orphan123.tmp"
    old.write_text("{")
    os.utime(old, (time.time() - 7200, time.time() - 7200))
    fresh = tmp_path / "inflight456.tmp"
    fresh.write_text("{")
    assert d.evict()["tmp"] == 1
    assert not old.exists() and fresh.exists()
    assert "aa" * 32 in d  # records untouched by the tmp sweep


def test_disk_delete(tmp_path):
    d = DiskStore(tmp_path)
    d.store("k", padded(8))
    assert d.delete("k") and not d.delete("k")
    assert d.deletes == 1 and "k" not in d


# ---------------------------------------------------------------------------
# TieredStore — promotion, fast paths, per-tier stats
# ---------------------------------------------------------------------------


def test_memory_tier_hit_performs_no_disk_read(tmp_path):
    t = TieredStore(memory=MemoryStore(8), disk=DiskStore(tmp_path))
    t.store("k", padded(16))
    reads_before = t.disk.reads
    for _ in range(5):
        assert t.load("k") is not None
    assert t.disk.reads == reads_before  # hot hits never touch disk
    assert t.memory.hits == 5
    assert t.stats()["memory"]["hits"] == 5


def test_memory_hits_keep_disk_recency_fresh(tmp_path):
    """Memory-shielded hits must still count as access recency for the
    disk tier's eviction index — otherwise the hottest records look
    coldest to TTL/max-bytes eviction and get evicted from disk first."""
    key = "ab" * 32
    t = TieredStore(memory=MemoryStore(8),
                    disk=DiskStore(tmp_path, ttl_seconds=0.3))
    t.store(key, padded(16))
    reads = t.disk.reads
    for _ in range(3):
        time.sleep(0.2)
        assert t.load(key) is not None   # memory hits the whole time
    assert t.disk.reads == reads         # ...with zero disk I/O
    # 0.6s wall > ttl, but the hits kept the access index fresh
    assert t.disk.evict()["ttl"] == 0
    assert key in t.disk


def test_tiered_local_only_load_skips_peer_probe():
    """The serving fast path (pre-coalescing) reads local tiers only — a
    cold cell must not cost every concurrent thread a peer probe."""
    p = PeerStore(["http://127.0.0.1:9"], timeout=0.2)
    t = TieredStore(memory=MemoryStore(2), peers=p)
    assert t.load("ab" * 32, local_only=True) is None
    assert p.errors == 0 and p.misses == 0   # peer never probed
    assert t.load("ab" * 32) is None
    assert p.errors == 1                     # full read-through does probe


def test_disk_hit_promotes_into_memory(tmp_path):
    disk = DiskStore(tmp_path)
    disk.store("k", padded(16))
    t = TieredStore(memory=MemoryStore(8), disk=disk)  # memory starts cold
    assert t.load("k") is not None   # disk hit, promoted
    reads = disk.reads
    assert t.load("k") is not None   # now a memory hit
    assert disk.reads == reads
    assert t.hits == 2 and t.misses == 0


def test_tiered_delete_and_clear_cover_all_local_tiers(tmp_path):
    t = TieredStore(memory=MemoryStore(8), disk=DiskStore(tmp_path))
    t.store("k", padded(8))
    assert t.delete("k")
    assert t.load("k") is None and t.misses == 1
    t.store("k2", padded(8))
    assert t.clear() == 1
    assert len(t) == 0 and "k2" not in t


def test_tiered_without_disk_uses_null_lock():
    t = TieredStore(memory=MemoryStore(8))
    with t.lock("k") as lock:
        assert isinstance(lock, NullLock) and not lock.broke_stale
    t.store("k", padded(8))
    assert t.load("k") is not None and t.root is None


def test_disk_publish_matches_checksum_serialization(tmp_path):
    """Any value record_checksum can serialize (default=str — e.g. a Path)
    must also publish, and a record that can't serialize at all degrades to
    None — never an exception on the serving path."""
    d = DiskStore(tmp_path)
    key = "aa" * 32
    assert d.store(key, padded(8, source_path=Path("/tmp/somewhere"))) \
        is not None
    back = d.load(key)
    assert back["source_path"] == "/tmp/somewhere"
    assert d.hits == 1 and d.quarantined == 0  # checksum verified on read
    circular: dict = {}
    circular["self"] = circular
    assert d._publish("bb" * 32, circular) is None  # swallowed, not raised


def test_valid_key_accepts_only_content_addresses():
    assert valid_key("ab" * 32)
    for bad in ("", "ab" * 31, "AB" * 32, "../secret", "ab" * 32 + "\n",
                "g" * 64, None):
        assert not valid_key(bad)


def test_peer_load_rejects_record_for_a_different_key():
    """A mis-routed peer response (valid envelope, wrong cell) must not
    verify: the checksum covers only the payload, so without the key check
    it would pass and be re-stamped under the requested key downstream —
    permanently caching the wrong mapping."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    served = finalize_record("ee" * 32, dict(REC))

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def do_GET(self):  # noqa: N802 (http.server API)
            body = json.dumps(served).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        p = PeerStore([f"http://127.0.0.1:{httpd.server_address[1]}"])
        assert p.load("ff" * 32) is None   # asked for ff…, served ee…
        assert p.errors == 1 and p.misses == 1
        assert p.load("ee" * 32) == served  # the matching key still verifies
        assert p.hits == 1
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=2.0)


def test_peer_store_degrades_cleanly_when_unreachable():
    p = PeerStore(["http://127.0.0.1:9"], timeout=0.2)
    assert p.load("k") is None
    assert p.errors == 1 and p.misses == 1
    p.store("k", padded(8))  # push failure is counted, never raised
    assert p.push_errors == 1 and p.pushes == 0
    circular: dict = {}
    circular["self"] = circular
    p.store("k2", circular)  # unserializable: also counted, never raised
    assert p.push_errors == 2 and p.pushes == 0
    t = TieredStore(memory=MemoryStore(2), peers=p)
    assert t.load("nope") is None and t.misses == 1


# ---------------------------------------------------------------------------
# Construction surface (env + knobs)
# ---------------------------------------------------------------------------


def test_build_store_assembles_requested_tiers(tmp_path):
    t = build_store(root=tmp_path, ttl_seconds=5.0, max_bytes=1 << 20,
                    memory_entries=7, peers=["http://a:1", "http://b:2/"])
    assert t.memory.max_entries == 7
    assert t.disk.ttl_seconds == 5.0 and t.disk.max_bytes == 1 << 20
    assert t.peer.peers == ["http://a:1", "http://b:2"]
    no_mem = build_store(root=tmp_path, memory_entries=0)
    assert no_mem.memory is None and no_mem.peer is None


def test_build_store_diskless_peer_node(monkeypatch):
    """Cache opt-out + peers = a diskless memory+peer node (read-through
    replication without local persistence) — opt-out with no peers stays
    store-less."""
    monkeypatch.setenv("REPRO_ARTIFACT_CACHE", "off")
    t = build_store(peers=["http://a:1"])
    assert t is not None and t.disk is None
    assert t.memory is not None and t.peer.peers == ["http://a:1"]
    assert build_store() is None


def test_default_store_honors_env_knobs(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_ARTIFACT_CACHE", str(tmp_path))
    monkeypatch.setenv("REPRO_STORE_TTL", "9.5")
    monkeypatch.setenv("REPRO_STORE_MAX_BYTES", "4096")
    monkeypatch.setenv("REPRO_MEMORY_ENTRIES", "3")
    monkeypatch.setenv("REPRO_PEERS", "http://a:1, http://b:2")
    t = default_store()
    assert t.disk.ttl_seconds == 9.5 and t.disk.max_bytes == 4096
    assert t.memory.max_entries == 3
    assert t.peer.peers == ["http://a:1", "http://b:2"]
    assert default_store() is t  # memoized: counters accumulate
    monkeypatch.setenv("REPRO_ARTIFACT_CACHE", "off")
    diskless = default_store()  # peers still configured: diskless node
    assert diskless is not None and diskless.disk is None
    assert diskless.peer.peers == ["http://a:1", "http://b:2"]
    monkeypatch.delenv("REPRO_PEERS")
    assert default_store() is None  # full opt-out


def test_finalize_record_is_idempotent():
    rec = finalize_record("k", dict(REC))
    assert finalize_record("k", rec) is rec
    rekeyed = finalize_record("k2", rec)
    assert rekeyed["key"] == "k2"
    assert rekeyed["checksum"] == rec["checksum"]  # payload unchanged


# ---------------------------------------------------------------------------
# Served lifecycle: the service on a tiered store
# ---------------------------------------------------------------------------


def test_service_hot_path_skips_disk_and_rehydration(tmp_path):
    from repro_torch.serving import MappingService

    svc = MappingService(store=build_store(root=tmp_path),
                         n_validate=2000, sample_every=1)
    first = svc.derive("tri2d", "OSS:120b", 20)
    warm = svc.derive("tri2d", "OSS:120b", 20)     # memory record + rehydrate
    reads = svc.store.disk.reads
    hot = svc.derive("tri2d", "OSS:120b", 20)      # remembered result
    assert svc.store.disk.reads == reads           # no disk read
    assert hot is warm                             # no reconstruction either
    assert not first.cache_hit and warm.cache_hit and hot.cache_hit
    stats = svc.store_stats()
    assert stats["memory"]["result_hits"] == 1
    assert svc.stats.cache_hits == 2


def test_service_survives_memory_eviction_via_disk(tmp_path):
    from repro_torch.serving import MappingService

    svc = MappingService(store=build_store(root=tmp_path, memory_entries=1),
                         n_validate=2000, sample_every=1)
    svc.derive("tri2d", "OSS:120b", 20)
    svc.derive("gasket2d", "OSS:120b", 20)   # evicts tri2d from memory
    res = svc.derive("tri2d", "OSS:120b", 20)
    assert res.cache_hit                     # disk tier caught it
    assert svc.stats.derivations == 2
    assert svc.store.memory.evictions >= 1
    assert svc.store.disk.hits >= 1


@pytest.mark.skipif(os.name != "posix", reason="posix path semantics")
def test_env_int_float_parsers_reject_gracefully(monkeypatch, tmp_path):
    """Empty knob strings mean 'unset', not zero — and a malformed value
    degrades to unset with a warning instead of crashing every store
    construction in the process."""
    monkeypatch.setenv("REPRO_ARTIFACT_CACHE", str(tmp_path))
    monkeypatch.setenv("REPRO_STORE_TTL", "")
    monkeypatch.setenv("REPRO_STORE_MAX_BYTES", " ")
    monkeypatch.delenv("REPRO_MEMORY_ENTRIES", raising=False)
    monkeypatch.delenv("REPRO_PEERS", raising=False)
    t = default_store()
    assert t.disk.ttl_seconds is None and t.disk.max_bytes is None
    assert t.memory.max_entries == 256 and t.peer is None

    monkeypatch.setenv("REPRO_STORE_TTL", "7d")       # not a number
    monkeypatch.setenv("REPRO_STORE_MAX_BYTES", "1G")  # not an integer
    monkeypatch.setenv("REPRO_MEMORY_ENTRIES", "many")
    with pytest.warns(UserWarning, match="malformed"):
        t = default_store()
    assert t.disk.ttl_seconds is None and t.disk.max_bytes is None
    assert t.memory.max_entries == 256


# ---------------------------------------------------------------------------
# One record format for both packages
# ---------------------------------------------------------------------------

KEY = "cd" * 32


def _full_record() -> dict:
    """A real derivation record (the pipeline's schema) from the port."""
    from repro_torch.core.backends import MockLLMBackend
    from repro_torch.core.domains import get_domain
    from repro_torch.core.pipeline import derive_mapping, record_from_result

    res = derive_mapping(get_domain("gasket2d"), MockLLMBackend("OSS:120b"),
                         stage=20, n_validate=2000, cache=None)
    return record_from_result(res)


def test_envelope_constants_and_checksum_equal_reference():
    assert SCHEMA_VERSION == ref_store.SCHEMA_VERSION == 2
    rec = _full_record()
    assert record_checksum(rec) == ref_store.record_checksum(rec)
    assert finalize_record(KEY, dict(rec)) == \
        ref_store.finalize_record(KEY, dict(rec))
    for bad in ("", "ab" * 31, "AB" * 32, "../x", None, KEY):
        assert valid_key(bad) == ref_store.valid_key(bad)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_disk_record_written_by_one_package_loads_in_the_other(tmp_path,
                                                               writer):
    rec = _full_record()
    mine, ref = DiskStore(tmp_path), ref_store.DiskStore(tmp_path)
    w, r = (mine, ref) if writer == "port" else (ref, mine)
    assert w.store(KEY, dict(rec)) is not None
    back = r.load(KEY)
    assert back is not None and r.hits == 1 and r.quarantined == 0
    assert {k: back[k] for k in rec} == rec
    assert back == w.load(KEY)
    # the bytes on disk are one format: the same file either way
    other = tmp_path / "other"
    (ref if writer == "port" else mine).__class__(other).store(KEY, dict(rec))
    assert json.loads((tmp_path / f"{KEY}.json").read_text()) == \
        json.loads((other / f"{KEY}.json").read_text())


def test_tiered_stats_shape_equals_reference(tmp_path):
    mine = build_store(root=tmp_path / "a", memory_entries=4)
    ref = ref_store.build_store(root=tmp_path / "b", memory_entries=4)
    for s in (mine, ref):
        s.store(KEY, padded(8))
        s.load(KEY)
        s.load("ef" * 32)
    a, b = mine.stats(), ref.stats()
    assert set(a) == set(b)
    for tier in a:
        if isinstance(a[tier], dict):
            assert set(a[tier]) == set(b[tier]), tier
