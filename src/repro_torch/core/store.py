"""Tiered ArtifactStore — the storage layer behind derivation serving.

The paper's economics are "derive once, serve forever": the one-time LLM
inference cost amortizes only while derived mappings stay cheap to fetch
under heavy traffic.  This module turns the original flat on-disk cache
into an :class:`ArtifactStore` interface with composable tiers:

  * :class:`MemoryStore`  — bounded LRU of parsed records (plus the
    rehydrated ``DerivationResult`` once a consumer attaches it), so a hot
    hit costs a dict lookup: no disk I/O, no JSON parse, no rehydration;
  * :class:`DiskStore`    — the content-addressed directory, now with a
    schema-versioned + checksummed record format, TTL and max-bytes
    eviction driven by an access-time index, quarantine of
    checksum-mismatched records, and in-place migration of pre-versioned
    (schema 1) records;
  * :class:`PeerStore`    — read-through fetch from sibling servers over
    the HTTP surface (``GET /v1/replicate/<key>``), with best-effort
    write-back push (``POST /v1/replicate/<key>``) on local publish, so a
    fleet of servers shares one derivation;
  * :class:`TieredStore`  — memory -> disk -> peers composition with
    read-through promotion and per-tier hit/miss/eviction stats.

Record format (schema 2):  ``{"schema": 2, "key": <addr>, "checksum":
sha256(payload), ...payload}`` — the checksum covers everything except the
envelope fields, so silent corruption is detected (and quarantined) rather
than served.  Schema-1 records (the unversioned format) are migrated on first
read.

All I/O degrades gracefully: a read-only disk, an unreachable peer, or a
corrupt record each behave like a miss — never an exception on the serving
path.
"""
from __future__ import annotations

import collections
import hashlib
import json
import os
import re
import tempfile
import threading
import time
import urllib.error
import urllib.request
import warnings
from pathlib import Path
from typing import Any, Callable, Iterable

from repro_torch.obs import trace as obs_trace

SCHEMA_VERSION = 2
_ENVELOPE_FIELDS = ("schema", "key", "checksum")

# a writer holds a publish .tmp for milliseconds; one this old was
# abandoned by a crashed process and is reclaimable garbage
_ORPHAN_TMP_SECONDS = 3600.0

# Content addresses are sha256 hex digests (see cache_key) — anything else
# is rejected before it can reach a filesystem path, so a wire-supplied key
# like "../../etc/passwd" can never escape a store root.
KEY_RE = re.compile(r"[0-9a-f]{64}")


def valid_key(key: str) -> bool:
    """True iff ``key`` is a well-formed content address."""
    return isinstance(key, str) and KEY_RE.fullmatch(key) is not None


def cache_key(domain: str, model: str, stage: int, prompt: str,
              **extra: Any) -> str:
    """Content address of one derivation cell."""
    payload = {
        "domain": domain, "model": model, "stage": stage,
        "prompt_sha256": hashlib.sha256(prompt.encode()).hexdigest(),
        **extra,
    }
    blob = json.dumps(payload, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()


def record_checksum(record: dict[str, Any]) -> str:
    """sha256 over the record payload (envelope fields excluded), so the
    checksum survives re-keying and schema stamping."""
    payload = {k: v for k, v in record.items() if k not in _ENVELOPE_FIELDS}
    blob = json.dumps(payload, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()


def verify_envelope(key: str, rec: Any) -> bool:
    """The full envelope check applied at every trust boundary (peer
    reads, replication pushes): a dict stamped with the current schema,
    keyed as expected, whose checksum matches its payload.  One helper so
    a future schema bump can't weaken one boundary while tightening
    another."""
    return (isinstance(rec, dict)
            and rec.get("schema") == SCHEMA_VERSION
            and rec.get("key") == key
            and rec.get("checksum") == record_checksum(rec))


def finalize_record(key: str, record: dict[str, Any]) -> dict[str, Any]:
    """Stamp the storage envelope (schema version, key, payload checksum).
    Idempotent: an already-finalized record passes through untouched, so
    tier-to-tier promotion never re-hashes."""
    if (record.get("schema") == SCHEMA_VERSION and record.get("key") == key
            and "checksum" in record):
        return record
    payload = {k: v for k, v in record.items() if k not in _ENVELOPE_FIELDS}
    return {"schema": SCHEMA_VERSION, "key": key,
            "checksum": record_checksum(payload), **payload}


# ---------------------------------------------------------------------------
# File locking — many clients, one artifact store
# ---------------------------------------------------------------------------


class FileLock:
    """Advisory cross-process lock: an O_CREAT|O_EXCL sentinel file.

    Combined with the store's atomic-rename publish this makes the store
    safe for concurrent writers: the lock serializes *derivation* of one key
    across processes while readers stay lock-free (they only ever see a
    fully-published record or a miss).

    Ownership: each acquirer writes a unique token into the sentinel.  A
    heartbeat thread refreshes the sentinel's mtime while held, so only a
    genuinely crashed holder ever looks stale; a stale lock is broken by
    atomic rename (exactly one contender wins the break), and ``release``
    verifies the token so a holder whose lock *was* broken never deletes the
    next holder's sentinel.  All I/O degrades gracefully — an unwritable
    store yields an unlocked no-op lock, matching the store's read-only
    degradation."""

    def __init__(self, path: str | Path, timeout: float = 30.0,
                 poll: float = 0.02, stale_seconds: float = 60.0):
        self.path = Path(path)
        self.timeout = timeout
        self.poll = poll
        self.stale_seconds = stale_seconds
        self.locked = False
        self.broke_stale = False
        self.token = f"{os.getpid()}-{os.urandom(8).hex()}"
        self._hb_stop: "threading.Event | None" = None
        self._hb_thread: "threading.Thread | None" = None

    def acquire(self) -> "FileLock":
        deadline = time.monotonic() + self.timeout
        while True:
            created = False
            try:
                self.path.parent.mkdir(parents=True, exist_ok=True)
                fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                created = True
                with os.fdopen(fd, "w") as f:
                    f.write(self.token)
                self.locked = True
                self._start_heartbeat()
                return self
            except FileExistsError:
                if self._break_if_stale():
                    continue
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"lock {self.path} held past {self.timeout}s "
                        f"(stale threshold {self.stale_seconds}s)")
                time.sleep(self.poll)
            except OSError:
                # unwritable store: proceed unlocked (read-only degradation);
                # never leave an ownerless sentinel behind if the open
                # succeeded but the token write failed (e.g. ENOSPC)
                if created:
                    try:
                        self.path.unlink()
                    except OSError:
                        pass
                return self

    def _start_heartbeat(self) -> None:
        """Refresh the sentinel's mtime while held, so contenders never
        mistake a long-running live derivation for a crashed holder."""
        self._hb_stop = stop = threading.Event()
        interval = max(self.stale_seconds / 4.0, 0.05)

        def beat(path=self.path):
            while not stop.wait(interval):
                try:
                    os.utime(path)
                except OSError:
                    return  # lock gone (broken or released) — stop beating

        self._hb_thread = threading.Thread(
            target=beat, name=f"filelock-hb-{self.path.name}", daemon=True)
        self._hb_thread.start()

    def _break_if_stale(self) -> bool:
        try:
            age = time.time() - self.path.stat().st_mtime
        except OSError:
            return True  # holder released between our open and stat
        if age <= self.stale_seconds:
            return False
        # atomic rename: of N contenders observing the same stale sentinel,
        # exactly one wins the break — the losers see ENOENT and re-contend
        # without ever touching the winner's fresh lock.
        grave = self.path.with_name(
            f"{self.path.name}.stale-{os.urandom(4).hex()}")
        try:
            os.replace(self.path, grave)
        except OSError:
            return True  # someone else broke or released it first
        self.broke_stale = True
        try:
            grave.unlink()
        except OSError:
            pass
        return True

    def release(self) -> None:
        if not self.locked:
            return
        self.locked = False
        if self._hb_stop is not None:
            self._hb_stop.set()
            self._hb_thread.join()
        try:
            if self.path.read_text() == self.token:  # still ours?
                self.path.unlink()
        except OSError:
            pass

    def __enter__(self) -> "FileLock":
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


class NullLock:
    """No-op stand-in for stores without a disk tier (same surface as
    :class:`FileLock` so the serving layer never branches)."""

    locked = False
    broke_stale = False

    def acquire(self) -> "NullLock":
        return self

    def release(self) -> None:
        pass

    def __enter__(self) -> "NullLock":
        return self

    def __exit__(self, *exc) -> None:
        pass


# ---------------------------------------------------------------------------
# The store interface
# ---------------------------------------------------------------------------


class ArtifactStore:
    """Interface every tier implements.  Values are JSON-able derivation
    records (see ``pipeline.record_from_result``); keys are content
    addresses from :func:`cache_key`.  All methods are miss-on-failure."""

    def load(self, key: str) -> dict[str, Any] | None:
        raise NotImplementedError

    def store(self, key: str, record: dict[str, Any]):
        raise NotImplementedError

    def delete(self, key: str) -> bool:
        return False

    def clear(self) -> int:
        return 0

    def stats(self) -> dict[str, Any]:
        return {}

    def keys(self) -> list[str]:
        """The tier's resident content addresses (the anti-entropy manifest
        surface).  Remote tiers return [] — a manifest is always local."""
        return []

    # -- optional fast paths (memory tier) ---------------------------------
    def load_result(self, key: str):
        """Rehydrated-result fast path: the object a previous consumer
        attached via :meth:`remember_result`, or None."""
        return None

    def remember_result(self, key: str, result) -> None:
        """Attach a rehydrated result to a resident entry (no-op unless a
        memory tier holds the key)."""

    def note_access(self, key: str) -> None:
        """Record access recency without serving the record (no-op unless
        the tier keeps an eviction index, like :class:`DiskStore`)."""

    # -- optional coordination (disk tier) ---------------------------------
    def lock(self, key: str, timeout: float = 30.0,
             stale_seconds: float = 60.0):
        return NullLock()

    def __contains__(self, key: str) -> bool:
        return self.load(key) is not None


# ---------------------------------------------------------------------------
# MemoryStore — bounded LRU hot tier
# ---------------------------------------------------------------------------


class _MemEntry:
    __slots__ = ("record", "result")

    def __init__(self, record: dict[str, Any]):
        self.record = record
        self.result = None  # rehydrated DerivationResult, attached lazily


class MemoryStore(ArtifactStore):
    """Bounded LRU of parsed records + rehydrated results.

    A hot hit here skips disk I/O and JSON parsing entirely; once the
    serving layer attaches the rehydrated result it also skips dataclass
    reconstruction.  ``max_entries <= 0`` disables the tier (every load is
    a miss, stores are dropped) so one code path serves memory-less
    configurations."""

    def __init__(self, max_entries: int = 256):
        self.max_entries = max_entries
        self._entries: "collections.OrderedDict[str, _MemEntry]" = \
            collections.OrderedDict()
        self._mu = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.result_hits = 0
        self.evictions = 0

    def load(self, key: str) -> dict[str, Any] | None:
        with self._mu:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return entry.record

    def load_result(self, key: str):
        with self._mu:
            entry = self._entries.get(key)
            if entry is None or entry.result is None:
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            self.result_hits += 1
            return entry.result

    def remember_result(self, key: str, result) -> None:
        with self._mu:
            entry = self._entries.get(key)
            if entry is not None:
                entry.result = result

    def store(self, key: str, record: dict[str, Any]) -> None:
        if self.max_entries <= 0:
            return
        record = finalize_record(key, record)
        with self._mu:
            self._entries.pop(key, None)
            self._entries[key] = _MemEntry(record)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)  # least recently used
                self.evictions += 1

    def delete(self, key: str) -> bool:
        with self._mu:
            return self._entries.pop(key, None) is not None

    def clear(self) -> int:
        with self._mu:
            n = len(self._entries)
            self._entries.clear()
            return n

    def keys(self) -> list[str]:
        """LRU order, least-recent first (test/introspection surface)."""
        with self._mu:
            return list(self._entries)

    def __len__(self) -> int:
        with self._mu:
            return len(self._entries)

    def __contains__(self, key: str) -> bool:
        with self._mu:
            return key in self._entries

    def stats(self) -> dict[str, Any]:
        with self._mu:
            entries = len(self._entries)
        return {"hits": self.hits, "misses": self.misses,
                "result_hits": self.result_hits, "evictions": self.evictions,
                "entries": entries, "max_entries": self.max_entries}


# ---------------------------------------------------------------------------
# DiskStore — versioned, checksummed, evicting content-addressed directory
# ---------------------------------------------------------------------------


class DiskStore(ArtifactStore):
    """Content-addressed on-disk store of derivation records.

    Layout:     ``<root>/<key>.json`` (schema-2 records: envelope + payload
    checksum); ``<key>.lock`` writer sentinels; ``<key>.quarantined``
    checksum-mismatched records set aside for inspection.

    Lifecycle:  ``ttl_seconds`` evicts records idle past the threshold;
    ``max_bytes`` evicts least-recently-accessed records until the store
    fits.  Both are driven by an access-time index: in-process access times
    backed by the record file's mtime (``load`` touches the file, so access
    recency survives process restarts and is shared across processes).
    Eviction runs opportunistically after each publish and via ``evict()``.

    Migration:  schema-1 records (pre-checksum caches) are upgraded in
    place on first read.  Unknown future schemas are a miss.

    All I/O degrades gracefully: a read-only or corrupt store behaves like
    a miss."""

    def __init__(self, root: str | Path | None = None,
                 ttl_seconds: float | None = None,
                 max_bytes: int | None = None):
        if root is None:
            # a constructor can't opt out — under REPRO_ARTIFACT_CACHE=off
            # the *callers* (build_store/default_store) return None instead
            root = resolve_root() or (
                Path.home() / ".cache" / "repro_thread_maps")
        self.root = Path(root)
        self.ttl_seconds = ttl_seconds
        self.max_bytes = max_bytes
        self._access: dict[str, float] = {}
        # eviction amortization: approximate on-disk byte total maintained
        # incrementally (None = unknown, next publish runs a full scan) and
        # the time of the last TTL sweep — so a publish is O(1) unless a
        # budget may actually be exceeded (see store()/evict())
        self._approx_bytes: int | None = None
        self._last_ttl_scan = 0.0
        self._mu = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.reads = 0          # actual record-file reads (hot-path probe)
        self.migrated = 0
        self.quarantined = 0
        self.evictions_ttl = 0
        self.evictions_bytes = 0
        self.deletes = 0

    # -- paths -------------------------------------------------------------
    def path(self, key: str) -> Path:
        return self.root / f"{key}.json"

    def lock(self, key: str, timeout: float = 30.0,
             stale_seconds: float = 60.0) -> FileLock:
        """Cross-process writer lock for one key (see :class:`FileLock`).
        Readers never need it — ``store`` publishes via atomic rename."""
        return FileLock(self.root / f"{key}.lock", timeout=timeout,
                        stale_seconds=stale_seconds)

    # -- read path ---------------------------------------------------------
    def load(self, key: str) -> dict[str, Any] | None:
        path = self.path(key)
        self.reads += 1
        try:
            rec = json.loads(path.read_text())
        except (OSError, ValueError):
            self.misses += 1
            return None
        schema = rec.get("schema")
        if schema == 1:
            rec = self._migrate(key, rec)
        elif schema != SCHEMA_VERSION:
            self.misses += 1
            return None
        elif rec.get("checksum") != record_checksum(rec):
            self._quarantine(key, path)
            self.misses += 1
            return None
        self._touch(key, path)
        self.hits += 1
        return rec

    def _migrate(self, key: str, rec: dict[str, Any]) -> dict[str, Any]:
        """Upgrade a schema-1 record in place: same payload, new envelope
        (version + checksum).  The rewrite is best-effort — a read-only
        store still serves the migrated record from memory."""
        payload = {k: v for k, v in rec.items() if k not in _ENVELOPE_FIELDS}
        rec = finalize_record(key, payload)
        self._publish(key, rec)
        self.migrated += 1
        return rec

    def _quarantine(self, key: str, path: Path) -> None:
        """Set a checksum-mismatched record aside (never serve, never
        silently destroy — the bytes may matter for diagnosis)."""
        try:
            os.replace(path, self.root / f"{key}.quarantined")
        except OSError:
            pass
        with self._mu:
            self._access.pop(key, None)
        self.quarantined += 1

    def _touch(self, key: str, path: Path) -> None:
        with self._mu:
            self._access[key] = time.time()
        try:
            os.utime(path)  # persist access recency across processes
        except OSError:
            pass

    def note_access(self, key: str) -> None:
        """Record access recency without any disk I/O (in-process index
        only).  The memory tier calls this on hot hits so the hottest
        records don't look coldest to this process's TTL/max-bytes
        eviction; cross-process recency still comes from ``load``'s mtime
        touch."""
        with self._mu:
            self._access[key] = time.time()

    # -- write path --------------------------------------------------------
    def store(self, key: str, record: dict[str, Any]) -> Path | None:
        record = finalize_record(key, record)
        prev_size = 0
        if self.max_bytes is not None:
            # a republish overwrites: count the delta, not the full size,
            # or the running total inflates until every publish scans
            try:
                prev_size = self.path(key).stat().st_size
            except OSError:
                prev_size = 0
        path = self._publish(key, record)
        if path is not None:
            now = time.time()
            with self._mu:
                self._access[key] = now
            if self._needs_evict_scan(path, now, prev_size):
                self.evict(now)
        return path

    def _needs_evict_scan(self, published: Path, now: float,
                          prev_size: int) -> bool:
        """Whether this publish must pay a full directory sweep.  The
        running byte total and last-TTL-sweep clock keep the common case
        O(1): scan only when the approximate total may exceed the budget,
        a TTL window has elapsed since the last sweep, or the total is
        unknown (first publish / after clear())."""
        if self.ttl_seconds is None and self.max_bytes is None:
            return False
        if self.ttl_seconds is not None \
                and now - self._last_ttl_scan >= self.ttl_seconds:
            return True
        if self.max_bytes is None:
            return False
        try:
            size = published.stat().st_size
        except OSError:
            return True  # can't track incrementally — fall back to a scan
        with self._mu:
            if self._approx_bytes is None:
                return True
            self._approx_bytes += size - prev_size
            return self._approx_bytes > self.max_bytes

    def _publish(self, key: str, record: dict[str, Any]) -> Path | None:
        path = self.path(key)
        tmp = None
        published = False
        try:
            self.root.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                # default=str matches record_checksum's serialization, so any
                # value that checksummed is also publishable; the broad except
                # keeps the never-raise contract for whatever still slips
                # through (e.g. a circular payload)
                json.dump(record, f, indent=1, default=str)
            os.replace(tmp, path)  # atomic publish
            published = True
        except (OSError, TypeError, ValueError):
            return None
        finally:
            if tmp is not None and not published:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
        return path

    def delete(self, key: str) -> bool:
        path = self.path(key)
        try:
            size = path.stat().st_size
        except OSError:
            size = None
        with self._mu:
            self._access.pop(key, None)
        try:
            path.unlink()
        except OSError:
            return False
        with self._mu:
            if self._approx_bytes is not None:
                self._approx_bytes = (max(0, self._approx_bytes - size)
                                      if size is not None else None)
        self.deletes += 1
        return True

    # -- lifecycle ---------------------------------------------------------
    def evict(self, now: float | None = None) -> dict[str, int]:
        """Apply TTL then max-bytes eviction over the access-time index.
        Candidates are published ``*.json`` records and ``*.quarantined``
        files (the budget covers real disk use; quarantined bytes must not
        accumulate past it) — live ``.lock`` sentinels and in-flight
        ``.tmp`` files are never touched, but a ``.tmp`` abandoned by a
        crashed writer (hours old) is reclaimed so repeated crashes can't
        leak disk forever.  Under byte pressure quarantined files go first
        (they are never served), then records in least-recently-accessed
        order.  Returns per-policy counts."""
        now = time.time() if now is None else now
        removed = {"ttl": 0, "bytes": 0, "tmp": 0}
        self._last_ttl_scan = now
        try:
            for p in self.root.glob("*.tmp"):
                try:
                    if now - p.stat().st_mtime > _ORPHAN_TMP_SECONDS:
                        p.unlink()
                        removed["tmp"] += 1
                except OSError:
                    pass
        except OSError:
            pass

        def scan(pattern: str, indexed: bool) -> list | None:
            out = []
            try:
                globbed = list(self.root.glob(pattern))
            except OSError:
                return None
            for p in globbed:
                try:
                    st = p.stat()
                except OSError:
                    continue
                atime = st.st_mtime
                if indexed:
                    with self._mu:
                        atime = max(atime, self._access.get(p.stem, 0.0))
                out.append((atime, st.st_size, p.stem, p))
            return out

        records = scan("*.json", indexed=True)
        quarantined = scan("*.quarantined", indexed=False)
        if records is None or quarantined is None:
            return removed

        def drop(key: str, path: Path) -> bool:
            with self._mu:
                self._access.pop(key, None)
            try:
                path.unlink()
            except OSError:
                return False
            return True

        if self.ttl_seconds is not None:
            for bucket in (records, quarantined):
                survivors = []
                for atime, size, key, p in bucket:
                    if now - atime > self.ttl_seconds and drop(key, p):
                        removed["ttl"] += 1
                        self.evictions_ttl += 1
                        continue
                    survivors.append((atime, size, key, p))
                bucket[:] = survivors
        total = sum(size for bucket in (records, quarantined)
                    for _, size, _, _ in bucket)
        if self.max_bytes is not None:
            # quarantined first (oldest first), then records by LRA order
            for atime, size, key, p in sorted(quarantined) + sorted(records):
                if total <= self.max_bytes:
                    break
                if drop(key, p):
                    total -= size
                    removed["bytes"] += 1
                    self.evictions_bytes += 1
        with self._mu:
            self._approx_bytes = total  # exact again after a full sweep
        return removed

    def clear(self) -> int:
        """Drop every published record.  Live ``.lock`` sentinels and
        in-flight ``.tmp`` files are never touched — a concurrent writer's
        publish must not race a clear into a crash."""
        n = 0
        for p in self.root.glob("*.json"):
            try:
                p.unlink()
                n += 1
            except OSError:
                pass
        with self._mu:
            self._access.clear()
            self._approx_bytes = None  # quarantined files remain: rescan
        return n

    # -- introspection -----------------------------------------------------
    def usage(self) -> dict[str, int]:
        """Record + quarantine counts and byte totals (globs the directory
        — ops endpoint, not the metrics scrape path).  ``total_bytes`` is
        what the ``max_bytes`` budget is enforced against."""
        out = {"records": 0, "bytes": 0,
               "quarantined_records": 0, "quarantined_bytes": 0}
        for pattern, n_key, b_key in (
                ("*.json", "records", "bytes"),
                ("*.quarantined", "quarantined_records",
                 "quarantined_bytes")):
            try:
                for p in self.root.glob(pattern):
                    try:
                        out[b_key] += p.stat().st_size
                        out[n_key] += 1
                    except OSError:
                        pass
            except OSError:
                pass
        out["total_bytes"] = out["bytes"] + out["quarantined_bytes"]
        return out

    def keys(self) -> list[str]:
        """Published content addresses (quarantined records excluded — a
        manifest must only advertise records the node would actually serve)."""
        try:
            return sorted(p.stem for p in self.root.glob("*.json")
                          if valid_key(p.stem))
        except OSError:
            return []

    def __contains__(self, key: str) -> bool:
        return self.path(key).exists()

    def __len__(self) -> int:
        try:
            return sum(1 for _ in self.root.glob("*.json"))
        except OSError:
            return 0

    def stats(self) -> dict[str, Any]:
        return {"hits": self.hits, "misses": self.misses, "reads": self.reads,
                "migrated": self.migrated, "quarantined": self.quarantined,
                "evictions_ttl": self.evictions_ttl,
                "evictions_bytes": self.evictions_bytes,
                "deletes": self.deletes, "ttl_seconds": self.ttl_seconds,
                "max_bytes": self.max_bytes}


# ---------------------------------------------------------------------------
# PeerStore — replication across sibling servers
# ---------------------------------------------------------------------------


class PeerStore(ArtifactStore):
    """Read-through fetch from sibling mapping servers, with best-effort
    write-back push on local publish.

    ``load`` asks each peer's replication-pull endpoint in order and
    returns the first checksum-verified record; every failure mode
    (unreachable peer, 404, corrupt payload) moves on to the next peer and
    ultimately degrades to a miss.  ``store`` POSTs the freshly-published
    record so siblings converge without waiting for a pull; push failures
    are counted, never raised — replication is an optimization, not a
    correctness requirement.

    Topology comes from one of two places: the static ``peers`` list (a
    broadcast mesh — every pull probes everyone, every push lands
    everywhere) or, when a ``router`` is attached
    (``ClusterMembership.replica_peers`` of the cluster layer), the
    consistent-hash ring: pulls route to the key's owners and pushes are
    scoped to the K replicas instead of the whole fleet.  The router is
    authoritative while set — an empty owner list means "nobody else should
    hold this key", not "fall back to broadcasting"."""

    def __init__(self, peers: Iterable[str] = (), timeout: float = 2.0,
                 push: bool = True,
                 router: "Callable[[str], list[str]] | None" = None):
        self.peers = [u.rstrip("/") for u in peers if u]
        self.timeout = timeout
        self.push = push
        self.router = router
        self.hits = 0
        self.misses = 0
        self.errors = 0
        self.pushes = 0
        self.push_errors = 0

    def targets(self, key: str) -> list[str]:
        """The sibling URLs a pull/push for ``key`` addresses: the ring
        owners when a router is attached, else every static peer."""
        if self.router is not None:
            return [u.rstrip("/") for u in self.router(key) if u]
        return self.peers

    def load(self, key: str) -> dict[str, Any] | None:
        with obs_trace.span("store_peer") as sp:
            rec = self._load(key, sp)
            sp["hit"] = rec is not None
        return rec

    def _load(self, key: str, sp: dict) -> dict[str, Any] | None:
        for peer in self.targets(key):
            req = urllib.request.Request(
                f"{peer}/v1/replicate/{key}",
                # carry the active trace across the pull so the sibling's
                # replicate_pull span lands under the same ID
                headers=obs_trace.wire_headers())
            try:
                with urllib.request.urlopen(  # noqa: S310 — operator-set URL
                        req, timeout=self.timeout) as resp:
                    rec = json.loads(resp.read())
            except urllib.error.HTTPError as e:
                if e.code != 404:
                    self.errors += 1
                continue
            except (urllib.error.URLError, ConnectionError, TimeoutError,
                    OSError, ValueError):
                self.errors += 1
                continue
            if not verify_envelope(key, rec):
                # peer served junk — or a record for a *different* cell (the
                # checksum covers only the payload, so a mis-keyed response
                # would otherwise verify and then be re-stamped under the
                # requested key by store_local, permanently caching the
                # wrong mapping).  Either way: don't replicate it.
                self.errors += 1
                continue
            self.hits += 1
            sp["peer"] = peer
            return rec
        self.misses += 1
        return None

    def store(self, key: str, record: dict[str, Any]) -> None:
        targets = self.targets(key) if self.push else []
        if not targets:
            return
        try:
            body = json.dumps(finalize_record(key, record),
                              default=str).encode()
        except (TypeError, ValueError):
            # unserializable record: every peer push fails, none raises —
            # same degradation as DiskStore._publish
            self.push_errors += len(targets)
            return
        for peer in targets:
            req = urllib.request.Request(
                f"{peer}/v1/replicate/{key}", data=body, method="POST",
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(  # noqa: S310
                        req, timeout=self.timeout):
                    pass
                self.pushes += 1
            except (urllib.error.URLError, ConnectionError, TimeoutError,
                    OSError):
                self.push_errors += 1

    def stats(self) -> dict[str, Any]:
        return {"hits": self.hits, "misses": self.misses,
                "errors": self.errors, "pushes": self.pushes,
                "push_errors": self.push_errors, "peers": list(self.peers),
                "routed": self.router is not None}


# ---------------------------------------------------------------------------
# TieredStore — memory -> disk -> peers, with read-through promotion
# ---------------------------------------------------------------------------


class TieredStore(ArtifactStore):
    """Composition of the tiers: loads fall through memory -> disk ->
    peers, promoting the record into every faster tier on the way back up;
    stores publish to memory + disk and push to peers (write-back).

    ``load_local``/``store_local`` stop at the machine boundary — they are
    what the replication endpoints use, so two peers asking each other can
    never recurse."""

    def __init__(self, memory: MemoryStore | None = None,
                 disk: DiskStore | None = None,
                 peers: PeerStore | None = None):
        self.memory = memory
        self.disk = disk
        self.peer = peers
        self.hits = 0    # aggregate: resolved by any tier
        self.misses = 0  # aggregate: missed every tier

    # -- identity / compat -------------------------------------------------
    @property
    def root(self) -> Path | None:
        return self.disk.root if self.disk is not None else None

    def path(self, key: str) -> Path | None:
        return self.disk.path(key) if self.disk is not None else None

    def lock(self, key: str, timeout: float = 30.0,
             stale_seconds: float = 60.0):
        if self.disk is not None:
            return self.disk.lock(key, timeout=timeout,
                                  stale_seconds=stale_seconds)
        return NullLock()

    # -- read path ---------------------------------------------------------
    def load_local(self, key: str) -> dict[str, Any] | None:
        """Memory -> disk only (the replication-pull surface: a peer's
        question must never trigger our own peer fetch)."""
        if self.memory is not None:
            with obs_trace.span("store_memory") as sp:
                rec = self.memory.load(key)
                sp["hit"] = rec is not None
            if rec is not None:
                if self.disk is not None:
                    # keep the disk tier's eviction index truthful for
                    # memory-shielded hits (index write only — hot hits
                    # still do zero disk I/O)
                    self.disk.note_access(key)
                return rec
        if self.disk is not None:
            with obs_trace.span("store_disk") as sp:
                rec = self.disk.load(key)
                sp["hit"] = rec is not None
            if rec is not None:
                if self.memory is not None:
                    self.memory.store(key, rec)
                return rec
        return None

    def load(self, key: str,
             local_only: bool = False) -> dict[str, Any] | None:
        """Full read-through (``local_only=True`` skips the peer tier —
        the serving layer's lock-free fast path uses it so N concurrent
        cold requests don't each pay the peer probe; the coalescing leader
        probes peers exactly once)."""
        rec = self.load_local(key)
        if rec is None and not local_only and self.peer is not None:
            rec = self.peer.load(key)
            if rec is not None:
                self.store_local(key, rec)  # replicate onto this node
        if rec is None:
            self.misses += 1
        else:
            self.hits += 1
        return rec

    def load_result(self, key: str):
        if self.memory is None:
            return None
        res = self.memory.load_result(key)
        if res is not None:
            if self.disk is not None:
                self.disk.note_access(key)
            self.hits += 1
        return res

    def remember_result(self, key: str, result) -> None:
        if self.memory is not None:
            self.memory.remember_result(key, result)

    # -- write path --------------------------------------------------------
    def store_local(self, key: str, record: dict[str, Any]) -> Path | None:
        record = finalize_record(key, record)
        path = None
        if self.disk is not None:
            path = self.disk.store(key, record)
        if self.memory is not None:
            self.memory.store(key, record)
        return path

    def store(self, key: str, record: dict[str, Any]) -> Path | None:
        record = finalize_record(key, record)
        path = self.store_local(key, record)
        if self.peer is not None:
            self.peer.store(key, record)  # write-back to siblings
        return path

    def delete(self, key: str) -> bool:
        """Drop the record from this node's tiers (peers keep theirs —
        DELETE is a per-node ops action, not a cluster broadcast)."""
        dropped = False
        if self.memory is not None:
            dropped = self.memory.delete(key) or dropped
        if self.disk is not None:
            dropped = self.disk.delete(key) or dropped
        return dropped

    def clear(self) -> int:
        n = 0
        if self.memory is not None:
            self.memory.clear()
        if self.disk is not None:
            n = self.disk.clear()
        return n

    def evict(self) -> dict[str, int]:
        if self.disk is not None:
            return self.disk.evict()
        return {"ttl": 0, "bytes": 0, "tmp": 0}

    # -- introspection -----------------------------------------------------
    def keys(self) -> list[str]:
        """This node's manifest: every content address resident in a local
        tier (what ``GET /v1/replicate/manifest`` advertises to peers —
        the peer tier is deliberately excluded, a manifest never proxies)."""
        out = set(self.disk.keys()) if self.disk is not None else set()
        if self.memory is not None:
            out.update(k for k in self.memory.keys() if valid_key(k))
        return sorted(out)

    def __contains__(self, key: str) -> bool:
        if self.memory is not None and key in self.memory:
            return True
        return self.disk is not None and key in self.disk

    def __len__(self) -> int:
        if self.disk is not None:
            return len(self.disk)
        return len(self.memory) if self.memory is not None else 0

    def usage(self) -> dict[str, int]:
        return self.disk.usage() if self.disk is not None else \
            {"records": len(self), "bytes": 0}

    def stats(self) -> dict[str, Any]:
        return {
            "hits": self.hits, "misses": self.misses,
            "memory": self.memory.stats() if self.memory is not None else None,
            "disk": self.disk.stats() if self.disk is not None else None,
            "peer": self.peer.stats() if self.peer is not None else None,
        }


# ---------------------------------------------------------------------------
# Construction helpers
# ---------------------------------------------------------------------------


def resolve_root(root: str | Path | None = None) -> Path | None:
    """The disk root for a store: an explicit argument wins, else
    $REPRO_ARTIFACT_CACHE, else the home-cache default.  None means the
    operator opted out of persistence entirely."""
    if root is not None:
        return Path(root)
    env = os.environ.get("REPRO_ARTIFACT_CACHE", "")
    if env.strip().lower() in ("off", "0", "none", "disabled"):
        return None
    return Path(env) if env else Path.home() / ".cache" / "repro_thread_maps"


def split_peers(spec: "str | Iterable[str] | None") -> list[str]:
    """Peer URLs from a comma-separated string (the CLI/env surface) or an
    iterable, empty entries dropped."""
    if spec is None:
        return []
    if isinstance(spec, str):
        spec = spec.split(",")
    return [u.strip() for u in spec if u and u.strip()]


def as_tiered(store, memory_entries: int = 256) -> "TieredStore | None":
    """Normalize any store-ish object into a TieredStore (None passes
    through).  A bare disk-level store gains a memory hot tier; an existing
    TieredStore is used as-is."""
    if store is None or isinstance(store, TieredStore):
        return store
    if isinstance(store, MemoryStore):
        return TieredStore(memory=store)
    memory = MemoryStore(memory_entries) if memory_entries > 0 else None
    return TieredStore(memory=memory, disk=store)


def build_store(root: str | Path | None = None,
                ttl_seconds: float | None = None,
                max_bytes: int | None = None,
                memory_entries: int = 256,
                peers: "str | Iterable[str] | None" = (),
                peer_timeout: float = 2.0,
                peer_push: bool = True) -> TieredStore | None:
    """Assemble a TieredStore from knobs (the CLI / env surface).  Returns
    None when the root resolves to the cache opt-out and no peers are
    configured; opt-out *with* peers builds a diskless memory+peer node
    (read-through replication without local persistence)."""
    root = resolve_root(root)
    peers = split_peers(peers)
    if root is None and not peers:
        return None
    return TieredStore(
        memory=MemoryStore(memory_entries) if memory_entries > 0 else None,
        disk=DiskStore(root, ttl_seconds=ttl_seconds, max_bytes=max_bytes)
        if root is not None else None,
        peers=PeerStore(peers, timeout=peer_timeout,
                        push=peer_push) if peers else None,
    )


_DEFAULT_STORES: dict[tuple, TieredStore] = {}


def _env_float(name: str) -> float | None:
    val = os.environ.get(name, "").strip()
    if not val:
        return None
    try:
        return float(val)
    except ValueError:
        # a malformed knob degrades to unset, it must not crash every
        # store construction in the process (same never-raise contract as
        # the I/O paths) — but say so, the operator meant something
        warnings.warn(f"ignoring malformed {name}={val!r}: expected a number",
                      stacklevel=2)
        return None


def _env_int(name: str, default: int | None = None) -> int | None:
    val = os.environ.get(name, "").strip()
    if not val:
        return default
    try:
        return int(val)
    except ValueError:
        warnings.warn(f"ignoring malformed {name}={val!r}: expected an "
                      "integer", stacklevel=2)
        return default


def env_knobs() -> dict[str, Any]:
    """The documented lifecycle env surface, parsed once for every
    consumer (``default_store`` and the serve CLI, so flag/env pairs can
    never diverge):

    ``REPRO_STORE_TTL``        idle-eviction threshold, seconds,
    ``REPRO_STORE_MAX_BYTES``  disk budget, bytes,
    ``REPRO_MEMORY_ENTRIES``   LRU hot-tier capacity (0 disables),
    ``REPRO_PEERS``            comma-separated sibling server URLs."""
    return {
        "ttl_seconds": _env_float("REPRO_STORE_TTL"),
        "max_bytes": _env_int("REPRO_STORE_MAX_BYTES"),
        "memory_entries": _env_int("REPRO_MEMORY_ENTRIES", 256),
        "peers": split_peers(os.environ.get("REPRO_PEERS")),
    }


def default_store() -> TieredStore | None:
    """Process-default tiered store honoring ``REPRO_ARTIFACT_CACHE``
    (disk root; opt-out with "off"/"0"/"none") plus the :func:`env_knobs`
    lifecycle surface.

    One instance per knob combination, so tier counters accumulate across
    calls (and across `derive_mapping` / `MappingService` / benchmarks in
    one process)."""
    root = resolve_root()
    knobs = env_knobs()
    if root is None and not knobs["peers"]:
        return None  # full opt-out: no persistence and nobody to ask
    memo = (str(root), knobs["ttl_seconds"], knobs["max_bytes"],
            knobs["memory_entries"], tuple(knobs["peers"]))
    if memo not in _DEFAULT_STORES:
        _DEFAULT_STORES[memo] = build_store(root, **knobs)
    return _DEFAULT_STORES[memo]
