"""CompileCache — process-wide cache of bound kernel launchers.

A deployed map only runs at hardware speed if a repeat evaluation skips all
the set-up in front of the kernel: resolving the geometry, loading the
kernel library, packing the launch arguments.  This module caches the bound
launcher (the zero-argument thunk ``build_map_call`` /
``build_membership_call`` return) keyed by everything that changes it:

    (spec fingerprint, tier, shape, block_n, ndigits, dtype,
     interpret, device kind)

where the spec fingerprint is a registry identity (``domain:<name>`` /
``entry:<domain>:<logic>``).  A repeat evaluation with an identical key
costs one dict hit plus the launch.

Persistence: the JAX package serializes compiled executables to disk with
``jax.export``.  A bound launcher has no such form (the CUDA library itself
is cached on disk by content hash, see ``kernels/domain_map/kernel.py``),
so ``persist_dir`` is accepted and reported but nothing is written there,
and the ``disk_*`` counters stay 0.

Concurrency: per-key in-flight coalescing — N threads asking for one cold
key trigger exactly one build; everyone shares the launcher.

Env surface (read by :func:`default_compile_cache`):

    REPRO_COMPILE_CACHE_ENTRIES   LRU capacity (default 128; 0 disables)
    REPRO_COMPILE_CACHE_DIR       accepted for parity; nothing is persisted
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import hashlib
import os
import threading
import time
import warnings
from pathlib import Path
from typing import Any, Callable

import torch

DEFAULT_MAX_ENTRIES = 128

#: sentinel: "use the process-default cache" (None = bypass caching)
USE_DEFAULT = object()


@functools.lru_cache(maxsize=1)
def device_kind() -> str:
    """The accelerator identity baked into every key — a launcher bound for
    one device kind must never serve another."""
    if torch.cuda.is_available():
        return f"cuda:{torch.cuda.get_device_name(0)}"
    return "cpu:cpu"


def spec_fingerprint(spec) -> str:
    """Identity of a map spec, for launcher keying: ``entry:<domain>:<logic>``
    for a ``MapEntry``, ``domain:<name>`` for a ``str`` / ``Domain``."""
    from repro_torch.core.artifact import resolve_spec

    domain, logic = resolve_spec(spec)
    if logic is None:
        return f"domain:{domain}"
    return f"entry:{domain}:{logic}"


@dataclasses.dataclass(frozen=True)
class ExecKey:
    """Everything that changes the bound launcher."""

    fingerprint: str          # spec_fingerprint(spec)
    tier: str                 # "map" | "membership"
    shape: tuple[int, ...]    # padded output extent (and box extent)
    block_n: int
    ndigits: int
    dtype: str = "int32"
    interpret: bool = False
    device: str = dataclasses.field(default_factory=device_kind)

    def digest(self) -> str:
        """Stable digest of every field."""
        payload = "|".join(
            str(p) for p in (self.fingerprint, self.tier, self.shape,
                             self.block_n, self.ndigits, self.dtype,
                             self.interpret, self.device))
        return hashlib.sha256(payload.encode()).hexdigest()


@dataclasses.dataclass
class CompileCacheStats:
    """Counters for the /metrics surface (all cumulative)."""

    hits: int = 0            # served from the in-memory LRU
    misses: int = 0          # full build paid
    coalesced: int = 0       # waited on another thread's in-flight build
    evictions: int = 0       # LRU entries dropped at capacity
    disk_hits: int = 0       # always 0: launchers are not persisted
    disk_stores: int = 0     # always 0
    disk_errors: int = 0     # always 0
    trace_seconds: float = 0.0   # total time spent building launchers

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        total = self.hits + self.misses + self.disk_hits
        d["hit_ratio"] = ((self.hits + self.disk_hits) / total
                          if total else 0.0)
        return d


class _InFlight:
    __slots__ = ("event", "fn", "error")

    def __init__(self):
        self.event = threading.Event()
        self.fn: Callable | None = None
        self.error: BaseException | None = None


class CompileCache:
    """Bounded LRU of bound zero-argument launchers.

    ``get(key, build)`` returns the launcher for ``key``; ``build`` is a
    zero-argument callable returning it (e.g. a closure over
    ``build_map_call``), called at most once per key while the entry is
    resident."""

    def __init__(self, max_entries: int = DEFAULT_MAX_ENTRIES,
                 persist_dir: str | Path | None = None):
        self.max_entries = max_entries
        self.persist_dir = Path(persist_dir) if persist_dir else None
        self.stats = CompileCacheStats()
        self._entries: collections.OrderedDict[ExecKey, Callable] = \
            collections.OrderedDict()
        self._inflight: dict[ExecKey, _InFlight] = {}
        self._mu = threading.Lock()

    def __len__(self) -> int:
        with self._mu:
            return len(self._entries)

    def __contains__(self, key: ExecKey) -> bool:
        with self._mu:
            return key in self._entries

    def keys(self) -> list[ExecKey]:
        with self._mu:
            return list(self._entries)

    # -- lookup ------------------------------------------------------------
    def get(self, key: ExecKey, build: Callable[[], Callable]) -> Callable:
        """The launcher for ``key`` (building it via ``build()`` at most
        once, coalescing concurrent cold callers)."""
        with self._mu:
            fn = self._entries.get(key)
            if fn is not None:
                self._entries.move_to_end(key)
                self.stats.hits += 1
                return fn
            fl = self._inflight.get(key)
            leader = fl is None
            if leader:
                fl = self._inflight[key] = _InFlight()
        if not leader:
            fl.event.wait()
            with self._mu:
                self.stats.coalesced += 1
            if fl.error is not None:
                raise fl.error
            return fl.fn  # type: ignore[return-value]
        try:
            t0 = time.perf_counter()
            fn = build()
            dt = time.perf_counter() - t0
            with self._mu:
                self.stats.misses += 1
                self.stats.trace_seconds += dt
                self._entries[key] = fn
                self._entries.move_to_end(key)
                while len(self._entries) > max(self.max_entries, 1):
                    self._entries.popitem(last=False)
                    self.stats.evictions += 1
            fl.fn = fn
            return fn
        except BaseException as e:
            fl.error = e
            raise
        finally:
            with self._mu:
                self._inflight.pop(key, None)
            fl.event.set()

    # -- introspection -----------------------------------------------------
    def clear(self) -> int:
        with self._mu:
            n = len(self._entries)
            self._entries.clear()
        return n

    def stats_dict(self) -> dict[str, Any]:
        with self._mu:
            out = self.stats.as_dict()
            out["entries"] = len(self._entries)
        out["max_entries"] = self.max_entries
        out["persist_dir"] = str(self.persist_dir) if self.persist_dir \
            else None
        return out


# ---------------------------------------------------------------------------
# process default
# ---------------------------------------------------------------------------

_default: CompileCache | None = None
_default_off = False  # configure_default(0) disables the process default
_default_mu = threading.Lock()


def _env_int(name: str, fallback: int) -> int:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return fallback
    try:
        return int(raw)
    except ValueError:
        warnings.warn(f"ignoring malformed {name}={raw!r}", stacklevel=2)
        return fallback


def default_compile_cache() -> CompileCache | None:
    """The process-wide cache (REPRO_COMPILE_CACHE_* env knobs).  Returns
    None when REPRO_COMPILE_CACHE_ENTRIES=0 — caching explicitly off."""
    global _default
    with _default_mu:
        if _default_off:
            return None
        if _default is None:
            entries = _env_int("REPRO_COMPILE_CACHE_ENTRIES",
                               DEFAULT_MAX_ENTRIES)
            if entries <= 0:
                return None
            persist = os.environ.get("REPRO_COMPILE_CACHE_DIR", "").strip() \
                or None
            _default = CompileCache(max_entries=entries, persist_dir=persist)
        return _default


def configure_default(max_entries: int | None = None,
                      persist_dir: str | Path | None = None
                      ) -> CompileCache | None:
    """Rebuild the process default from explicit knobs.
    ``max_entries=0`` disables caching process-wide."""
    global _default, _default_off
    with _default_mu:
        entries = max_entries if max_entries is not None else _env_int(
            "REPRO_COMPILE_CACHE_ENTRIES", DEFAULT_MAX_ENTRIES)
        if entries <= 0:
            _default = None
            _default_off = True
            return None
        if persist_dir is None:
            persist_dir = os.environ.get(
                "REPRO_COMPILE_CACHE_DIR", "").strip() or None
        _default_off = False
        _default = CompileCache(max_entries=entries, persist_dir=persist_dir)
        return _default


def resolve(cache) -> CompileCache | None:
    """Normalize a ``compile_cache=`` argument: the USE_DEFAULT sentinel ->
    process default, None -> bypass, a CompileCache -> itself."""
    if cache is USE_DEFAULT:
        return default_compile_cache()
    return cache
