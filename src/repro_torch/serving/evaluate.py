"""EvaluationService — the batched map-evaluation hot path.

It accepts batches of heterogeneous queries — each a ``(domain, tier,
λ-range / box extent)`` — and executes them the way deployed kernels want
to be executed:

  * **executable grouping** — queries that resolve to the same launcher
    family (same spec identity, tier, block size, interpret mode) are
    merged: the group runs ONE kernel launch padded to the widest member,
    and every member slices its answer out of the shared device buffer.  A
    batch of 20 tri2d prefix queries costs one launch.
  * **async dispatch across groups** — all group launches are enqueued
    before any host transfer, so heterogeneous groups queue back to back on
    the card; there is exactly one device->host transfer per group.
  * **launcher cache** — resolution goes through
    :mod:`repro_torch.core.compile_cache`, so a warm query pays a dict hit
    + a launch (see ``kernels/domain_map/ops.py``).
  * **sweeps** — ``sweep`` streams one result per (domain × n_points) cell.
    Every cell runs on one card; the JAX package's multi-device split of a
    cell's λ-range is not ported yet.

Query schema (one dict per query; the wire form of ``POST /v1/evaluate``):

    {"domain": "tri2d",            # or "key": "<64-hex content address>"
     "tier": "map",                # "map" (default) | "membership"
     "n_points": 4096,             # map tier: λ-range length
     "start": 0,                   # map tier: λ-range offset (default 0)
     "extent": [64, 64],           # membership tier: bounding-box extent
     "block_n": 1024,              # optional; kernel block size
     "interpret": null}            # optional; null/false: the CUDA kernel,
                                   # true: its plain version on the CPU

``domain`` queries run the registry's ground-truth geometry.  ``key``
queries name a derived artifact by content address; the artifact store is
not ported yet, so this evaluator answers them as the JAX package's does
with no store attached.  ``"interpret": null`` never picks the CPU on its
own: without a card such a query fails and names ``"interpret": true``.
"""
from __future__ import annotations

import dataclasses
import json
import threading
from typing import Iterable, Iterator, Sequence

import numpy as np

import torch

from repro_torch.core import compile_cache as cc
from repro_torch.core.domains import DOMAINS, Domain
from repro_torch.core.store import valid_key
from repro_torch.kernels.domain_map import ops
from repro_torch.kernels.domain_map.kernel import NO_CARD

#: hard ceiling on one query's output size — a JSON-serialized answer past
#: this is a transport problem, not an evaluation problem (use sweeps).
MAX_POINTS = 1 << 21

TIERS = ("map", "membership")


@dataclasses.dataclass
class EvalStats:
    """Cumulative counters for the /metrics surface."""

    queries: int = 0          # individual queries admitted
    batches: int = 0          # evaluate_batch calls
    groups: int = 0           # executable groups dispatched
    shared: int = 0           # queries that rode another query's dispatch
    points: int = 0           # points asked for (pre-padding)
    padded_points: int = 0    # points computed (post-padding/merging)
    sweep_cells: int = 0      # cells streamed by sweep()
    sharded_dispatches: int = 0  # multi-device dispatches (not ported: 0)
    errors: int = 0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["padding_overhead"] = (
            (self.padded_points - self.points) / self.padded_points
            if self.padded_points else 0.0)
        return d


@dataclasses.dataclass
class _Plan:
    """One admitted query, fully resolved for grouping."""

    index: int
    spec: object              # str domain name
    domain: Domain
    tier: str
    n_points: int             # valid points requested (box total for BB)
    start: int
    extent: tuple[int, ...] | None
    block_n: int
    interpret: bool
    padded: int
    ndigits: int
    fingerprint: str

    @property
    def group_key(self) -> tuple:
        if self.tier == "membership":
            # a box kernel's unravel strides bake the extent into the
            # lowering — only identical boxes share an executable
            return (self.fingerprint, "membership", self.extent,
                    self.block_n, self.interpret)
        # map-tier prefix queries share freely: the widest member's output
        # contains every narrower member's answer
        return (self.fingerprint, "map", self.start, self.block_n,
                self.interpret)

    @property
    def wire_key(self) -> tuple:
        """The full answer identity (group identity + this member's exact
        λ-range/extent) — what a cached wire blob is keyed by.  Two queries
        with equal wire keys get byte-identical responses."""
        return (*self.group_key, self.n_points, self.start)


class EvaluationService:
    """Batched evaluation of thread maps over cached kernel launchers."""

    def __init__(self, compile_cache=cc.USE_DEFAULT,
                 max_points: int = MAX_POINTS,
                 default_block_n: int = 1024):
        self.cache = cc.resolve(compile_cache)
        self.max_points = max_points
        self.default_block_n = default_block_n
        self.stats = EvalStats()
        self._mu = threading.Lock()

    # -- query admission ---------------------------------------------------
    def _resolve_spec(self, q: dict):
        key = q.get("key")
        if key is not None:
            if not isinstance(key, str) or not valid_key(key):
                raise ValueError(
                    "'key' must be a 64-hex artifact content address")
            raise ValueError(
                "this evaluator cannot resolve artifact keys "
                "(no store attached)")
        domain = q.get("domain")
        if not isinstance(domain, str):
            raise ValueError("query must carry string 'domain' or 'key'")
        if domain not in DOMAINS:
            raise KeyError(domain)
        return domain, DOMAINS[domain]

    def _plan(self, index: int, q: dict) -> _Plan:
        if not isinstance(q, dict):
            raise ValueError("each query must be a JSON object")
        spec, dom = self._resolve_spec(q)
        tier = q.get("tier", "map")
        if tier not in TIERS:
            raise ValueError(f"'tier' must be one of {TIERS}, got {tier!r}")
        block_n = q.get("block_n", self.default_block_n)
        if not isinstance(block_n, int) or isinstance(block_n, bool) \
                or block_n <= 0:
            raise ValueError("'block_n' must be a positive integer")
        interpret = q.get("interpret")
        if interpret is None:
            interpret = False
        if not isinstance(interpret, bool):
            raise ValueError("'interpret' must be a boolean")
        if tier == "membership":
            extent = q.get("extent")
            if (not isinstance(extent, (list, tuple)) or not extent
                    or not all(isinstance(e, int) and not isinstance(e, bool)
                               and e > 0 for e in extent)):
                raise ValueError("membership queries need 'extent': a "
                                 "non-empty list of positive integers")
            if len(extent) != dom.dim:
                raise ValueError(
                    f"extent has {len(extent)} axes; domain "
                    f"{dom.name!r} is {dom.dim}-dimensional")
            total = int(np.prod(extent))
            if total > self.max_points:
                raise ValueError(
                    f"extent covers {total} cells > max {self.max_points}")
            _, padded, ndigits = ops.membership_plan(
                spec, tuple(extent), block_n)
            return _Plan(index, spec, dom, tier, total, 0, tuple(extent),
                         block_n, interpret, padded, ndigits,
                         cc.spec_fingerprint(spec))
        n_points = q.get("n_points")
        if not isinstance(n_points, int) or isinstance(n_points, bool) \
                or n_points <= 0:
            raise ValueError("map queries need 'n_points': a positive "
                             "integer")
        if n_points > self.max_points:
            raise ValueError(
                f"n_points {n_points} > max {self.max_points}")
        start = q.get("start", 0)
        if not isinstance(start, int) or isinstance(start, bool) \
                or start < 0:
            raise ValueError("'start' must be a non-negative integer")
        _, padded, ndigits = ops.map_plan(spec, n_points, block_n, start)
        return _Plan(index, spec, dom, tier, n_points, start, None,
                     block_n, interpret, padded, ndigits,
                     cc.spec_fingerprint(spec))

    # -- execution ---------------------------------------------------------
    def _group_executable(self, plans: list[_Plan]):
        """One launcher covering every plan in the group (padded
        to the widest member, digits to the deepest member — both exact:
        extra λ range is sliced away, extra digit layers contribute zero)."""
        lead = plans[0]
        padded = max(p.padded for p in plans)
        ndigits = max(p.ndigits for p in plans)
        before = self.cache.stats.misses + self.cache.stats.disk_hits \
            if self.cache is not None else 0
        if lead.tier == "membership":
            call = ops.membership_executable(
                lead.spec, lead.extent, padded, lead.block_n, ndigits,
                lead.interpret, compile_cache=self.cache)
        else:
            call = ops.mapped_executable(
                lead.spec, padded, lead.block_n, ndigits, lead.interpret,
                start=lead.start, compile_cache=self.cache)
        compiled_fresh = self.cache is not None and (
            self.cache.stats.misses + self.cache.stats.disk_hits > before)
        return call, padded, ndigits, compiled_fresh

    def evaluate_batch(self, queries: Sequence[dict]
                       ) -> tuple[list[dict], dict]:
        """Evaluate a heterogeneous batch: ``(results, batch_meta)``.

        Results arrive in query order; each carries its coordinates/mask as
        a numpy array plus grouping/caching provenance.  A malformed query
        fails the whole batch (``ValueError``); an unknown domain raises
        ``KeyError``; a kernel query where there is no card raises
        ``RuntimeError`` — all before any launch."""
        if not queries:
            raise ValueError("empty query batch")
        try:
            plans = [self._plan(i, q) for i, q in enumerate(queries)]
            if not all(p.interpret for p in plans) \
                    and not torch.cuda.is_available():
                raise RuntimeError(NO_CARD)
        except Exception:
            with self._mu:
                self.stats.errors += 1
            raise
        groups: dict[tuple, list[_Plan]] = {}
        for p in plans:
            groups.setdefault(p.group_key, []).append(p)

        # phase 1 — launch every group (queued on the card's stream; no host
        # transfer yet)
        launched = []
        for members in groups.values():
            call, padded, ndigits, fresh = self._group_executable(members)
            launched.append((members, call(), padded, ndigits, fresh))

        # phase 2 — one transfer per group, then pure-host slicing
        results: list[dict] = [None] * len(plans)  # type: ignore[list-item]
        for gid, (members, out_dev, padded, ndigits, fresh) in \
                enumerate(launched):
            out = out_dev.cpu().numpy()
            for p in members:
                if p.tier == "membership":
                    # the kernel's int32 0/1 column is logically boolean —
                    # publish it as bool_ (1 byte/cell on the wire) and let
                    # the dtype ride the payload so clients round-trip it
                    data = {"mask": out[0, :p.n_points].astype(np.bool_)}
                else:
                    data = {"coords": out[:p.domain.dim, :p.n_points].T}
                results[p.index] = {
                    "index": p.index,
                    "domain": p.domain.name,
                    "tier": p.tier,
                    "n_points": p.n_points,
                    "start": p.start,
                    "extent": list(p.extent) if p.extent else None,
                    "block_n": p.block_n,
                    "ndigits": ndigits,
                    "padded": padded,
                    "interpret": p.interpret,
                    "group": gid,
                    "group_size": len(members),
                    "executable": "miss" if fresh else "hit",
                    **data,
                }
        with self._mu:
            self.stats.queries += len(plans)
            self.stats.batches += 1
            self.stats.groups += len(groups)
            self.stats.shared += len(plans) - len(groups)
            self.stats.points += sum(p.n_points for p in plans)
            # per dispatched query: every member of a group is served from
            # the group's padded launch, so a group of k queries padded to
            # P accounts k*P — keeping padded_points >= points and the
            # derived padding_overhead in [0, 1) even when merging wins
            self.stats.padded_points += sum(
                lp * len(members) for (members, _, lp, _, _) in launched)
        meta = {
            "queries": len(plans),
            "groups": len(groups),
            "dispatches": len(groups),
        }
        return results, meta

    def evaluate(self, query: dict) -> dict:
        """Single-query form of :meth:`evaluate_batch`."""
        results, _ = self.evaluate_batch([query])
        return results[0]

    # -- wire-cache identity -------------------------------------------------
    def batch_cache_key(self, queries: Sequence[dict]
                        ) -> tuple[tuple, tuple[str, ...]] | None:
        """``(batch identity, artifact keys)`` for the frontends' encoded-
        response LRU: per member the resolved launcher group plus the exact
        λ-range/extent, so equal keys guarantee byte-identical answers.
        ``None`` when any query fails admission — the caller falls through
        to :meth:`evaluate_batch`, which raises the authoritative error.
        No artifact keys until the artifact store is ported.  Planning is
        pure resolution (dict lookups + arithmetic, no launch)."""
        try:
            plans = [self._plan(i, q) for i, q in enumerate(queries)]
        except Exception:  # noqa: BLE001 — identity only, never authoritative
            return None
        return tuple(p.wire_key for p in plans), ()

    def cache_generation(self) -> int:
        """Compile-cache eviction count — the generation stamp that expires
        frontend wire blobs when the launcher LRU rotates (a cached
        response's ``executable: hit`` provenance is only honest while the
        launchers it rode are still resident)."""
        return self.cache.stats.evictions if self.cache is not None else 0

    # -- sweeps ------------------------------------------------------------
    def sweep(self, domains: Iterable[str], sizes: Iterable[int],
              tier: str = "map", block_n: int | None = None,
              interpret: bool | None = None) -> Iterator[dict]:
        """Grid sweep over (domain × n_points), streaming one result per
        cell — the NDJSON surface of ``POST /v1/evaluate``.  Every cell
        runs on one card."""
        domains = list(domains)
        sizes = [int(s) for s in sizes]
        if not domains or not sizes:
            raise ValueError("sweep needs non-empty 'domains' and sizes")
        for name in domains:
            for n in sizes:
                q = {"domain": name, "n_points": n, "tier": tier}
                if block_n is not None:
                    q["block_n"] = block_n
                if interpret is not None:
                    q["interpret"] = interpret
                res = self.evaluate(q)
                with self._mu:
                    self.stats.sweep_cells += 1
                yield res

    # -- introspection -----------------------------------------------------
    def stats_dict(self) -> dict:
        with self._mu:
            out = self.stats.as_dict()
        if self.cache is not None:
            out["compile_cache"] = self.cache.stats_dict()
        return out


def wire_result(res: dict) -> dict:
    """JSON-safe form of one evaluation result: arrays become lists, and a
    ``dtype`` side-channel records each array's native dtype so the client
    rehydrates exactly what the server computed (the binary codec carries
    the same identity in its segment header)."""
    out = dict(res)
    dtypes = {}
    for field in ("coords", "mask"):
        if out.get(field) is not None:
            arr = np.asarray(out[field])
            dtypes[field] = arr.dtype.name
            out[field] = arr.tolist()
    if dtypes:
        out["dtype"] = dtypes
    return out


def encoded_batch_response(evaluator: EvaluationService, cache,
                           queries: Sequence[dict], *, single: bool,
                           binary: bool) -> bytes:
    """Evaluate a (single|batch) request straight to encoded response
    bytes, through an optional :class:`~repro_torch.serving.wire.WireCache` —
    the one evaluate hot path both frontends share, so the threaded and
    asyncio servers can never disagree on bytes.

    Cache policy mirrors the async frontend's derive blob cache: only
    responses whose every member rode an already-compiled executable
    (``executable: hit``) are cached — a first-launch response truthfully
    says ``miss`` exactly once, and repeats cache the honest rehydrated
    bytes.  Entries are keyed by resolved executable group + λ-range and
    generation-stamped against compile-cache eviction."""
    from repro_torch.serving import wire

    cell = None
    identity = evaluator.batch_cache_key(queries) if cache is not None \
        else None
    if identity is not None:
        cell = ("bin" if binary else "json",
                "single" if single else "batch", identity[0])
        blob = cache.get(cell, evaluator.cache_generation())
        if blob is not None:
            return blob
    results, meta = evaluator.evaluate_batch(list(queries))
    if binary:
        payload = results[0] if single \
            else {"results": results, "batch": meta}
        blob = wire.encode_frame(payload)
    else:
        payload = wire_result(results[0]) if single \
            else {"results": [wire_result(r) for r in results],
                  "batch": meta}
        blob = json.dumps(payload, default=str).encode()
    if cell is not None and all(r.get("executable") == "hit"
                                for r in results):
        cache.put(cell, blob, evaluator.cache_generation(),
                  artifact_keys=identity[1])
    return blob


def hydrate_result(payload: dict) -> dict:
    """Client-side inverse of :func:`wire_result`.  Dtypes come from the
    payload's ``dtype`` field; against an older server that doesn't send
    one, int32 (those servers also computed int32) keeps the round-trip
    faithful rather than guessed."""
    out = dict(payload)
    dtypes = out.pop("dtype", None) or {}
    for field, fallback in (("coords", np.int32), ("mask", np.int32)):
        val = out.get(field)
        if val is not None and not isinstance(val, np.ndarray):
            out[field] = np.asarray(
                val, dtype=np.dtype(dtypes.get(field, fallback)))
    return out
