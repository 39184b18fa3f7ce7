"""Consistent-hash sharded fleet: ring placement, membership, anti-entropy.

A static replication mesh is not sharded: every node pushes every record
to every ``--peers`` sibling, so a fleet of N servers holds N copies of the
whole store and an operator re-wires flags to grow it.  This module makes the
fleet self-organizing and sharded:

  * :class:`Placement`         — the strategy interface: a deterministic
    ``key -> [owners]`` function over a *weighted* node set (per-node
    ``--weight`` for heterogeneous disk/compute budgets).
    :class:`HashRing` (consistent hashing, weight scales vnode count) is
    the default; :class:`RendezvousHash` (highest-random-weight) is the
    alternative with tighter balance at small N — selected fleet-wide via
    ``--placement`` and carried on the view so clients route identically.
  * :class:`ClusterMembership` — seed-based discovery: a new node is told
    one live node (``--cluster-seed``) and learns the rest through the
    ``GET /v1/cluster`` view-exchange endpoint.  A periodic heartbeat
    probes a deterministic-random O(log N) subset per round (the gossip
    fanout cap — membership traffic grows O(N log N), not O(N²)); a node
    that stops answering past ``down_after`` is marked down and drops out
    of the ring, and a rejoining node (same URL) is folded back in on its
    first successful probe.  Views piggyback each node's weight and live
    load (queue depth), which is what feeds the load-aware replica
    selector in :mod:`repro_torch.serving.router`.
  * anti-entropy repair        — every ``sync_interval`` the node exchanges
    key manifests (``GET /v1/replicate/manifest``) with its live peers and
    pulls any record it *owns* but lacks.  That is how a node recovers
    publishes it missed while down, and how the fleet restores the
    replication factor after an owner dies (the ring reassigns the key; the
    new owner repairs itself from the surviving replica) — all with zero
    additional LLM inferences.

Ownership is advisory, not authoritative: every node can still serve any
record it holds, and a node that cannot reach an owner derives locally.
The ring only decides *placement* (who stores what) and *routing* (where
to look first) — correctness never depends on two nodes agreeing on the
view, because records are immutable per content address.
"""
from __future__ import annotations

import bisect
import hashlib
import json
import math
import random
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Callable, Iterable
from urllib.parse import quote

from repro_torch.core.store import valid_key, verify_envelope

DEFAULT_VNODES = 64
DEFAULT_REPLICAS = 2

#: placement strategies selectable via ``--placement`` / the view payload
PLACEMENTS = ("ring", "rendezvous")


def _hash(data: str) -> int:
    """Ring position of a node vnode or a record key: the first 8 bytes of
    sha256, so every node (and the client) computes identical placements
    from the same view."""
    return int.from_bytes(hashlib.sha256(data.encode()).digest()[:8], "big")


class Placement:
    """What the fleet needs from a placement strategy: a deterministic
    ``key -> [owner URLs]`` function over a weighted node set.  Both
    implementations are pure functions of ``(node, weight)`` pairs plus
    their own parameters — insertion order is irrelevant — so any two
    parties holding the same view route identically.  Weights let
    heterogeneous nodes (bigger disk, faster accelerator) claim a
    proportionally larger share of the key space."""

    kind = "placement"

    def __init__(self, nodes: Iterable = (),
                 replicas: int = DEFAULT_REPLICAS):
        self.replicas = max(1, int(replicas))
        self._weights: dict[str, float] = {}
        for node in nodes:
            if isinstance(node, str):
                self.add(node)
            else:  # (url, weight) pair
                self.add(node[0], node[1])

    # -- membership --------------------------------------------------------
    def add(self, node: str, weight: float = 1.0) -> None:
        raise NotImplementedError

    def remove(self, node: str) -> None:
        raise NotImplementedError

    @staticmethod
    def _clamp_weight(weight: float) -> float:
        try:
            weight = float(weight)
        except (TypeError, ValueError):
            weight = 1.0
        if not math.isfinite(weight) or weight <= 0:
            weight = 1.0
        return min(weight, 64.0)  # one node can never dwarf the fleet

    def weight(self, node: str) -> float:
        return self._weights.get(node, 1.0)

    @property
    def weights(self) -> dict[str, float]:
        return dict(self._weights)

    @property
    def nodes(self) -> list[str]:
        return sorted(self._weights)

    def __contains__(self, node: str) -> bool:
        return node in self._weights

    def __len__(self) -> int:
        return len(self._weights)

    # -- placement ---------------------------------------------------------
    def owners(self, key: str, n: int | None = None) -> list[str]:
        """The ``n`` (default ``replicas``) distinct nodes that own ``key``,
        in preference order (primary first).  Empty set -> empty list."""
        raise NotImplementedError

    def primary(self, key: str) -> str | None:
        owners = self.owners(key, 1)
        return owners[0] if owners else None


class HashRing(Placement):
    """Consistent-hash ring with virtual nodes and K-successor placement.

    ``owners(key)`` returns the first ``replicas`` *distinct* nodes
    clockwise from the key's point — fewer when the ring is smaller than K.
    A node's weight scales its vnode count (``round(vnodes * weight)``), so
    a weight-2 node claims ~2x the key space of a weight-1 sibling while a
    join/leave still only remaps keys adjacent to the changed node."""

    kind = "ring"

    def __init__(self, nodes: Iterable = (), vnodes: int = DEFAULT_VNODES,
                 replicas: int = DEFAULT_REPLICAS):
        self.vnodes = max(1, int(vnodes))
        self._points: list[tuple[int, str]] = []  # sorted (position, node)
        super().__init__(nodes, replicas=replicas)

    # -- membership --------------------------------------------------------
    def add(self, node: str, weight: float = 1.0) -> None:
        if node in self:
            return
        weight = self._clamp_weight(weight)
        self._weights[node] = weight
        for i in range(max(1, round(self.vnodes * weight))):
            bisect.insort(self._points, (_hash(f"{node}#{i}"), node))

    def remove(self, node: str) -> None:
        self._weights.pop(node, None)
        self._points = [(p, n) for p, n in self._points if n != node]

    # -- placement ---------------------------------------------------------
    def owners(self, key: str, n: int | None = None) -> list[str]:
        if not self._points:
            return []
        want = self.replicas if n is None else max(1, int(n))
        idx = bisect.bisect_left(self._points, (_hash(key), ""))
        out: list[str] = []
        for step in range(len(self._points)):
            node = self._points[(idx + step) % len(self._points)][1]
            if node not in out:
                out.append(node)
                if len(out) >= want:
                    break
        return out


class RendezvousHash(Placement):
    """Rendezvous (highest-random-weight) placement.

    Every node scores every key independently — ``owners(key)`` is the K
    highest scorers — so there is no ring geometry at all: a join/leave
    remaps exactly the keys the changed node wins/loses, and balance is
    tighter than a vnode ring's at small fleet sizes (no vnode clumping).
    The cost is O(N) hashing per lookup instead of O(log vnodes·N), which
    is why it's the comparison alternative rather than the default: below
    ~100 nodes the difference is noise, and the benchmark row keeps both
    honest.  Weights use the standard ``-w / ln(h)`` transform, giving a
    weight-2 node exactly 2x the win probability per key."""

    kind = "rendezvous"

    def __init__(self, nodes: Iterable = (), vnodes: int = DEFAULT_VNODES,
                 replicas: int = DEFAULT_REPLICAS):
        self.vnodes = max(1, int(vnodes))  # unused; kept for view parity
        super().__init__(nodes, replicas=replicas)

    # -- membership --------------------------------------------------------
    def add(self, node: str, weight: float = 1.0) -> None:
        if node not in self:
            self._weights[node] = self._clamp_weight(weight)

    def remove(self, node: str) -> None:
        self._weights.pop(node, None)

    # -- placement ---------------------------------------------------------
    def _score(self, node: str, weight: float, key: str) -> float:
        # _hash is uniform on [0, 2^64); shift to (0, 1) so ln() is finite
        h = (_hash(f"{node}|{key}") + 1) / float((1 << 64) + 1)
        return -weight / math.log(h)

    def owners(self, key: str, n: int | None = None) -> list[str]:
        if not self._weights:
            return []
        want = self.replicas if n is None else max(1, int(n))
        ranked = sorted(self._weights,
                        key=lambda u: (-self._score(u, self._weights[u], key),
                                       u))
        return ranked[:want]


def make_placement(kind: str, nodes: Iterable = (),
                   vnodes: int = DEFAULT_VNODES,
                   replicas: int = DEFAULT_REPLICAS) -> Placement:
    """Placement factory keyed by the ``placement`` field every node (and
    the ring-aware client) reads off the ``/v1/cluster`` view — the whole
    fleet must run one strategy or two nodes would disagree on owners."""
    kind = (kind or "ring").strip().lower()
    if kind == "rendezvous":
        return RendezvousHash(nodes, vnodes=vnodes, replicas=replicas)
    if kind in ("", "ring"):
        return HashRing(nodes, vnodes=vnodes, replicas=replicas)
    raise ValueError(f"unknown placement {kind!r} (expected one of "
                     f"{', '.join(PLACEMENTS)})")


class _Node:
    """One known fleet member, as seen from this node."""

    __slots__ = ("url", "up", "last_seen", "failures", "weight", "load")

    def __init__(self, url: str):
        self.url = url
        self.up = False
        self.last_seen: float | None = None  # monotonic; None = never
        self.failures = 0                    # consecutive failed probes
        self.weight = 1.0                    # learned from the node's view
        self.load: dict = {}                 # last advertised load snapshot


class ClusterMembership:
    """This node's view of the fleet + the loops that keep it honest.

    ``start()`` launches two daemon threads: the heartbeat loop (probe every
    known node via ``GET /v1/cluster``, merge the URLs each answer reveals,
    mark nodes up/down) and the anti-entropy loop (manifest exchange +
    owned-key repair against live peers).  Both are also callable directly
    (``heartbeat_now`` / ``sync_now``) so tests and operators can force a
    round without waiting out an interval."""

    def __init__(self, self_url: str, seeds: Iterable[str] = (),
                 vnodes: int = DEFAULT_VNODES,
                 replicas: int = DEFAULT_REPLICAS,
                 heartbeat_interval: float = 1.0,
                 down_after: float | None = None,
                 forget_after: float | None = None,
                 sync_interval: float = 5.0,
                 probe_timeout: float = 2.0,
                 store=None,
                 placement: str = "ring",
                 weight: float = 1.0,
                 gossip_fanout: int = 0,
                 load_provider: Callable[[], dict] | None = None,
                 on_load: Callable[[str, dict], Any] | None = None):
        self.self_url = self_url.rstrip("/")
        self.vnodes = max(1, int(vnodes))
        self.replicas = max(1, int(replicas))
        self.placement = (placement or "ring").strip().lower()
        make_placement(self.placement)  # fail fast on an unknown strategy
        self.weight = Placement._clamp_weight(weight)
        # 0 = auto: ceil(log2(N)) + 2, recomputed per round as N changes;
        # <0 = uncapped (probe everyone every round)
        self.gossip_fanout = int(gossip_fanout)
        #: this node's own advertised load (piggybacked on every view);
        #: the HTTP frontends point this at their router's queue snapshot
        self.load_provider = load_provider
        #: callback fed every (url, load) advertisement a probe brings back
        #: — the router's selector learns peer queue depths through it
        self.on_load = on_load
        self.heartbeat_interval = heartbeat_interval
        self.down_after = (3.0 * heartbeat_interval if down_after is None
                           else down_after)
        # a down node is kept (for rejoin tracking) this long past its last
        # successful probe, then forgotten entirely — without this, every
        # decommissioned URL would be probed every round forever
        self.forget_after = (max(30.0, 10.0 * self.down_after)
                             if forget_after is None else forget_after)
        self.sync_interval = sync_interval
        self.probe_timeout = probe_timeout
        self.store = store  # TieredStore (anti-entropy repairs through it)
        self._nodes: dict[str, _Node] = {}
        self._aliases: set[str] = set()  # URLs discovered to be *us*
        self._mu = threading.Lock()
        self._ring = make_placement(
            self.placement, [(self.self_url, self.weight)],
            vnodes=self.vnodes, replicas=self.replicas)
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._probe_cycle: list[str] = []  # pending probe order (capped mode)
        self._cycle_epoch = 0
        # counters
        self.heartbeats = 0
        self.probes_last_round = 0
        self.probe_failures = 0
        self.transitions = 0          # up<->down flips observed
        self.manifest_exchanges = 0
        self.repairs = 0              # records pulled by anti-entropy
        self.repair_errors = 0
        self.rebalanced = 0           # non-owned copies dropped post-churn
        self.forgotten = 0            # dead nodes pruned from the view
        self._seeds: set[str] = set()
        for seed in seeds:
            seed = (seed or "").strip().rstrip("/")
            if seed and seed != self.self_url:
                self._seeds.add(seed)  # seeds are never forgotten: a fleet
                self._nodes[seed] = _Node(seed)  # must form even if the
                # seed boots after its joiners

    # -- ring views --------------------------------------------------------
    def _rebuild_ring(self) -> None:
        """Callers hold ``_mu``."""
        live = [(self.self_url, self.weight)] + [
            (n.url, n.weight) for n in self._nodes.values() if n.up]
        self._ring = make_placement(self.placement, live, vnodes=self.vnodes,
                                    replicas=self.replicas)

    @property
    def ring(self) -> Placement:
        with self._mu:
            return self._ring

    def owners(self, key: str) -> list[str]:
        return self.ring.owners(key)

    def owns(self, key: str) -> bool:
        return self.self_url in self.ring.owners(key)

    def replica_peers(self, key: str) -> list[str]:
        """The owner URLs a :class:`~repro_torch.core.store.PeerStore` should
        route ``key`` to — the K replicas, this node excluded.  This is the
        router that turns static broadcast replication into sharding."""
        return [u for u in self.ring.owners(key) if u != self.self_url]

    def live_peers(self) -> list[str]:
        with self._mu:
            return sorted(n.url for n in self._nodes.values() if n.up)

    # -- view exchange (the /v1/cluster payload) ---------------------------
    def _self_load(self) -> dict:
        provider = self.load_provider
        if provider is None:
            return {}
        try:
            load = provider()
        except Exception:  # noqa: BLE001 — advertising must never 500 a view
            return {}
        return load if isinstance(load, dict) else {}

    def view(self) -> dict[str, Any]:
        now = time.monotonic()
        self_entry = {"url": self.self_url, "status": "up", "self": True,
                      "weight": self.weight, "load": self._self_load()}
        with self._mu:
            nodes = [self_entry]
            for n in sorted(self._nodes.values(), key=lambda n: n.url):
                nodes.append({
                    "url": n.url,
                    "status": "up" if n.up else "down",
                    "age_seconds": (None if n.last_seen is None
                                    else now - n.last_seen),
                    "weight": n.weight,
                    "load": dict(n.load),
                })
        return {"self": self.self_url, "replicas": self.replicas,
                "vnodes": self.vnodes, "placement": self.placement,
                "nodes": nodes}

    def node_loads(self) -> dict[str, dict]:
        """Last advertised load per live peer (the heartbeat piggyback the
        router's selector consumes), self included."""
        with self._mu:
            loads = {n.url: dict(n.load)
                     for n in self._nodes.values() if n.up}
        loads[self.self_url] = self._self_load()
        return loads

    def stats(self) -> dict[str, Any]:
        with self._mu:
            up = sum(1 for n in self._nodes.values() if n.up) + 1
            known = len(self._nodes) + 1
        return {"self": self.self_url, "nodes_up": up, "nodes_known": known,
                "replicas": self.replicas, "vnodes": self.vnodes,
                "placement": self.placement, "weight": self.weight,
                "gossip_fanout": self.effective_fanout(known),
                "probes_last_round": self.probes_last_round,
                "heartbeats": self.heartbeats,
                "probe_failures": self.probe_failures,
                "transitions": self.transitions,
                "manifest_exchanges": self.manifest_exchanges,
                "repairs": self.repairs, "repair_errors": self.repair_errors,
                "rebalanced": self.rebalanced, "forgotten": self.forgotten}

    # -- membership loop ---------------------------------------------------
    def _get_json(self, url: str, path: str):
        with urllib.request.urlopen(  # noqa: S310 — operator-set URLs
                f"{url}{path}", timeout=self.probe_timeout) as resp:
            return json.loads(resp.read())

    def observe(self, url: str) -> None:
        """Fold in a node that just contacted *us* (the ``?from=`` announce
        on a heartbeat probe) as a *candidate*.  This is what makes
        discovery symmetric: a seed learns its joiners the moment they
        first probe it — heartbeats alone only discover in the
        seed->joiner direction.  The candidate joins the ring only once
        our own next heartbeat probes it successfully: an unauthenticated
        announce must never place an unverified URL into routing."""
        url = (url or "").strip().rstrip("/")
        if not url or url == self.self_url:
            return
        with self._mu:
            if url not in self._nodes and url not in self._aliases:
                self._nodes[url] = _Node(url)

    def _probe(self, url: str) -> list[str]:
        """Probe one node; returns the URLs its view revealed (empty on
        failure).  Only URLs the peer itself reports *up* are merged —
        gossiping dead nodes around would keep them probed fleet-wide
        forever.  Up/down transitions and ring rebuilds happen here."""
        try:
            view = self._get_json(
                url, f"/v1/cluster?from={quote(self.self_url, safe='')}")
            if str(view.get("self", "")).rstrip("/") == self.self_url:
                # the "peer" answered as *us*: ``url`` is an alias of this
                # node (e.g. the documented self-seed bootstrap spelled
                # localhost against a 127.0.0.1 bind).  Joining the ring
                # under two names would silently collapse the replication
                # factor — both "replicas" of a key could be one machine.
                with self._mu:
                    self._aliases.add(url)
                    node = self._nodes.pop(url, None)
                    if node is not None and node.up:
                        self.transitions += 1
                        self._rebuild_ring()
                return []
            revealed = [str(n.get("url", "")) for n in view.get("nodes", [])
                        if isinstance(n, dict) and n.get("status") == "up"]
            # the peer's own entry carries its weight + live load snapshot
            weight, load = 1.0, {}
            for entry in view.get("nodes", []):
                if isinstance(entry, dict) and entry.get("self"):
                    weight = Placement._clamp_weight(entry.get("weight", 1.0))
                    load = entry.get("load") or {}
                    break
            ok = True
        except (urllib.error.URLError, ConnectionError, TimeoutError,
                OSError, ValueError):
            revealed, ok = [], False
        now = time.monotonic()
        with self._mu:
            node = self._nodes.get(url)
            if node is None:  # removed concurrently — nothing to record
                return revealed if ok else []
            if ok:
                node.last_seen = now
                node.failures = 0
                node.load = load if isinstance(load, dict) else {}
                reweighted = node.weight != weight
                node.weight = weight
                if not node.up:  # fresh join or rejoin
                    node.up = True
                    self.transitions += 1
                    self._rebuild_ring()
                elif reweighted:  # operator restarted it with a new budget
                    self._rebuild_ring()
            else:
                self.probe_failures += 1
                node.failures += 1
                # a never-seen node is down immediately; a known-good one
                # gets down_after of grace before it leaves the ring
                if node.up and (node.last_seen is None
                                or now - node.last_seen > self.down_after):
                    node.up = False
                    self.transitions += 1
                    self._rebuild_ring()
        if ok and self.on_load is not None:
            try:  # hand the piggybacked load to the router's selector
                self.on_load(url, node.load)
            except Exception:  # noqa: BLE001 — routing hints must not break
                pass           # membership
        return revealed if ok else []

    def _forget_dead(self) -> None:
        """Prune down nodes past ``forget_after`` (and never-seen
        candidates after a few failed probes) so decommissioned URLs stop
        costing a probe per round.  Seeds are exempt: the fleet must still
        form when the seed boots after its joiners.  A pruned node that
        comes back re-announces itself on its own next probe."""
        now = time.monotonic()
        with self._mu:
            for url in list(self._nodes):
                node = self._nodes[url]
                if node.up or url in self._seeds:
                    continue
                dead = (node.failures >= 3 if node.last_seen is None
                        else now - node.last_seen > self.forget_after)
                if dead:
                    del self._nodes[url]
                    self.forgotten += 1

    def effective_fanout(self, n_known: int) -> int:
        """Probes allowed per round: the configured cap, or the O(log N)
        auto cap (``ceil(log2 N) + 2``) when ``gossip_fanout == 0``.  A
        negative setting disables the cap (probe everyone, the pre-adaptive
        behavior).  With the cap, fleet-wide membership traffic is
        O(N log N) per interval instead of O(N²), and a dead node is still
        noticed within ``down_after`` plus one cycle (≤ ``ceil(N/fanout)``
        rounds), because the shuffled cycle visits every node."""
        if self.gossip_fanout > 0:
            return self.gossip_fanout
        if self.gossip_fanout < 0:
            return max(1, n_known)
        return math.ceil(math.log2(max(2, n_known))) + 2

    def _next_probe_targets(self) -> list[str]:
        """The deterministic-random subset this round probes.  A shuffled
        cycle (reshuffled each time it drains, seeded from the node URL and
        a cycle counter) guarantees every known node is visited at least
        once per ``ceil(N/fanout)`` rounds — a plain random sample would
        leave unlucky nodes unprobed for unboundedly long."""
        with self._mu:
            known = set(self._nodes)
        fanout = self.effective_fanout(len(known))
        if fanout >= len(known):
            return sorted(known)
        targets: list[str] = []
        self._probe_cycle = [u for u in self._probe_cycle if u in known]
        for _ in range(2 * len(known)):
            if len(targets) >= fanout:
                break
            if not self._probe_cycle:
                cycle = sorted(known)
                random.Random(_hash(
                    f"{self.self_url}#cycle#{self._cycle_epoch}"
                )).shuffle(cycle)
                self._probe_cycle = cycle
                self._cycle_epoch += 1
            url = self._probe_cycle.pop(0)
            if url not in targets:
                targets.append(url)
        return targets

    def heartbeat_now(self) -> None:
        """One membership round: probe the capped deterministic-random
        subset of known nodes, folding in any URL a view reveals.  Nodes
        never probed before (fresh announces, seed-bootstrap reveals) are
        probed in the same round regardless of the cap, so a single
        heartbeat after a seed bootstrap still reaches the whole fleet —
        the cap only paces the steady-state re-probing that was O(N²)."""
        self.heartbeats += 1
        probed: set[str] = set()

        def probe_one(url: str) -> None:
            probed.add(url)
            for revealed in self._probe(url):
                revealed = revealed.rstrip("/")
                if not revealed or revealed == self.self_url:
                    continue
                with self._mu:
                    if revealed not in self._nodes \
                            and revealed not in self._aliases:
                        self._nodes[revealed] = _Node(revealed)

        for url in self._next_probe_targets():
            if url not in probed:
                probe_one(url)
        while True:  # newcomers revealed mid-round join immediately
            with self._mu:
                fresh = [u for u, n in self._nodes.items()
                         if u not in probed and n.last_seen is None
                         and n.failures == 0]
            if not fresh:
                break
            for url in fresh:
                probe_one(url)
        self.probes_last_round = len(probed)
        self._forget_dead()

    # -- anti-entropy repair -----------------------------------------------
    def sync_now(self) -> int:
        """One repair round: exchange key manifests with every live peer,
        pull each record this node owns but lacks, then drop local copies
        of records this node does *not* own once every owner verifiably
        holds them (self-healing back to exactly K copies after churn —
        e.g. the extra replica a node keeps after a dead owner rejoins).
        Returns records repaired."""
        store = self.store
        if store is None:
            return 0
        repaired = 0
        manifests: dict[str, set] = {}  # peer -> keys it advertises
        for peer in self.live_peers():
            try:
                manifest = self._get_json(peer, "/v1/replicate/manifest")
                keys = manifest.get("keys", [])
            except (urllib.error.URLError, ConnectionError, TimeoutError,
                    OSError, ValueError):
                self.repair_errors += 1
                continue
            self.manifest_exchanges += 1
            manifests[peer] = {k for k in keys if valid_key(k)}
            ring = self.ring
            for key in manifests[peer]:
                if self.self_url not in ring.owners(key):
                    continue
                if key in store:  # already resident locally
                    continue
                try:
                    rec = self._get_json(peer, f"/v1/replicate/{key}")
                except (urllib.error.URLError, ConnectionError, TimeoutError,
                        OSError, ValueError):
                    self.repair_errors += 1
                    continue
                if not verify_envelope(key, rec):
                    self.repair_errors += 1
                    continue
                # store_local, not store: a repair pull must never echo a
                # push back out (the surviving replica already holds it)
                store.store_local(key, rec)
                self.repairs += 1
                repaired += 1
        self._rebalance(manifests)
        return repaired

    def _rebalance(self, manifests: dict[str, set]) -> None:
        """Drop local records this node does not own, but only when every
        ring owner's manifest (fetched this round) lists the record *and*
        the primary owner still serves it right now — the manifests may
        have gone stale during the repair pulls (an owner's TTL/size
        eviction could have run meanwhile), and a handoff must never
        destroy what might be the last copy.  Better to keep a stray
        replica than to re-pay an LLM inference."""
        store = self.store
        if store is None or not manifests:
            return
        ring = self.ring
        for key in store.keys():
            owners = ring.owners(key)
            if not owners or self.self_url in owners:
                continue
            if not all(o in manifests and key in manifests[o]
                       for o in owners):
                continue
            try:  # freshness re-check, immediately before the delete
                rec = self._get_json(owners[0], f"/v1/replicate/{key}")
            except (urllib.error.URLError, ConnectionError, TimeoutError,
                    OSError, ValueError):
                continue
            if verify_envelope(key, rec) and store.delete(key):
                self.rebalanced += 1

    # -- lifecycle ---------------------------------------------------------
    def _loop(self, interval: float, tick: Callable[[], Any],
              name: str) -> None:
        thread = threading.Thread(
            name=name, daemon=True,
            target=lambda: self._run_loop(interval, tick))
        self._threads.append(thread)
        thread.start()

    def _run_loop(self, interval: float, tick: Callable[[], Any]) -> None:
        while not self._stop.wait(interval):
            try:
                tick()
            except Exception:  # noqa: BLE001 — loops must survive anything
                pass

    def start(self) -> "ClusterMembership":
        """Bootstrap (one immediate heartbeat so the seed's view lands
        before the first request) and launch the periodic loops."""
        self.heartbeat_now()
        self.sync_now()
        self._loop(self.heartbeat_interval, self.heartbeat_now,
                   "cluster-heartbeat")
        self._loop(self.sync_interval, self.sync_now, "cluster-antientropy")
        return self

    def close(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads.clear()
