"""The port (``repro_torch.serving``) under the cases of
``tests/test_cluster.py``, which hold the JAX package's.

Consistent-hash sharded fleet: ring placement properties, membership
heartbeats + anti-entropy repair, owner forwarding, ring-aware client
routing, and the keep-alive transport's failure behavior.

The acceptance e2e boots a real 3-node ring from one seed and walks the
whole lifecycle: N derives of one cell through different nodes -> exactly
one inference fleet-wide with the record on exactly ``replicas`` nodes;
owner death -> the surviving replica serves and anti-entropy restores the
replication factor; rejoin with a wiped store -> repair refills it — all
with zero additional inferences."""
import hashlib
import threading
import time

import pytest

try:  # prefer real hypothesis; fall back to the deterministic shim
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover
    from _hypothesis_compat import given, settings, st

from repro_torch.core.backends import MockLLMBackend
from repro_torch.core.store import PeerStore, build_store
from repro_torch.serving import (
    ClusterMembership, HashRing, MappingHTTPServer, MappingService,
    RemoteMappingService, RemoteServiceError, RendezvousHash, make_placement,
)

MODEL = "OSS:120b"
N_KEYS = 256


def _keys() -> list[str]:
    return [hashlib.sha256(f"cell-{i}".encode()).hexdigest()
            for i in range(N_KEYS)]


def _await(predicate, timeout: float = 20.0, what: str = "condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


# ---------------------------------------------------------------------------
# HashRing placement properties
# ---------------------------------------------------------------------------


@settings(max_examples=14, deadline=None)
@given(st.integers(min_value=2, max_value=8))
def test_ring_assignment_deterministic_and_balanced(n_nodes):
    """Key->owner assignment is a pure function of the node set (insertion
    order irrelevant), always yields `replicas` distinct owners, and primary
    ownership stays within 2x of the ideal share across 100+ keys."""
    import random

    nodes = [f"http://node-{j}:80" for j in range(n_nodes)]
    shuffled = list(nodes)
    random.Random(n_nodes).shuffle(shuffled)
    ring = HashRing(nodes, vnodes=128, replicas=2)
    reordered = HashRing(shuffled, vnodes=128, replicas=2)
    counts: dict[str, int] = {u: 0 for u in nodes}
    for key in _keys():
        owners = ring.owners(key)
        assert owners == reordered.owners(key)  # deterministic placement
        assert len(owners) == 2 and len(set(owners)) == 2
        counts[owners[0]] += 1
    ideal = N_KEYS / n_nodes
    assert max(counts.values()) <= 2 * ideal, counts
    assert min(counts.values()) >= ideal / 2, counts


@settings(max_examples=14, deadline=None)
@given(st.integers(min_value=2, max_value=8))
def test_ring_join_leave_remaps_only_adjacent_keys(n_nodes):
    """A join moves ~1/(n+1) of the keys, every moved primary moves *to*
    the new node, and no key acquires a different pre-existing owner — the
    no-full-reshuffle property that makes scaling the fleet cheap.  A
    leave is the exact inverse."""
    nodes = [f"http://node-{j}:80" for j in range(n_nodes)]
    newcomer = f"http://node-{n_nodes}:80"
    before = HashRing(nodes, vnodes=128, replicas=2)
    after = HashRing([*nodes, newcomer], vnodes=128, replicas=2)
    moved = 0
    for key in _keys():
        owners_a, owners_b = before.owners(key), after.owners(key)
        assert set(owners_b) <= set(owners_a) | {newcomer}
        if owners_a[0] != owners_b[0]:
            assert owners_b[0] == newcomer  # primaries only move to the join
            moved += 1
    assert 0 < moved <= 2 * N_KEYS / (n_nodes + 1), moved
    shrunk = HashRing([*nodes, newcomer], vnodes=128, replicas=2)
    shrunk.remove(newcomer)
    assert all(shrunk.owners(k) == before.owners(k) for k in _keys())


def test_ring_edge_shapes():
    ring = HashRing(replicas=3)
    assert ring.owners("ab" * 32) == [] and ring.primary("ab" * 32) is None
    ring.add("http://only:1")
    assert ring.owners("ab" * 32) == ["http://only:1"]  # K > nodes: all of them
    ring.add("http://only:1")  # re-add is a no-op, not duplicate vnodes
    assert len(ring) == 1
    ring.remove("http://only:1")
    assert len(ring) == 0 and "http://only:1" not in ring


def test_weighted_ring_scales_keyspace_share():
    """A node's weight scales its vnode count, so a weight-3 node owns
    roughly 3x the primaries of a weight-1 sibling."""
    nodes = [("http://small:1", 1.0), ("http://big:1", 3.0),
             ("http://small2:1", 1.0)]
    ring = HashRing(nodes, vnodes=128, replicas=2)
    assert ring.weight("http://big:1") == 3.0
    counts = {u: 0 for u, _ in nodes}
    for key in _keys():
        counts[ring.owners(key)[0]] += 1
    # big's ideal share is 3/5 of the keyspace; smalls get 1/5 each
    assert counts["http://big:1"] > 1.8 * counts["http://small:1"]
    assert counts["http://big:1"] > 1.8 * counts["http://small2:1"]
    # malformed weights clamp to 1.0 instead of corrupting the ring
    clamped = HashRing([("http://a:1", -2.0), ("http://b:1", float("nan"))],
                       vnodes=64, replicas=2)
    assert clamped.weight("http://a:1") == 1.0
    assert clamped.weight("http://b:1") == 1.0


def test_rendezvous_placement_properties():
    """Rendezvous hashing behind the same Placement interface: same
    determinism/balance/minimal-disruption contract as the ring, plus the
    weighted share."""
    nodes = [f"http://node-{j}:80" for j in range(5)]
    p1 = RendezvousHash(nodes, replicas=2)
    p2 = RendezvousHash(list(reversed(nodes)), replicas=2)
    counts = {u: 0 for u in nodes}
    for key in _keys():
        owners = p1.owners(key)
        assert owners == p2.owners(key)
        assert len(owners) == 2 and len(set(owners)) == 2
        counts[owners[0]] += 1
    ideal = N_KEYS / len(nodes)
    assert max(counts.values()) <= 2 * ideal, counts
    assert min(counts.values()) >= ideal / 2, counts

    # minimal disruption: a leave only reassigns the leaver's keys
    before = {k: p1.owners(k) for k in _keys()}
    p1.remove(nodes[2])
    for key, owners_a in before.items():
        owners_b = p1.owners(key)
        if nodes[2] not in owners_a:
            assert owners_b == owners_a
        else:
            assert set(owners_b) >= set(owners_a) - {nodes[2]}
    # weighted share
    heavy = RendezvousHash([("http://small:1", 1.0), ("http://big:1", 3.0)],
                           replicas=1)
    primaries = sum(1 for k in _keys()
                    if heavy.owners(k)[0] == "http://big:1")
    assert primaries > N_KEYS * 0.6


def test_make_placement_factory():
    ring = make_placement("ring", ["http://a:1"], vnodes=8, replicas=2)
    rdv = make_placement("rendezvous", ["http://a:1"], replicas=2)
    assert isinstance(ring, HashRing) and isinstance(rdv, RendezvousHash)
    assert ring.kind == "ring" and rdv.kind == "rendezvous"
    with pytest.raises(ValueError):
        make_placement("mulberry", ["http://a:1"])


def test_peer_store_router_scopes_targets():
    """With a router attached, pulls/pushes address the key's owners — not
    the static broadcast list; an empty owner list means nobody, not
    everybody."""
    p = PeerStore(["http://static:1"], timeout=0.2,
                  router=lambda key: ["http://a:1/", "http://b:2"])
    assert p.targets("k") == ["http://a:1", "http://b:2"]
    p.router = lambda key: []
    assert p.targets("k") == []
    p.store("k", {"domain": "tri2d"})     # no targets: push is a no-op
    assert p.pushes == 0 and p.push_errors == 0
    p.router = None
    assert p.targets("k") == ["http://static:1"]  # static mesh fallback


# ---------------------------------------------------------------------------
# Client-side key validation (fail fast, no round-trip)
# ---------------------------------------------------------------------------


def test_client_rejects_malformed_keys_locally():
    """A malformed content address raises status=400 *locally* — the URL
    here is unreachable, so any round-trip attempt would surface as a
    transport error (status=None) instead."""
    client = RemoteMappingService("http://127.0.0.1:9", retries=0,
                                  backoff=0.01)
    for method in (client.fetch_artifact, client.delete_artifact,
                   client.pull_record):
        with pytest.raises(RemoteServiceError) as err:
            method("../../etc/passwd")
        assert err.value.status == 400
        assert "invalid key" in str(err.value)
    assert client.stats.remote_requests == 0
    assert client.stats.retries == 0


# ---------------------------------------------------------------------------
# Fleet harness
# ---------------------------------------------------------------------------


class CountingBackend:
    """Thread-safe mock backend counting fleet-wide `generate` calls."""

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


@pytest.fixture()
def counting_backend():
    CountingBackend.calls = 0
    return CountingBackend


def boot_node(tmp_path, name: str, seeds, backend_factory, port: int = 0,
              weight: float = 1.0, gossip_fanout: int = 0,
              placement: str = "ring", serve_delay: float = 0.0,
              router=None):
    """One fleet node: service + HTTP frontend + membership (fast timers)."""
    svc = MappingService(store=build_store(root=tmp_path / name),
                         backend_factory=backend_factory,
                         n_validate=2000, sample_every=1)
    server = MappingHTTPServer(svc, port=port, router=router,
                               serve_delay=serve_delay).start()
    cluster = ClusterMembership(
        server.url, seeds=seeds, replicas=2, vnodes=64,
        heartbeat_interval=0.15, down_after=1.0, sync_interval=0.3,
        probe_timeout=1.0, weight=weight, gossip_fanout=gossip_fanout,
        placement=placement)
    server.attach_cluster(cluster)
    return server


def holders(servers, key: str) -> list[str]:
    """Which nodes list `key` in their replication manifest."""
    out = []
    for s in servers:
        if key in RemoteMappingService(s.url).manifest()["keys"]:
            out.append(s.url)
    return out


# ---------------------------------------------------------------------------
# Acceptance: 3-node ring end to end
# ---------------------------------------------------------------------------


def test_three_node_ring_lifecycle_acceptance(tmp_path, counting_backend):
    """The acceptance scenario, one inference for the whole story:
    seed bootstrap -> sharded placement -> owner death -> repair ->
    rejoin."""
    seed = boot_node(tmp_path, "n0", [], counting_backend)
    servers = [seed,
               boot_node(tmp_path, "n1", [seed.url], counting_backend),
               boot_node(tmp_path, "n2", [seed.url], counting_backend)]
    try:
        _await(lambda: all(len(s.cluster.ring.nodes) == 3 for s in servers),
               what="3-node membership convergence")
        views = [s.cluster.ring.nodes for s in servers]
        assert views[0] == views[1] == views[2]  # one consistent ring

        # -- derive the same cell through every node: ONE inference --------
        key = servers[0].service.request_key("tri2d", MODEL, 20)
        owners = servers[0].cluster.owners(key)
        assert len(owners) == 2
        non_owner = next(s for s in servers if s.url not in owners)
        ordered = [non_owner] + [s for s in servers if s is not non_owner]
        results = [RemoteMappingService(s.url).derive("tri2d", MODEL, 20)
                   for s in ordered]
        assert counting_backend.calls == 1      # fleet-wide single inference
        assert results[0].cache_key == key
        assert all(r.source == results[0].source for r in results)
        assert non_owner.forwarded >= 1         # first hop went to the owner
        fleet_derivations = sum(s.service.stats.derivations for s in servers)
        assert fleet_derivations == 1

        # -- placement: the record lives on exactly `replicas` nodes -------
        _await(lambda: sorted(holders(servers, key)) == sorted(owners),
               what="record on exactly the K owners")
        stats = RemoteMappingService(ordered[1].url).store_stats()
        assert stats["cluster"]["nodes_up"] == 3
        assert stats["cluster"]["replicas"] == 2

        # -- ring-aware client: repeats hash locally, hit the owner --------
        client = RemoteMappingService(non_owner.url)
        client.derive("tri2d", MODEL, 20)       # learns the cell's key
        before = non_owner.forwarded
        repeat = client.derive("tri2d", MODEL, 20)
        assert repeat.cache_hit
        assert client.stats.routed == 1         # went straight to the owner
        assert non_owner.forwarded == before    # no server-side hop needed

        # -- kill the primary owner ----------------------------------------
        dead = next(s for s in servers if s.url == owners[0])
        dead_port = dead.port
        dead.close()
        alive = [s for s in servers if s is not dead]
        _await(lambda: all(len(s.cluster.ring.nodes) == 2 for s in alive),
               what="death detection")

        # anti-entropy restores the replication factor on the smaller ring
        # — before any request touches it, so this is the repair loop, not
        # the derive path's read-through
        _await(lambda: len(holders(alive, key)) == 2,
               what="replication factor restored after owner death")
        assert sum(s.cluster.repairs for s in alive) >= 1
        assert counting_backend.calls == 1

        # the surviving replica set serves the record, zero new inferences
        for s in alive:
            assert RemoteMappingService(s.url).derive(
                "tri2d", MODEL, 20).cache_hit
        assert counting_backend.calls == 1

        # -- rejoin at the same URL with a wiped store ---------------------
        rejoined = boot_node(tmp_path, "n0-rejoined", [alive[0].url],
                             counting_backend, port=dead_port)
        servers = [*alive, rejoined]
        _await(lambda: all(len(s.cluster.ring.nodes) == 3 for s in servers),
               what="rejoin convergence")
        # the rejoined node owns the key again and repairs itself from the
        # surviving replica — without a single new inference
        assert rejoined.url in rejoined.cluster.owners(key)
        _await(lambda: key in rejoined.service.store,
               what="anti-entropy repair onto the rejoined node")
        assert rejoined.cluster.repairs >= 1
        assert counting_backend.calls == 1
        assert rejoined.service.stats.derivations == 0
        # ...and the interim replica (now a non-owner again) hands off: the
        # fleet self-heals back to exactly-K placement on the old owner set
        _await(lambda: sorted(holders(servers, key)) == sorted(owners),
               what="exactly-K placement restored after rejoin")
    finally:
        for s in servers:
            s.close()


def test_sharded_placement_spreads_cells(tmp_path, counting_backend):
    """Different cells land on different owner sets: the fleet holds ~K/N
    of the store per node instead of N full copies (the static broadcast
    mesh's behavior)."""
    seed = boot_node(tmp_path, "s0", [], counting_backend)
    servers = [seed,
               boot_node(tmp_path, "s1", [seed.url], counting_backend),
               boot_node(tmp_path, "s2", [seed.url], counting_backend)]
    try:
        _await(lambda: all(len(s.cluster.ring.nodes) == 3 for s in servers),
               what="membership convergence")
        cells = [("tri2d", 20), ("tri2d", 50), ("gasket2d", 20),
                 ("gasket2d", 50), ("carpet2d", 20), ("msimplex3", 20)]
        client = RemoteMappingService(servers[0].url)
        keys = [client.derive(d, MODEL, s).cache_key for d, s in cells]
        for key in keys:
            _await(lambda k=key: sorted(holders(servers, k)) ==
                   sorted(servers[0].cluster.owners(k)),
                   what="per-cell placement on exactly the K owners")
        # every node's manifest holds exactly its ring-predicted shard —
        # K copies per cell fleet-wide, not the static mesh's N copies
        # (balance across many keys is the hypothesis property test above)
        expected: dict[str, int] = {s.url: 0 for s in servers}
        for key in keys:
            for owner in servers[0].cluster.owners(key):
                expected[owner] += 1
        per_node = {s.url: len(RemoteMappingService(s.url).manifest()["keys"])
                    for s in servers}
        assert per_node == expected
        assert sum(per_node.values()) == 2 * len(cells)
    finally:
        for s in servers:
            s.close()


def test_forwarded_requests_serve_where_they_land(tmp_path, counting_backend):
    """A request carrying the forwarded marker is always served locally —
    two nodes with disagreeing views can never bounce a derive forever."""
    import json
    import urllib.request

    from repro_torch.serving.http import FORWARDED_HEADER

    seed = boot_node(tmp_path, "f0", [], counting_backend)
    other = boot_node(tmp_path, "f1", [seed.url], counting_backend)
    try:
        _await(lambda: all(len(s.cluster.ring.nodes) == 2
                           for s in (seed, other)),
               what="membership convergence")
        key = seed.service.request_key("tri2d", MODEL, 20)
        # address the request at a node and mark it forwarded: it must not
        # hop again even if the ring disagrees with the landing spot
        target = next(s for s in (seed, other)
                      if s.cluster.owners(key)[0] != s.url)
        req = urllib.request.Request(
            f"{target.url}/v1/derive",
            data=json.dumps({"domain": "tri2d", "model": MODEL,
                             "stage": 20}).encode(),
            headers={"Content-Type": "application/json",
                     FORWARDED_HEADER: "1"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            payload = json.loads(resp.read())
        assert payload["key"] == key
        assert target.forwarded == 0            # served where it landed
        assert target.service.stats.derivations == 1
    finally:
        seed.close()
        other.close()


# ---------------------------------------------------------------------------
# Gossip fanout cap: big-fleet membership stays O(N log N)
# ---------------------------------------------------------------------------


def test_fanout_cap_and_probe_cycle_units():
    """effective_fanout tiers (explicit / auto-log / uncapped) and the
    shuffled probe cycle's coverage guarantee: every known node is visited
    within ceil(N/fanout) rounds, never more than fanout per round."""
    auto = ClusterMembership("http://self:1", seeds=[])
    assert auto.effective_fanout(2) == 3    # ceil(log2 2) + 2
    assert auto.effective_fanout(16) == 6
    assert auto.effective_fanout(100) == 9
    uncapped = ClusterMembership("http://self:1", seeds=[],
                                 gossip_fanout=-1)
    assert uncapped.effective_fanout(50) == 50
    capped = ClusterMembership("http://self:1", seeds=[], gossip_fanout=3)
    assert capped.effective_fanout(50) == 3

    peers = {f"http://peer-{i}:1" for i in range(10)}
    for url in sorted(peers):
        capped.observe(url)
    rounds = [capped._next_probe_targets() for _ in range(8)]
    assert all(len(r) <= 3 for r in rounds)
    # one full cycle = ceil(10/3) = 4 rounds and it covers everyone
    assert set().union(*rounds[:4]) == peers
    # deterministic under the node's own seed: a replay walks the same cycle
    replay = ClusterMembership("http://self:1", seeds=[], gossip_fanout=3)
    for url in sorted(peers):
        replay.observe(url)
    assert [replay._next_probe_targets() for _ in range(8)] == rounds


def test_seven_node_fleet_capped_gossip_lifecycle(tmp_path,
                                                 counting_backend):
    """Satellite acceptance on a 7-node fleet with gossip_fanout=2: the
    fleet converges through capped probe subsets; a killed node is marked
    down fleet-wide within ``down_after`` + O(cycle) heartbeat rounds; a
    partitioned node rejoins and the whole story costs ONE inference —
    the rejoin must not re-derive."""
    n = 7
    seed = boot_node(tmp_path, "g0", [], counting_backend, gossip_fanout=2)
    servers = [seed] + [
        boot_node(tmp_path, f"g{i}", [seed.url], counting_backend,
                  gossip_fanout=2)
        for i in range(1, n)]
    try:
        _await(lambda: all(len(s.cluster.ring.nodes) == n for s in servers),
               what="7-node convergence under capped gossip")
        # steady state: every round respects the cap (bootstrap exempt)
        time.sleep(0.5)
        samples = []
        for _ in range(6):
            time.sleep(0.16)
            samples += [s.cluster.stats()["probes_last_round"]
                        for s in servers]
        assert max(samples) <= 2, samples
        assert all(s.cluster.stats()["gossip_fanout"] == 2 for s in servers)

        # one derive through a non-owner: exactly one inference fleet-wide
        key = servers[0].service.request_key("tri2d", MODEL, 20)
        owners = servers[0].cluster.owners(key)
        non_owner = next(s for s in servers if s.url not in owners)
        RemoteMappingService(non_owner.url).derive("tri2d", MODEL, 20)
        assert counting_backend.calls == 1
        _await(lambda: sorted(holders(servers, key)) == sorted(owners),
               what="record on exactly the K owners")

        # -- kill a non-owner: down fleet-wide within down_after + O(cycle)
        victim = next(s for s in servers
                      if s.url not in owners and s is not non_owner)
        victim_port, victim_name = victim.port, None
        for i in range(n):
            if servers[i] is victim:
                victim_name = f"g{i}" if i else "g0"
        victim.close()
        alive = [s for s in servers if s is not victim]
        t0 = time.monotonic()
        _await(lambda: all(len(s.cluster.ring.nodes) == n - 1
                           for s in alive),
               what="capped-gossip death detection")
        elapsed = time.monotonic() - t0
        # down_after=1.0 + one probe cycle (ceil(6/2)=3 rounds @0.15s) +
        # generous scheduling slack — the point: capping the fanout must
        # not push detection toward the uncapped-timeout regime
        assert elapsed < 1.0 + 3 * 0.15 + 3.0, elapsed

        # -- the partitioned node rejoins on its old port + store ----------
        rejoined = boot_node(tmp_path, victim_name, [seed.url],
                             counting_backend, port=victim_port,
                             gossip_fanout=2)
        servers = alive + [rejoined]
        _await(lambda: all(len(s.cluster.ring.nodes) == n for s in servers),
               what="rejoin convergence")
        # re-derive the same cell through several nodes: still ONE
        # inference total — a rejoin must never duplicate work
        for s in (rejoined, non_owner, servers[0]):
            res = RemoteMappingService(s.url).derive("tri2d", MODEL, 20)
            assert res.cache_key == key
        assert counting_backend.calls == 1
    finally:
        for s in servers:
            try:
                s.close()
            except Exception:
                pass


# ---------------------------------------------------------------------------
# Keep-alive transport failure behavior
# ---------------------------------------------------------------------------


def test_pooled_socket_death_reconnects_then_retries(tmp_path):
    """When a pooled keep-alive socket dies (server restart), the client
    reconnects silently; when the server is really gone, the existing
    retry/backoff surfaces the documented error."""
    store_root = tmp_path / "store"
    svc = MappingService(store=build_store(root=store_root),
                         n_validate=2000, sample_every=1)
    server = MappingHTTPServer(svc).start()
    port = server.port
    client = RemoteMappingService(server.url, retries=1, backoff=0.01)
    first = client.derive("tri2d", MODEL, 20)
    assert client.stats.reconnects == 0
    server.close()  # severs the pooled connection

    svc2 = MappingService(store=build_store(root=store_root),
                          n_validate=2000, sample_every=1)
    with MappingHTTPServer(svc2, port=port) as server2:
        res = client.derive("tri2d", MODEL, 20)
        assert res.cache_hit and res.cache_key == first.cache_key
        assert client.stats.reconnects >= 1     # silent reconnect, no retry
        assert client.stats.retries == 0
    with pytest.raises(RemoteServiceError) as err:
        client.derive("tri2d", MODEL, 20)       # nobody listening anymore
    assert err.value.status is None
    assert client.stats.retries >= 1            # backoff machinery engaged


def test_nested_call_during_grid_stream_gets_own_connection(tmp_path):
    """A call issued while a grid stream is suspended must not steal (and
    kill) the connection carrying the stream — checked-out connections are
    owned by exactly one in-flight response."""
    svc = MappingService(store=build_store(root=tmp_path),
                         n_validate=2000, sample_every=1)
    with MappingHTTPServer(svc) as server:
        client = RemoteMappingService(server.url)
        seen = []
        for res in client.run_grid(domains=["tri2d", "gasket2d"],
                                   models=[MODEL], stages=[20, 50]):
            seen.append(res.cache_key)
            fetched = client.fetch_artifact(res.cache_key)  # mid-stream call
            assert fetched["record"]["key"] == res.cache_key
        assert len(seen) == 4 and len(set(seen)) == 4


def test_error_response_does_not_desync_keepalive(tmp_path):
    """An error answered before the request body was read (e.g. a POST to
    an unknown route) must not leave the body bytes in the socket to be
    parsed as the next request on the kept-alive connection."""
    svc = MappingService(store=build_store(root=tmp_path),
                         n_validate=2000, sample_every=1)
    with MappingHTTPServer(svc) as server:
        client = RemoteMappingService(server.url)
        client.derive("tri2d", MODEL, 20)
        with pytest.raises(RemoteServiceError) as err:
            client._call_json("/v1/no-such-route", {"pad": "x" * 4096})
        assert err.value.status == 404
        again = client.derive("tri2d", MODEL, 20)  # same client, clean conn
        assert again.cache_hit
        assert client.stats.retries == 0


def test_observe_is_candidate_only_until_probed():
    """A ``?from=`` announcement nominates a node but never places it in
    the ring — only this node's own successful probe does (an
    unauthenticated announce must not poison routing)."""
    cluster = ClusterMembership("http://127.0.0.1:1", heartbeat_interval=9e9)
    cluster.observe("http://127.0.0.1:2/")
    assert cluster.ring.nodes == ["http://127.0.0.1:1"]  # not in the ring
    view_urls = [n["url"] for n in cluster.view()["nodes"]]
    assert "http://127.0.0.1:2" in view_urls             # but known/probed
    # a few failed probes forget a never-seen non-seed candidate entirely
    for _ in range(3):
        cluster.heartbeat_now()
    assert "http://127.0.0.1:2" not in [
        n["url"] for n in cluster.view()["nodes"]]
    assert cluster.forgotten == 1


def test_self_seed_under_an_alias_does_not_double_join(tmp_path):
    """The documented bootstrap seeds the first node from its own URL; if
    the operator spells it differently (localhost vs 127.0.0.1) the alias
    must be detected and excluded — a node ringed under two names would
    silently collapse the replication factor onto one machine."""
    svc = MappingService(store=build_store(root=tmp_path),
                         n_validate=2000, sample_every=1)
    server = MappingHTTPServer(svc).start()  # binds 127.0.0.1
    try:
        cluster = ClusterMembership(
            server.url, seeds=[f"http://localhost:{server.port}"],
            heartbeat_interval=9e9, probe_timeout=2.0)
        server.attach_cluster(cluster)  # start() runs one heartbeat round
        assert cluster.ring.nodes == [server.url]  # one node, one name
        assert f"http://localhost:{server.port}" in cluster._aliases
        cluster.heartbeat_now()  # the alias stays excluded on later rounds
        assert cluster.ring.nodes == [server.url]
    finally:
        server.close()


def test_standalone_server_keeps_static_mesh_wire_behavior(tmp_path):
    """No seeds -> no cluster: /v1/cluster answers 404, the ring-aware
    client degrades to plain single-host routing, and the manifest endpoint
    still serves (it is part of the replication surface, not membership)."""
    svc = MappingService(store=build_store(root=tmp_path),
                         n_validate=2000, sample_every=1)
    with MappingHTTPServer(svc) as server:
        client = RemoteMappingService(server.url)
        with pytest.raises(RemoteServiceError) as err:
            client.cluster_view()
        assert err.value.status == 404
        res = client.derive("tri2d", MODEL, 20)
        repeat = client.derive("tri2d", MODEL, 20)  # triggers the ring probe
        assert repeat.cache_hit and client.stats.routed == 0
        assert client.manifest()["keys"] == [res.cache_key]
        assert "cluster" not in client.metrics()
