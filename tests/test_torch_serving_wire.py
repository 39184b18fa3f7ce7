"""The port's binary evaluation wire, under the cases of
``tests/test_wire.py``: frame codec round-trips (zero-copy hydration, dtype
fidelity including the bool membership mask), format negotiation +
binary/JSON answer parity on both frontends, malformed-frame negative paths
as structured 400s over raw ``http.client`` (the keep-alive connection
survives), the encoded-response LRU, and binary passthrough across a
one-hop owner forward on a 2-node ring.  Every query that reaches an
evaluator says ``"interpret": true`` (the kernels' plain versions on the
CPU)."""
import http.client
import io
import json
import struct
import time

import numpy as np
import pytest

from repro_torch.core import compile_cache as cc
from repro_torch.core.artifact import ArtifactCache
from repro_torch.core.backends import MockLLMBackend
from repro_torch.core.store import build_store
from repro_torch.serving import (
    AsyncMappingHTTPServer, ClusterMembership, MappingHTTPServer,
    MappingService, RemoteMappingService, WireFormatError,
)
from repro_torch.serving import wire
from repro_torch.serving.evaluate import EvaluationService, hydrate_result, \
    wire_result

MODEL = "OSS:120b"
FRONTENDS = [MappingHTTPServer, AsyncMappingHTTPServer]


def local_service(tmp_path) -> MappingService:
    return MappingService(cache=ArtifactCache(tmp_path),
                          backend_factory=MockLLMBackend,
                          n_validate=2000, sample_every=1)


def _await(predicate, timeout: float = 20.0, what: str = "condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------


def test_frame_roundtrip_preserves_dtypes_and_structure():
    payload = {
        "coords": np.arange(24, dtype=np.int32).reshape(12, 2),
        "mask": np.array([[True, False], [False, True]]),
        "lam": np.linspace(0.0, 1.0, 7, dtype=np.float64),
        "wide": np.array([1 << 40, -5], dtype=np.int64),
        "f32": np.array([1.5, -2.25], dtype=np.float32),
        "meta": {"domain": "tri2d", "n": 12, "nested": [1, "two", None],
                 "empty": np.array([], dtype=np.int32)},
        "scalar": np.int64(7),
    }
    back = wire.decode_frame(wire.encode_frame(payload))
    for field in ("coords", "mask", "lam", "wide", "f32"):
        np.testing.assert_array_equal(back[field], payload[field])
        assert back[field].dtype == payload[field].dtype
    assert back["meta"]["domain"] == "tri2d"
    assert back["meta"]["nested"] == [1, "two", None]
    assert back["meta"]["empty"].shape == (0,)
    assert back["scalar"] == 7  # numpy scalar rides the JSON header


def test_frame_normalizes_layout_and_endianness():
    """Non-contiguous and big-endian inputs encode to canonical LE bytes
    and decode value-equal."""
    base = np.arange(40, dtype=np.int32).reshape(10, 4)
    strided = base[::2, ::2]
    assert not strided.flags.c_contiguous
    big = base.astype(">i4")
    back = wire.decode_frame(wire.encode_frame(
        {"s": strided, "b": big}))
    np.testing.assert_array_equal(back["s"], strided)
    np.testing.assert_array_equal(back["b"].astype(np.int64),
                                  base.astype(np.int64))
    assert back["b"].dtype.byteorder in ("<", "=")


def test_decoded_arrays_are_zero_copy_views():
    blob = wire.encode_frame({"coords": np.arange(8, dtype=np.int32)})
    back = wire.decode_frame(blob)
    arr = back["coords"]
    assert arr.base is not None          # a view over the frame buffer,
    assert not arr.flags.writeable       # not a copy
    assert not arr.flags.owndata


def _tamper(blob: bytes, what: str) -> bytes:
    if what == "magic":
        return b"XXXX" + blob[4:]
    if what == "version":
        return blob[:4] + struct.pack("<I", 99) + blob[8:]
    if what == "header-json":
        head_len = struct.unpack_from("<I", blob, 8)[0]
        return blob[:12] + b"{" * head_len + blob[12 + head_len:]
    if what == "header-overrun":
        return blob[:8] + struct.pack("<I", (1 << 20) + 1) + blob[12:]
    if what == "truncated-header":
        return blob[:10]
    if what == "truncated-segment":
        return blob[:-3]
    if what == "trailing-garbage":
        return blob + b"\x00\x01"
    raise AssertionError(what)


@pytest.mark.parametrize("what", ["magic", "version", "header-json",
                                  "header-overrun", "truncated-header",
                                  "truncated-segment", "trailing-garbage"])
def test_malformed_frames_raise_wireformaterror(what):
    blob = wire.encode_frame({"coords": np.arange(64, dtype=np.int32)})
    with pytest.raises(WireFormatError):
        wire.decode_frame(_tamper(blob, what))


def test_header_payload_segment_consistency_is_enforced():
    # a segment whose byte count disagrees with its declared dtype x shape
    arr = np.arange(16, dtype=np.int32)
    blob = bytearray(wire.encode_frame({"a": arr}))
    head_len = struct.unpack_from("<I", blob, 8)[0]
    header = json.loads(bytes(blob[12:12 + head_len]))
    header["segments"][0]["shape"] = [15]  # 60 bytes expected, 64 shipped
    new_head = json.dumps(header).encode()
    tampered = (bytes(blob[:8]) + struct.pack("<I", len(new_head))
                + new_head + bytes(blob[12 + head_len:]))
    with pytest.raises(WireFormatError, match="needs"):
        wire.decode_frame(tampered)
    def frame_with_header(header_obj, segment_bytes=b""):
        head = json.dumps(header_obj).encode()
        return (wire.MAGIC + struct.pack("<I", wire.VERSION)
                + struct.pack("<I", len(head)) + head + segment_bytes)

    # a payload referencing a segment that does not exist
    with pytest.raises(WireFormatError, match="references segment"):
        wire.decode_frame(frame_with_header(
            {"payload": {"__nd__": 3}, "segments": []}))
    # segments the payload never references are corruption, not padding
    with pytest.raises(WireFormatError, match="never references"):
        wire.decode_frame(frame_with_header(
            {"payload": None,
             "segments": [{"dtype": "int32", "shape": [2]}]},
            struct.pack("<I", 8) + arr[:2].tobytes()))
    with pytest.raises(WireFormatError, match="JSON object"):
        wire.decode_request(wire.encode_frame([1, 2, 3]))


def test_stream_framing_roundtrip_and_truncation():
    cells = [{"i": i, "coords": np.arange(4 * (i + 1), dtype=np.int32)}
             for i in range(3)]
    stream = b"".join(wire.stream_chunk(wire.encode_frame(c))
                      for c in cells)
    back = list(wire.iter_stream(io.BytesIO(stream).read))
    assert [c["i"] for c in back] == [0, 1, 2]
    np.testing.assert_array_equal(back[2]["coords"], cells[2]["coords"])
    # EOF mid-frame is an error, not a silent stop
    with pytest.raises(WireFormatError, match="truncated"):
        list(wire.iter_stream(io.BytesIO(stream[:-5]).read))
    with pytest.raises(WireFormatError, match="truncated"):
        list(wire.iter_stream(io.BytesIO(stream[:2]).read))


def test_wire_cache_generations_and_artifact_invalidation():
    cache = wire.WireCache(entries=2)
    cell = ("bin", "single", ("k",))
    cache.put(cell, b"blob", generation=0, artifact_keys=("aa" * 32,))
    assert cache.get(cell, 0) == b"blob"
    # compile-cache rotation bumps the generation: stale entry stops serving
    assert cache.get(cell, 1) is None
    assert cache.stats_dict()["entries"] == 0
    cache.put(cell, b"blob", artifact_keys=("aa" * 32,))
    cache.invalidate_artifact("aa" * 32)
    assert cache.get(cell) is None
    # LRU evicts the oldest cell
    cache.put(("a",), b"1")
    cache.put(("b",), b"2")
    cache.put(("c",), b"3")
    assert cache.get(("a",)) is None and cache.get(("c",)) == b"3"
    stats = cache.stats_dict()
    assert stats["capacity"] == 2 and stats["hits"] >= 1


# ---------------------------------------------------------------------------
# negotiation + parity, both frontends
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frontend", FRONTENDS)
def test_negotiation_and_parity_over_raw_http(tmp_path, frontend):
    """Accept header, ?format=binary, and a binary request body each flip
    the response to binary; absent all three the answer stays JSON — and
    both framings carry numerically identical arrays."""
    svc = local_service(tmp_path)
    with frontend(svc) as server:
        conn = http.client.HTTPConnection(server.host, server.port)
        body = json.dumps({"domain": "tri2d", "n_points": 96,
                           "block_n": 128, "interpret": True}).encode()

        def post(path, payload, headers):
            conn.request("POST", path, payload,
                         {"Content-Type": "application/json", **headers})
            resp = conn.getresponse()
            return resp.status, resp.getheader("Content-Type"), resp.read()

        st, ctype, raw = post("/v1/evaluate", body,
                              {"Accept": wire.CONTENT_TYPE})
        assert st == 200 and wire.is_binary(ctype)
        via_accept = wire.decode_frame(raw)

        st, ctype, raw = post("/v1/evaluate?format=binary", body, {})
        assert st == 200 and wire.is_binary(ctype)
        via_query = wire.decode_frame(raw)

        conn.request("POST", "/v1/evaluate",
                     wire.encode_frame(json.loads(body)),
                     {"Content-Type": wire.CONTENT_TYPE})
        resp = conn.getresponse()
        assert resp.status == 200
        assert wire.is_binary(resp.getheader("Content-Type"))
        via_body = wire.decode_frame(resp.read())

        st, ctype, raw = post("/v1/evaluate", body, {})
        assert st == 200 and ctype.startswith("application/json")
        via_json = hydrate_result(json.loads(raw))

        for res in (via_query, via_body, via_json):
            np.testing.assert_array_equal(res["coords"],
                                          via_accept["coords"])
            assert res["coords"].dtype == via_accept["coords"].dtype
        conn.close()


@pytest.mark.parametrize("frontend", FRONTENDS)
def test_binary_and_json_clients_agree_end_to_end(tmp_path, frontend):
    """The negotiated client and the JSON fallback client get the same
    dicts back — single, batch (membership mask as real bools), and the
    sweep stream — through either frontend."""
    svc = local_service(tmp_path)
    with frontend(svc) as server:
        cli_b = RemoteMappingService(server.url)
        cli_j = RemoteMappingService(server.url, binary=False)
        queries = [
            {"domain": "tri2d", "n_points": 200, "block_n": 128,
             "interpret": True},
            {"domain": "gasket2d", "n_points": 128, "block_n": 128,
             "interpret": True},
            {"domain": "tri2d", "tier": "membership", "extent": [12, 12],
             "interpret": True},
        ]
        got_b = cli_b.evaluate_batch(queries)
        got_j = cli_j.evaluate_batch(queries)
        for rb, rj in zip(got_b, got_j):
            assert set(rb) == set(rj)
            for field in ("coords", "mask"):
                if field in rb:
                    np.testing.assert_array_equal(rb[field], rj[field])
                    assert rb[field].dtype == rj[field].dtype
        assert got_b[2]["mask"].dtype == np.bool_  # not int32-coerced
        single_b = cli_b.evaluate("tri2d", n_points=200, block_n=128,
                                  interpret=True)
        np.testing.assert_array_equal(single_b["coords"],
                                      got_j[0]["coords"])
        sweep_b = list(cli_b.evaluate_sweep(["tri2d"], [64, 128],
                                            block_n=64, interpret=True))
        sweep_j = list(cli_j.evaluate_sweep(["tri2d"], [64, 128],
                                            block_n=64, interpret=True))
        assert len(sweep_b) == len(sweep_j) == 2
        for cb, cj in zip(sweep_b, sweep_j):
            np.testing.assert_array_equal(cb["coords"], cj["coords"])
        cli_b.close()
        cli_j.close()


@pytest.mark.parametrize("frontend", FRONTENDS)
def test_malformed_binary_bodies_answer_400_and_keep_alive(tmp_path,
                                                           frontend):
    """Wire-supplied garbage is a structured 400 — never a 500, and the
    keep-alive connection stays usable for the next (valid) request."""
    svc = local_service(tmp_path)
    with frontend(svc) as server:
        conn = http.client.HTTPConnection(server.host, server.port)
        good = wire.encode_frame({"domain": "tri2d", "n_points": 64,
                                  "interpret": True})
        bad_bodies = [
            b"this is not a frame",
            _tamper(good, "version"),
            _tamper(good, "truncated-segment"),
            wire.encode_frame([1, 2]),  # frames fine, not a JSON object
        ]
        for bad in bad_bodies:
            conn.request("POST", "/v1/evaluate", bad,
                         {"Content-Type": wire.CONTENT_TYPE})
            resp = conn.getresponse()
            payload = json.loads(resp.read())
            assert resp.status == 400, payload
            assert "error" in payload
            # same connection, next request: served normally
            conn.request("POST", "/v1/evaluate", good,
                         {"Content-Type": wire.CONTENT_TYPE})
            resp = conn.getresponse()
            assert resp.status == 200
            assert wire.decode_frame(resp.read())["n_points"] == 64
        conn.close()


@pytest.mark.parametrize("frontend", FRONTENDS)
def test_repeat_evaluates_serve_from_the_wire_cache(tmp_path, frontend):
    svc = local_service(tmp_path)
    with frontend(svc) as server:
        cli = RemoteMappingService(server.url)
        first = cli.evaluate("tri2d", n_points=128, block_n=128,
                             interpret=True)
        again = cli.evaluate("tri2d", n_points=128, block_n=128,
                             interpret=True)
        np.testing.assert_array_equal(first["coords"], again["coords"])
        stats = cli.metrics()["evaluate_wire"]
        assert stats["entries"] >= 1
        assert stats["hits"] >= 1
        # only warm (all-executable-hit) responses are cached: the cached
        # blob must say so
        assert again["executable"] == "hit"
        cli.close()


def test_artifact_delete_invalidates_cached_wire_blobs(tmp_path):
    svc = local_service(tmp_path)
    with MappingHTTPServer(svc) as server:
        cli = RemoteMappingService(server.url)
        key = cli.derive("tri2d", MODEL, 20).cache_key
        cli.evaluate(key=key, n_points=96,
                     interpret=True)   # build (miss, uncached)
        cli.evaluate(key=key, n_points=96,
                     interpret=True)   # warm: lands in the wire LRU
        assert server.eval_wire.stats_dict()["entries"] >= 1
        hits_before = server.eval_wire.stats_dict()["hits"]
        cli.evaluate(key=key, n_points=96,
                     interpret=True)   # served straight off the LRU
        assert server.eval_wire.stats_dict()["hits"] == hits_before + 1
        cli.delete_artifact(key)
        assert server.eval_wire.stats_dict()["entries"] == 0
        cli.close()


# ---------------------------------------------------------------------------
# one-hop owner forward: binary passthrough
# ---------------------------------------------------------------------------


def test_forwarded_evaluate_relays_binary_verbatim(tmp_path):
    """A 2-node ring with replicas=1: the non-owner forwards an
    artifact-key evaluate to the owner and relays the owner's bytes +
    Content-Type untouched — the hop is binary end to end, and the decoded
    answer equals the owner's own."""
    def boot(name, seeds):
        svc = MappingService(store=build_store(root=tmp_path / name),
                             backend_factory=MockLLMBackend,
                             n_validate=2000, sample_every=1)
        server = MappingHTTPServer(svc).start()
        server.attach_cluster(ClusterMembership(
            server.url, seeds=seeds, replicas=1, vnodes=64,
            heartbeat_interval=0.15, down_after=2.0, sync_interval=0.3))
        return server
    a = boot("a", [])
    b = boot("b", [a.url])
    try:
        _await(lambda: all(len(s.cluster.ring.nodes) == 2 for s in (a, b)),
               what="2-node membership convergence")
        owner_cli = RemoteMappingService(a.url)
        key = owner_cli.derive("tri2d", MODEL, 20).cache_key
        owner, other = (a, b) if a.cluster.owns(key) else (b, a)
        _await(lambda: owner.service.store is not None
               and key in owner.service.store,
               what="record resident on its owner")
        assert not other.cluster.owns(key)
        assert key not in other.service.store

        reference = RemoteMappingService(owner.url).evaluate(
            key=key, n_points=96, interpret=True)
        conn = http.client.HTTPConnection(other.host, other.port)
        conn.request("POST", "/v1/evaluate",
                     json.dumps({"key": key, "n_points": 96,
                                 "interpret": True}).encode(),
                     {"Content-Type": "application/json",
                      "Accept": wire.CONTENT_TYPE})
        resp = conn.getresponse()
        raw = resp.read()
        assert resp.status == 200
        assert wire.is_binary(resp.getheader("Content-Type"))
        hopped = wire.decode_frame(raw)
        np.testing.assert_array_equal(hopped["coords"],
                                      reference["coords"])
        assert hopped["coords"].dtype == reference["coords"].dtype
        assert other.forwarded >= 1      # the hop really happened
        assert other.eval_wire.stats_dict()["entries"] == 0  # relay, no cache
        conn.close()
    finally:
        for s in (a, b):
            s.close()


# ---------------------------------------------------------------------------
# wire_result/hydrate_result dtype fidelity (the JSON path)
# ---------------------------------------------------------------------------


def test_json_wire_dict_round_trips_mask_as_bool():
    ev = EvaluationService(compile_cache=cc.CompileCache(max_entries=8))
    res = ev.evaluate({"domain": "tri2d", "tier": "membership",
                       "extent": [8, 8], "interpret": True})
    assert res["mask"].dtype == np.bool_
    over_json = hydrate_result(json.loads(json.dumps(wire_result(res))))
    np.testing.assert_array_equal(over_json["mask"], res["mask"])
    assert over_json["mask"].dtype == np.bool_
    assert "dtype" not in over_json  # hydration consumes the annotation
    # an older server's wire dict (no dtype field) still hydrates, on
    # the historical int32 default
    legacy = json.loads(json.dumps(wire_result(res)))
    legacy.pop("dtype")
    assert hydrate_result(legacy)["mask"].dtype == np.int32


# ---------------------------------------------------------------------------
# the wire LRU's honesty rule against the port's launcher cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "json"])
def test_wire_blobs_expire_with_launcher_evictions(binary):
    """Only all-``executable: hit`` responses are cached, stamped with the
    launcher cache's eviction count: once the launcher a blob rode is
    evicted, the blob is stale and the next answer is recomputed and says
    ``miss`` again."""
    from repro_torch.serving.evaluate import encoded_batch_response

    ev = EvaluationService(compile_cache=cc.CompileCache(max_entries=1))
    blobs = wire.WireCache(entries=8)
    q1 = [{"domain": "tri2d", "n_points": 64, "interpret": True}]
    q2 = [{"domain": "gasket2d", "n_points": 64, "interpret": True}]

    def answer(queries):
        blob = encoded_batch_response(ev, blobs, queries, single=False,
                                      binary=binary)
        return blob, (wire.decode_frame(blob) if binary
                      else json.loads(blob))["results"][0]["executable"]

    first, said = answer(q1)
    assert said == "miss" and blobs.stats_dict()["entries"] == 0
    second, said = answer(q1)
    assert said == "hit" and blobs.stats_dict()["entries"] == 1
    hits = blobs.stats_dict()["hits"]
    third, said = answer(q1)
    assert third == second and blobs.stats_dict()["hits"] == hits + 1
    answer(q2)                      # evicts tri2d's launcher
    assert ev.cache_generation() == 1
    fourth, said = answer(q1)
    assert said == "miss" and blobs.stats_dict()["hits"] == hits + 1
