"""The port's evaluation plane over the socket: the HTTP and client cases of
``tests/test_evaluate.py`` (``POST /v1/evaluate`` single / batch / NDJSON
sweep / error codes, client retry-and-fallback parity with derive) against
both of the port's frontends, the ``NO_CARD`` refusal on a machine without a
card, and the multi-device sweep split over an explicit device list.

Every query that reaches an evaluator here says ``"interpret": true`` (the
kernels' plain versions on the CPU): in the port ``"interpret": null``
means the card, and without one the query is refused, never quietly run on
the CPU.  The JAX package's sharded sweep runs its shards through
``shard_map`` over fake host devices; the port's is held here over
``["cpu", "cpu"]`` with ``interpret=True`` against the exact ``np_map``
tier, and on the card by ``chip_smoke.py``."""
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro_torch.core import compile_cache as cc
from repro_torch.core.artifact import ArtifactCache
from repro_torch.core.backends import MockLLMBackend
from repro_torch.core.maps import np_map
from repro_torch.kernels.domain_map import kernel, ops
from repro_torch.serving import (
    AsyncMappingHTTPServer, MappingHTTPServer, MappingService,
    RemoteMappingService, RemoteServiceError,
)
from repro_torch.serving.evaluate import EvaluationService

MODEL = "OSS:120b"
FRONTENDS = {"threaded": MappingHTTPServer, "async": AsyncMappingHTTPServer}

#: the fields of the JAX package's sharded sweep cell
#: (``src/repro/serving/evaluate.py``, ``_sharded_cell``'s result)
SHARDED_FIELDS = {
    "index", "domain", "tier", "n_points", "start", "extent", "block_n",
    "ndigits", "padded", "interpret", "group", "group_size", "executable",
    "devices", "coords",
}


def local_service(tmp_path) -> MappingService:
    return MappingService(cache=ArtifactCache(tmp_path),
                          backend_factory=MockLLMBackend,
                          n_validate=2000, sample_every=1)


def post(url: str, payload: dict) -> tuple[int, dict]:
    req = urllib.request.Request(
        url + "/v1/evaluate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# ---------------------------------------------------------------------------
# wire surface: POST /v1/evaluate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frontend", FRONTENDS)
def test_http_evaluate_single_batch_and_sweep(tmp_path, frontend):
    svc = local_service(tmp_path)
    with FRONTENDS[frontend](svc) as server:
        client = RemoteMappingService(server.url)

        single = client.evaluate("tri2d", n_points=200, block_n=128,
                                 interpret=True)
        local = ops.map_coordinates("tri2d", 200, block_n=128,
                                    interpret=True, compile_cache=None)
        np.testing.assert_array_equal(single["coords"], local)

        # derived artifact, evaluated by content address over the wire
        res = client.derive("tri2d", MODEL, 20)
        by_key = client.evaluate(key=res.cache_key, n_points=128,
                                 block_n=128, interpret=True)
        np.testing.assert_array_equal(
            by_key["coords"].astype(np.int64),
            np_map("tri2d", np.arange(128, dtype=np.int64)))

        batch = client.evaluate_batch([
            {"domain": "tri2d", "n_points": 100, "block_n": 128,
             "interpret": True},
            {"domain": "tri2d", "n_points": 200, "block_n": 128,
             "interpret": True},
            {"domain": "tri2d", "tier": "membership", "extent": [12, 12],
             "interpret": True},
        ])
        assert len(batch) == 3
        assert batch[0]["group"] == batch[1]["group"]
        np.testing.assert_array_equal(batch[1]["coords"], local)
        np.testing.assert_array_equal(
            batch[2]["mask"],
            ops.bb_membership("tri2d", (12, 12), interpret=True,
                              compile_cache=None))

        swept = list(client.evaluate_sweep(["tri2d", "gasket2d"], [64, 128],
                                           block_n=64, interpret=True))
        assert len(swept) == 4
        assert all(isinstance(c["coords"], np.ndarray) for c in swept)

        metrics = client.metrics()
        assert metrics["evaluate"]["queries"] >= 8
        assert metrics["evaluate"]["batches"] >= 3
        assert metrics["evaluate"]["sweep_cells"] == 4
        assert metrics["compile_cache"]["misses"] >= 1
        assert metrics["http"]["evaluate"]["requests"] >= 4
        assert metrics["http"]["evaluate"]["p95_ms"] > 0
        assert client.store_stats()["compile_cache"]["entries"] >= 1


@pytest.mark.parametrize("frontend", FRONTENDS)
def test_http_evaluate_error_codes(tmp_path, frontend):
    svc = local_service(tmp_path)
    with FRONTENDS[frontend](svc) as server:
        client = RemoteMappingService(server.url)
        with pytest.raises(RemoteServiceError) as e404:
            client.evaluate("atlantis", n_points=10, interpret=True)
        assert e404.value.status == 404
        with pytest.raises(RemoteServiceError) as k404:
            client.evaluate(key="ab" * 32, n_points=10,
                            interpret=True)  # never stored
        assert k404.value.status == 404
        with pytest.raises(RemoteServiceError) as e400:
            client.evaluate("tri2d", interpret=True)  # no n_points
        assert e400.value.status == 400
        with pytest.raises(RemoteServiceError) as b400:
            client._call_json("/v1/evaluate", {"queries": "nope"})
        assert b400.value.status == 400
        with pytest.raises(RemoteServiceError) as s400:
            client._call_json("/v1/evaluate", {"sweep": {"domains": []}})
        assert s400.value.status == 400
        # a batch with one bad member fails atomically — nothing dispatched
        before = client.metrics()["evaluate"]["queries"]
        with pytest.raises(RemoteServiceError) as mix:
            client.evaluate_batch([
                {"domain": "tri2d", "n_points": 10, "interpret": True},
                {"domain": "tri2d", "n_points": -1, "interpret": True},
            ])
        assert mix.value.status == 400
        assert client.metrics()["evaluate"]["queries"] == before
        # malformed requests must not poison the endpoint
        assert client.evaluate("tri2d", n_points=16,
                               interpret=True)["n_points"] == 16


def test_client_evaluate_falls_back_like_derive(tmp_path):
    """Dead server + configured fallback: evaluation degrades to the local
    evaluator (same bytes); without a fallback the transport error
    surfaces."""
    local = local_service(tmp_path)
    art = local.derive("tri2d", MODEL, 20)
    client = RemoteMappingService("http://127.0.0.1:9", retries=1,
                                  backoff=0.01, fallback=local)
    got = client.evaluate("tri2d", n_points=150, block_n=128,
                          interpret=True)
    assert client.stats.fallbacks == 1
    np.testing.assert_array_equal(
        got["coords"],
        ops.map_coordinates("tri2d", 150, block_n=128, interpret=True,
                            compile_cache=None))
    # artifact keys resolve against the fallback service's store
    by_key = client.evaluate(key=art.cache_key, n_points=64, block_n=64,
                             interpret=True)
    np.testing.assert_array_equal(
        by_key["coords"].astype(np.int64),
        np_map("tri2d", np.arange(64, dtype=np.int64)))
    swept = list(client.evaluate_sweep(["tri2d"], [64], block_n=64,
                                       interpret=True))
    assert len(swept) == 1 and client.stats.fallbacks == 3
    assert client.stats.retries >= 3

    bare = RemoteMappingService("http://127.0.0.1:9", retries=0,
                                backoff=0.01)
    with pytest.raises(RemoteServiceError):
        bare.evaluate("tri2d", n_points=10, interpret=True)
    with pytest.raises(RemoteServiceError):
        list(bare.evaluate_sweep(["tri2d"], [16], interpret=True))
    with pytest.raises(ValueError, match="'domain' or 'key'"):
        bare.evaluate()
    with pytest.raises(RemoteServiceError) as badkey:
        bare.evaluate(key="nope")  # rejected before any round-trip
    assert badkey.value.status == 400


# ---------------------------------------------------------------------------
# no card: refused with NO_CARD, never run on the CPU unasked
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frontend", FRONTENDS)
def test_server_without_a_card_answers_no_card(tmp_path, monkeypatch,
                                               frontend):
    """A query that does not say ``"interpret": true`` asks for the card;
    without one both frontends answer the kernel module's NO_CARD error
    (a RuntimeError: 500) before any launch, and the same query with
    ``"interpret": true`` answers the exact coordinates."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    svc = local_service(tmp_path)
    launches = kernel.MAP_LAUNCHES, kernel.MEMBERSHIP_LAUNCHES
    with FRONTENDS[frontend](svc) as server:
        for body in ({"domain": "tri2d", "n_points": 64},
                     {"domain": "tri2d", "n_points": 64, "interpret": None},
                     {"domain": "tri2d", "n_points": 64,
                      "interpret": False},
                     {"queries": [{"domain": "tri2d", "tier": "membership",
                                   "extent": [8, 8]}]}):
            status, payload = post(server.url, body)
            assert status == 500
            assert payload["error"] == f"RuntimeError: {kernel.NO_CARD}"
            assert '"interpret": true' in payload["error"]
        status, payload = post(server.url, {"domain": "tri2d",
                                            "n_points": 64,
                                            "interpret": True})
        assert status == 200 and payload["interpret"] is True
        np.testing.assert_array_equal(
            np.asarray(payload["coords"], dtype=np.int64),
            np_map("tri2d", np.arange(64, dtype=np.int64)))
        client = RemoteMappingService(server.url, retries=0)
        with pytest.raises(RemoteServiceError) as err:
            list(client.evaluate_sweep(["tri2d"], [64]))
        assert "interpret" in str(err.value)
        evaluate = client.metrics()["evaluate"]
        assert evaluate["errors"] >= 4 and evaluate["queries"] == 1
    assert (kernel.MAP_LAUNCHES, kernel.MEMBERSHIP_LAUNCHES) == launches


def test_client_fallback_without_a_card_refuses(tmp_path, monkeypatch):
    """The client's local evaluate fallback holds the same rule: without a
    card and without ``interpret=True`` it raises NO_CARD."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    client = RemoteMappingService("http://127.0.0.1:9", retries=0,
                                  backoff=0.01,
                                  fallback=local_service(tmp_path))
    with pytest.raises(RuntimeError, match='"interpret": true'):
        client.evaluate("tri2d", n_points=10)
    with pytest.raises(RuntimeError, match='"interpret": true'):
        list(client.evaluate_sweep(["tri2d"], [16]))
    assert client.evaluate("tri2d", n_points=10,
                           interpret=True)["n_points"] == 10


# ---------------------------------------------------------------------------
# multi-device sweep: the λ-range split over an explicit device list
# ---------------------------------------------------------------------------


def test_sharded_sweep_over_two_devices_is_exact():
    ev = EvaluationService(compile_cache=cc.CompileCache(max_entries=16))
    sizes = [100, 256, 1001]
    cells = list(ev.sweep(["tri2d", "gasket2d", "msimplex5", "menger3d"],
                          sizes, interpret=True, devices=["cpu", "cpu"]))
    assert len(cells) == 12
    for c in cells:
        assert set(c) == SHARDED_FIELDS
        assert c["executable"] == "sharded" and c["devices"] == 2
        assert c["padded"] == -(-c["n_points"] // 2) * 2
        assert c["block_n"] == 0 and c["start"] == 0
        assert c["coords"].dtype == np.int32
        ref = np_map(c["domain"], np.arange(c["n_points"], dtype=np.int64))
        np.testing.assert_array_equal(c["coords"].astype(np.int64), ref)
    gasket = [c for c in cells if c["domain"] == "gasket2d"]
    from repro_torch.core.domains import DOMAINS
    assert [c["ndigits"] for c in gasket] == [
        max(DOMAINS["gasket2d"].level_for_points(c["padded"]), 1)
        for c in gasket]
    assert {c["ndigits"] for c in cells if c["domain"] == "tri2d"} == {13}
    assert ev.stats.sharded_dispatches == 12 and ev.stats.sweep_cells == 12
    assert ev.stats.points == 4 * sum(sizes)
    # a repeat is a launcher-cache hit
    hits = ev.cache.stats.hits
    again = list(ev.sweep(["tri2d"], [100], interpret=True,
                          devices=["cpu", "cpu"]))
    assert ev.cache.stats.hits == hits + 1
    np.testing.assert_array_equal(again[0]["coords"], cells[0]["coords"])


def test_sharded_sweep_splits_at_every_device_count():
    """Three shards of an odd range: each covers its own λ offset, and the
    gathered whole equals one unsplit evaluation."""
    ev = EvaluationService(compile_cache=None)
    cell, = ev.sweep(["pyramid3d"], [1000], interpret=True,
                     devices=["cpu"] * 3)
    one = ev.evaluate({"domain": "pyramid3d", "n_points": 1000,
                       "interpret": True})
    assert cell["padded"] == 1002 and cell["devices"] == 3
    np.testing.assert_array_equal(cell["coords"], one["coords"])


def test_sharded_sweep_refusals(monkeypatch):
    ev = EvaluationService(compile_cache=cc.CompileCache(max_entries=4))
    # a one-device list, and no list on a machine without several cards,
    # is not split
    one, = ev.sweep(["tri2d"], [64], interpret=True, devices=["cpu"])
    assert one["executable"] != "sharded"
    default, = ev.sweep(["tri2d"], [64], interpret=True)
    assert default["executable"] != "sharded"
    assert ev.stats.sharded_dispatches == 0
    with pytest.raises(ValueError, match="cuda devices"):
        list(ev.sweep(["tri2d"], [64], devices=["cpu", "cpu"]))
    with pytest.raises(KeyError):
        list(ev.sweep(["atlantis"], [64], interpret=True,
                      devices=["cpu", "cpu"]))
    with pytest.raises(ValueError, match="n_points"):
        list(ev.sweep(["tri2d"], [ev.max_points + 1], interpret=True,
                      devices=["cpu", "cpu"]))
    assert ev.stats.errors == 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = kernel.MAP_LAUNCHES
    with pytest.raises(RuntimeError, match='"interpret": true'):
        ops.sharded_map_executable("tri2d", 64, ["cuda:0", "cuda:1"], False,
                                   compile_cache=None)
    assert kernel.MAP_LAUNCHES == before


# ---------------------------------------------------------------------------
# the first evaluates of concurrent requests build a kernel library once
# ---------------------------------------------------------------------------


def test_concurrent_first_loads_build_once(tmp_path, monkeypatch):
    """Server threads that reach a kernel at once (handler threads, the
    asyncio frontend's worker pool) start one nvcc run between them and
    share the loaded library.  nvcc is a stand-in script here that counts
    its runs and writes the output file."""
    import ctypes
    import threading

    from repro_torch.kernels import build

    runs = tmp_path / "runs"
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nsleep 0.2\necho run >> "%s"\n'
                    'while [ "$1" != "-o" ]; do shift; done\n'
                    'touch "$2"\n' % runs)
    fake.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "probe.cu").write_text("// probe\n")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(ctypes, "CDLL", lambda path: ("loaded", path))
    monkeypatch.setattr(build, "LOADED", {})
    lib = build.Library("probe", csrc, lambda handle: handle)
    got, errors = [], []

    def first_evaluate():
        try:
            got.append(build.load(lib))
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=first_evaluate) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert runs.read_text().splitlines() == ["run"]
    assert len(got) == 8 and len(set(got)) == 1
    assert got[0] == ("loaded", str(lib.path()))
