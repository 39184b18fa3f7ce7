"""The two packages over one wire: the JAX package's ``RemoteMappingService``
against a port server, and the port's client against a JAX-package server,
on both frontends, with the binary frame and with JSON.  Evaluations decode
to equal arrays with equal dtypes (and equal metadata, the launcher-cache
provenance aside) as either package's in-process ``EvaluationService``; a
derive through either client gives the same content address and the same
record, timing fields aside.  Every evaluate query says
``"interpret": true``: the port's plain versions and the JAX package's
interpret-mode Pallas kernels on the CPU."""
import numpy as np
import pytest

from repro.core import compile_cache as ref_cc
from repro.core import pipeline as rp
from repro.core.backends import MockLLMBackend as RefMockLLMBackend
from repro.core.store import build_store as ref_build_store
from repro.serving import (
    AsyncMappingHTTPServer as RefAsyncMappingHTTPServer,
    MappingHTTPServer as RefMappingHTTPServer,
    MappingService as RefMappingService,
    RemoteMappingService as RefRemoteMappingService,
)
from repro.serving.evaluate import EvaluationService as RefEvaluationService
from repro_torch.core import compile_cache as cc
from repro_torch.core import pipeline as tp
from repro_torch.core.backends import MockLLMBackend
from repro_torch.core.store import build_store
from repro_torch.serving import (
    AsyncMappingHTTPServer, MappingHTTPServer, MappingService,
    RemoteMappingService,
)
from repro_torch.serving.evaluate import EvaluationService

MODEL = "OSS:120b"
PORT_FRONTENDS = {"threaded": MappingHTTPServer,
                  "async": AsyncMappingHTTPServer}
REF_FRONTENDS = {"threaded": RefMappingHTTPServer,
                 "async": RefAsyncMappingHTTPServer}
QUERIES = [
    {"domain": "tri2d", "n_points": 200, "block_n": 128},
    {"domain": "tri2d", "n_points": 100, "block_n": 128},
    {"domain": "gasket2d", "n_points": 128, "start": 128, "block_n": 128},
    {"domain": "msimplex4", "n_points": 300, "start": 12_345,
     "block_n": 256},
    {"domain": "tri2d", "tier": "membership", "extent": [12, 12]},
    {"domain": "menger3d", "tier": "membership", "extent": [9, 9, 9],
     "block_n": 256},
]
QUERIES = [{**q, "interpret": True} for q in QUERIES]
SWEEP = (["tri2d", "gasket2d"], [64, 100])
TIMING = ("wall_seconds", "created_unix")


@pytest.fixture(scope="module")
def expected():
    """The batch and the sweep in process, through both packages — equal
    to each other, and the yardstick for every wire answer."""
    ev = EvaluationService(compile_cache=cc.CompileCache(max_entries=32))
    ref = RefEvaluationService(
        compile_cache=ref_cc.CompileCache(max_entries=32))
    batch, _ = ev.evaluate_batch(QUERIES)
    ref_batch, _ = ref.evaluate_batch(QUERIES)
    sweep = list(ev.sweep(*SWEEP, block_n=64, interpret=True))
    ref_sweep = list(ref.sweep(*SWEEP, block_n=64, interpret=True))
    _assert_equal(batch, ref_batch)
    _assert_equal(sweep, ref_sweep)
    return batch, sweep


def _assert_equal(got: list[dict], want: list[dict]) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for field in ("coords", "mask"):
            if field in w:
                assert isinstance(g[field], np.ndarray)
                assert g[field].dtype == w[field].dtype
                np.testing.assert_array_equal(g[field], w[field])
        skip = ("coords", "mask", "executable")
        assert {k: v for k, v in g.items() if k not in skip} \
            == {k: v for k, v in w.items() if k not in skip}


def _port_service(tmp_path, name="port"):
    return MappingService(store=build_store(root=tmp_path / name),
                          backend_factory=MockLLMBackend,
                          n_validate=2000, sample_every=1)


def _ref_service(tmp_path, name="ref"):
    return RefMappingService(store=ref_build_store(root=tmp_path / name),
                             backend_factory=RefMockLLMBackend,
                             n_validate=2000, sample_every=1)


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "json"])
@pytest.mark.parametrize("frontend", PORT_FRONTENDS)
def test_reference_client_against_port_server(tmp_path, expected, frontend,
                                              binary):
    batch, sweep = expected
    with PORT_FRONTENDS[frontend](_port_service(tmp_path)) as server:
        client = RefRemoteMappingService(server.url, binary=binary)
        _assert_equal(client.evaluate_batch(QUERIES), batch)
        q = QUERIES[3]
        single = client.evaluate(
            q["domain"], n_points=q["n_points"], start=q["start"],
            block_n=q["block_n"], interpret=True)
        _assert_equal([{**single, "index": 3, "group": batch[3]["group"],
                        "group_size": batch[3]["group_size"]}], [batch[3]])
        _assert_equal(list(client.evaluate_sweep(*SWEEP, block_n=64,
                                                 interpret=True)), sweep)
        client.close()


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "json"])
@pytest.mark.parametrize("frontend", REF_FRONTENDS)
def test_port_client_against_reference_server(tmp_path, expected, frontend,
                                              binary):
    batch, sweep = expected
    with REF_FRONTENDS[frontend](_ref_service(tmp_path)) as server:
        client = RemoteMappingService(server.url, binary=binary)
        _assert_equal(client.evaluate_batch(QUERIES), batch)
        q = QUERIES[4]
        single = client.evaluate(q["domain"], tier="membership",
                                 extent=q["extent"], interpret=True)
        _assert_equal([{**single, "index": 4, "group": batch[4]["group"],
                        "group_size": batch[4]["group_size"]}], [batch[4]])
        assert single["mask"].dtype == np.bool_
        _assert_equal(list(client.evaluate_sweep(*SWEEP, block_n=64,
                                                 interpret=True)), sweep)
        client.close()


def _record(pipeline, res) -> dict:
    rec = pipeline.record_from_result(res)
    for k in TIMING:
        rec.pop(k)
    return rec


def _artifact(res) -> dict | None:
    art = res.artifact
    if art is None:
        return None
    rec = art.to_record()
    for k in ("created_unix", "inference_seconds"):
        rec.pop(k)
    return rec


@pytest.mark.parametrize("frontend", PORT_FRONTENDS)
def test_derive_through_either_client_gives_equal_records(tmp_path,
                                                          frontend):
    """The same cells derived by a port server for the JAX package's
    client and by a JAX-package server for the port's client: equal
    content addresses, records and artifact records (timing aside), and a
    repeat through each is a server-side cache hit.  Then the derived
    artifact evaluates by key through each pair to equal arrays."""
    cells = [("tri2d", MODEL, 20), ("menger3d", MODEL, 100),
             ("msimplex4", "R1:70b", 50)]
    with PORT_FRONTENDS[frontend](_port_service(tmp_path)) as port_srv, \
            REF_FRONTENDS[frontend](_ref_service(tmp_path)) as ref_srv:
        ref_client = RefRemoteMappingService(port_srv.url)
        port_client = RemoteMappingService(ref_srv.url)
        for cell in cells:
            a = ref_client.derive(*cell)      # served by the port
            b = port_client.derive(*cell)     # served by the reference
            assert a.cache_key == b.cache_key, cell
            assert _record(rp, a) == _record(tp, b), cell
            assert _artifact(a) == _artifact(b), cell
            assert (a.cache_hit, b.cache_hit) == (False, False)
            again = ref_client.derive(*cell), port_client.derive(*cell)
            assert all(r.cache_hit for r in again)
            assert again[0].cache_key == a.cache_key
        key = ref_client.derive("tri2d", MODEL, 20).cache_key
        q = {"key": key, "n_points": 300, "start": 7, "interpret": True}
        by_port = ref_client.evaluate_batch([q])[0]
        by_ref = port_client.evaluate_batch([q])[0]
        assert by_port["coords"].dtype == by_ref["coords"].dtype
        np.testing.assert_array_equal(by_port["coords"], by_ref["coords"])
        assert port_srv.service.stats.derivations == len(cells)
        assert ref_srv.service.stats.derivations == len(cells)
        ref_client.close()
        port_client.close()
