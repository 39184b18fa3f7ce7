"""The port's EvaluationService against the JAX package's, on the CPU: the
same batches (map, membership, shared groups, start > 0) give equal arrays,
equal metadata, equal ``batch`` meta and equal stats; binary frames are
byte-identical and JSON bodies equal; malformed queries raise the same
exception types.  Every query asks for the CPU (``"interpret": true``),
which in the port runs the plain versions of the CUDA kernels."""
import json

import numpy as np
import pytest
import torch

from repro.core import compile_cache as ref_cc
from repro.serving import wire as ref_wire
from repro.serving.evaluate import (
    EvaluationService as RefEvaluationService,
    encoded_batch_response as ref_encoded_batch_response,
    hydrate_result as ref_hydrate_result,
    wire_result as ref_wire_result,
)
from repro_torch.core import compile_cache as cc
from repro_torch.kernels.domain_map import kernel
from repro_torch.serving import wire
from repro_torch.serving.evaluate import (
    EvaluationService, encoded_batch_response, hydrate_result, wire_result,
)

BATCHES = {
    "grouped": [
        {"domain": "tri2d", "n_points": 100, "block_n": 128},
        {"domain": "tri2d", "n_points": 200, "block_n": 128},
        {"domain": "tri2d", "n_points": 300, "block_n": 128},
        {"domain": "gasket2d", "n_points": 128, "block_n": 128},
        {"domain": "tri2d", "tier": "membership", "extent": [16, 16],
         "block_n": 128},
        {"domain": "tri2d", "tier": "membership", "extent": [16, 16],
         "block_n": 128},
    ],
    "start": [
        {"domain": "gasket2d", "n_points": 128, "start": 128,
         "block_n": 128},
        {"domain": "gasket2d", "n_points": 64, "start": 128, "block_n": 128},
        {"domain": "menger3d", "n_points": 500, "start": 7_999},
        {"domain": "msimplex4", "n_points": 300, "start": 12_345,
         "block_n": 256},
        {"domain": "pyramid3d", "n_points": 1024, "start": 99},
    ],
    "mixed": [
        {"domain": "msimplex3", "n_points": 700},
        {"domain": "cantor2d", "n_points": 1024, "block_n": 512},
        {"domain": "vicsek2d", "n_points": 33},
        {"domain": "carpet2d", "tier": "membership", "extent": [27, 27]},
        {"domain": "menger3d", "tier": "membership", "extent": [9, 9, 9],
         "block_n": 256},
        {"domain": "sierpinski3d", "tier": "membership",
         "extent": [8, 8, 8]},
        {"domain": "msimplex5", "tier": "membership",
         "extent": [4, 4, 4, 4, 4]},
    ],
}
BAD = [
    {"domain": "tri2d"},
    {"domain": "tri2d", "n_points": 0},
    {"domain": "tri2d", "n_points": True},
    {"domain": "tri2d", "n_points": 1 << 22},
    {"domain": "tri2d", "n_points": 10, "start": -1},
    {"domain": "tri2d", "n_points": 10, "tier": "nope"},
    {"domain": "tri2d", "n_points": 10, "block_n": 0},
    {"domain": "tri2d", "n_points": 10, "interpret": "yes"},
    {"domain": "tri2d", "tier": "membership"},
    {"domain": "tri2d", "tier": "membership", "extent": [4, 4, 4]},
    {"domain": "msimplex3", "tier": "membership",
     "extent": [1 << 8, 1 << 8, 1 << 8]},
    {"key": "not-hex"},
    {"key": "ab" * 32, "n_points": 10},
    {},
    "not a dict",
    {"domain": "atlantis", "n_points": 10},
]


def _cpu(queries):
    return [{**q, "interpret": True} for q in queries]


def _pair():
    return (EvaluationService(compile_cache=cc.CompileCache(max_entries=32)),
            RefEvaluationService(
                compile_cache=ref_cc.CompileCache(max_entries=32)))


def _assert_results_equal(mine, ref):
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        assert list(a) == list(b)
        for k in a:
            if isinstance(b[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, k
                assert a[k].shape == b[k].shape, k
                np.testing.assert_array_equal(a[k], b[k])
            else:
                assert a[k] == b[k], k


def _assert_stats_equal(mine: dict, ref: dict):
    mc, rc = mine.pop("compile_cache"), ref.pop("compile_cache")
    assert mine == ref
    assert set(mc) == set(rc)
    for k in mc:
        if k not in ("trace_seconds", "persist_dir"):
            assert mc[k] == rc[k], k


@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_batches_match_reference(batch):
    ev, ref = _pair()
    queries = _cpu(BATCHES[batch])
    for _ in range(2):      # cold, then all hits
        got, meta = ev.evaluate_batch(queries)
        want, ref_meta = ref.evaluate_batch(queries)
        assert meta == ref_meta
        _assert_results_equal(got, want)
    assert all(r["executable"] == "hit" for r in got)
    _assert_stats_equal(ev.stats_dict(), ref.stats_dict())


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_encoded_responses_match_reference(batch, binary):
    ev, ref = _pair()
    mine_cache, ref_cache = wire.WireCache(8), ref_wire.WireCache(8)
    queries = _cpu(BATCHES[batch])
    for single in (False, True):
        qs = queries[:1] if single else queries
        for _ in range(3):   # miss, hit, then served from the wire LRU
            a = encoded_batch_response(ev, mine_cache, qs, single=single,
                                       binary=binary)
            b = ref_encoded_batch_response(ref, ref_cache, qs,
                                           single=single, binary=binary)
            if binary:
                assert a == b
                payload = wire.decode_frame(a)
                _assert_results_equal(
                    [payload] if single else payload["results"],
                    [ref_wire.decode_frame(b)] if single
                    else ref_wire.decode_frame(b)["results"])
            else:
                assert json.loads(a) == json.loads(b)
    assert mine_cache.stats_dict() == ref_cache.stats_dict()


def test_wire_result_and_hydrate_match_reference():
    ev, ref = _pair()
    queries = _cpu(BATCHES["mixed"])
    got, _ = ev.evaluate_batch(queries)
    want, _ = ref.evaluate_batch(queries)
    for a, b in zip(got, want):
        assert wire_result(a) == ref_wire_result(b)
        _assert_results_equal([hydrate_result(wire_result(a))],
                              [ref_hydrate_result(ref_wire_result(b))])


def test_bad_queries_raise_like_the_reference():
    ev, ref = _pair()
    for q in BAD:
        with pytest.raises(Exception) as mine:
            ev.evaluate(q)
        with pytest.raises(Exception) as theirs:
            ref.evaluate(q)
        assert type(mine.value) is type(theirs.value), q
        if isinstance(theirs.value, ValueError):
            assert str(mine.value) == str(theirs.value), q
    with pytest.raises(ValueError, match="empty"):
        ev.evaluate_batch([])
    _assert_stats_equal(ev.stats_dict(), ref.stats_dict())
    assert ev.batch_cache_key(BAD[:1]) is None
    assert ev.batch_cache_key(_cpu(BATCHES["start"])) == \
        ref.batch_cache_key(_cpu(BATCHES["start"]))


def test_sweep_matches_reference_on_one_device():
    ev, ref = _pair()
    got = list(ev.sweep(["tri2d", "gasket2d"], [64, 128], block_n=64,
                        interpret=True))
    want = list(ref.sweep(["tri2d", "gasket2d"], [64, 128], block_n=64,
                          interpret=True))
    _assert_results_equal(got, want)
    _assert_stats_equal(ev.stats_dict(), ref.stats_dict())


def test_kernel_queries_need_a_card(monkeypatch):
    """``"interpret": null`` (or false) means the CUDA kernel; with no card
    the batch fails before any launch and names the CPU opt-in."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ev = EvaluationService(compile_cache=cc.CompileCache(max_entries=4))
    before = kernel.MAP_LAUNCHES
    for q in ({"domain": "tri2d", "n_points": 64},
              {"domain": "tri2d", "n_points": 64, "interpret": False}):
        with pytest.raises(RuntimeError, match='"interpret": true'):
            ev.evaluate_batch([q, _cpu([q])[0]])
    assert ev.stats.errors == 2 and ev.stats.queries == 0
    assert ev.cache.stats.misses == 0 and kernel.MAP_LAUNCHES == before
    assert ev.evaluate(_cpu([{"domain": "tri2d",
                              "n_points": 64}])[0])["interpret"] is True
