"""The port's ``MappingArtifact`` and its deployment, held against the JAX
package's on the CPU: artifact records, the ``artifact:<key>`` launcher
identity, the mapped-grid and BB launches of an artifact (the port's plain
versions against the reference's interpret-mode Pallas calls), the
deployment analytics, and ``key`` queries through an ``EvaluationService``
with an artifact resolver — results and refusals equal to the reference's
given a resolver over the same records.  Every port launch here passes
``interpret=True``; the grid behind the artifacts runs with ``cache=None``
so neither package reads the other's store."""
import hashlib

import numpy as np
import pytest

from repro.core import artifact as rart
from repro.core import compile_cache as ref_cc
from repro.core import pipeline as rp
from repro.core.domains import DOMAINS as RDOMAINS
from repro.kernels.domain_map import ops as ref_ops
from repro.launch import analytic as ref_analytic
from repro.serving.evaluate import EvaluationService as RefEvaluationService
from repro_torch.core import artifact as tart
from repro_torch.core import compile_cache as cc
from repro_torch.core import pipeline as tp
from repro_torch.core.domains import DOMAINS as TDOMAINS
from repro_torch.core.registry import MapRegistry
from repro_torch.kernels.domain_map import kernel, ops
from repro_torch.launch import analytic
from repro_torch.serving.evaluate import EvaluationService

MODELS = ("R1:70b", "OSS:120b", "Qw3:32b")
TIMING = ("created_unix", "inference_seconds")


@pytest.fixture(scope="module")
def records():
    """key -> derivation record for 6 paper domains x 3 models x 3 stages,
    derived by the port with no store."""
    grid = tp.run_grid(models=MODELS, n_validate=3000, cache=None)
    return {r.cache_key: tp.record_from_result(r) for r in grid.values()}


def _artifacts(records, pipeline, domains):
    out = {}
    for key, rec in records.items():
        art = pipeline.result_from_record(rec, domains[rec["domain"]],
                                          key).artifact
        if art is not None:
            out[key] = art
    return out


@pytest.fixture(scope="module")
def arts(records):
    return (_artifacts(records, tp, TDOMAINS),
            _artifacts(records, rp, RDOMAINS))


def _one_per_domain(mine, deployable=True):
    seen = {}
    for key, art in sorted(mine.items()):
        if art.deployable == deployable and art.domain not in seen:
            seen[art.domain] = key
    return seen


def _strip(rec):
    return {k: v for k, v in rec.items() if k not in TIMING}


def test_artifact_records_equal_reference(arts):
    mine, ref = arts
    assert set(mine) == set(ref)
    for key in ref:
        a, b = mine[key].to_record(), ref[key].to_record()
        assert a == b, key
        assert mine[key].deployable == ref[key].deployable
        assert mine[key].logic == ref[key].logic
        # a record either package wrote rebuilds in the other
        assert tart.MappingArtifact.from_record(b).to_record() == b
        assert rart.MappingArtifact.from_record(a).to_record() == a
    assert sum(a.deployable for a in mine.values()) > 0
    assert any(not a.deployable for a in mine.values())


def test_fresh_derivation_records_equal_reference():
    from repro.core.backends import MockLLMBackend as RMock
    from repro_torch.core.backends import MockLLMBackend as TMock

    a = tp.derive_mapping(TDOMAINS["pyramid3d"], TMock("OSS:120b"), 50,
                          n_validate=3000, cache=None).artifact
    b = rp.derive_mapping(RDOMAINS["pyramid3d"], RMock("OSS:120b"), 50,
                          n_validate=3000, cache=None).artifact
    assert _strip(a.to_record()) == _strip(b.to_record())
    assert a.report_digest == b.report_digest


def test_spec_fingerprint_is_the_content_address(arts):
    mine, ref = arts
    key = next(iter(sorted(mine)))
    assert cc.spec_fingerprint(mine[key]) == f"artifact:{key}" == \
        ref_cc.spec_fingerprint(ref[key])
    keyless = tart.MappingArtifact.from_record(
        {**mine[key].to_record(), "cache_key": None})
    ref_keyless = rart.MappingArtifact.from_record(keyless.to_record())
    digest = hashlib.sha256(keyless.source.encode()).hexdigest()
    assert cc.spec_fingerprint(keyless) == f"artifact:{digest}" == \
        ref_cc.spec_fingerprint(ref_keyless)


def test_resolve_spec_gates_on_deployability(arts):
    mine, ref = arts
    for key, art in mine.items():
        if art.deployable:
            assert tart.resolve_spec(art) == rart.resolve_spec(ref[key]) == \
                (art.domain, art.logic)
            assert art.registered_entry().domain == art.domain
        else:
            with pytest.raises(ValueError) as e:
                tart.resolve_spec(art)
            with pytest.raises(ValueError) as r:
                rart.resolve_spec(ref[key])
            assert str(e.value) == str(r.value)


def test_non_deployable_artifact_raises_before_any_launch(arts):
    mine, _ = arts
    bad = next(a for a in mine.values() if not a.deployable)
    n0 = kernel.MAP_LAUNCHES
    with pytest.raises(ValueError, match="not deployable"):
        ops.map_coordinates(bad, 1024)
    with pytest.raises(ValueError, match="not deployable"):
        ops.mapped_executable(bad, 1024, 1024, 13, False,
                              compile_cache=None)
    assert kernel.MAP_LAUNCHES == n0


def test_register_exposes_the_derived_scalar_map(arts):
    mine, _ = arts
    art = mine[_one_per_domain(mine)["tri2d"]]
    reg = MapRegistry()
    entry = art.register(reg)
    assert entry.logic == f"derived:{art.model}:s{art.stage}"
    fn = reg.tier("tri2d", entry.logic, "scalar")
    assert [fn(n) for n in range(50)] == [art.scalar_fn()(n)
                                          for n in range(50)]


@pytest.mark.parametrize("domain", ["tri2d", "pyramid3d", "gasket2d",
                                    "carpet2d", "sierpinski3d"])
def test_artifact_launches_equal_reference_interpret(arts, domain):
    mine, ref = arts
    key = _one_per_domain(mine)[domain]
    art, rart_ = mine[key], ref[key]
    for n, start in ((2048, 0), (1500, 777)):
        got = ops.map_coordinates(art, n, block_n=512, interpret=True,
                                  start=start, compile_cache=None)
        want = ref_ops.map_coordinates(rart_, n, block_n=512,
                                       interpret=True, start=start,
                                       compile_cache=None)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        scalar = art.scalar_fn()
        for i in (0, n // 2, n - 1):
            assert tuple(got[i]) == tuple(scalar(start + i))
    ext = tuple(TDOMAINS[domain].bounding_box_extent(2048))
    np.testing.assert_array_equal(
        ops.bb_membership(art, ext, block_n=512, interpret=True,
                          compile_cache=None),
        ref_ops.bb_membership(rart_, ext, block_n=512, interpret=True,
                              compile_cache=None))
    assert ops.block_counts(art, 10**6) == ref_ops.block_counts(rart_,
                                                                10**6)


def test_deployment_analytics_equal_reference(arts):
    mine, ref = arts
    for key in _one_per_domain(mine).values():
        assert analytic.artifact_deployment_analytics(mine[key]) == \
            ref_analytic.artifact_deployment_analytics(ref[key])
        assert analytic.map_deployment_analytics(mine[key], 10**7, 512) == \
            ref_analytic.map_deployment_analytics(ref[key], 10**7, 512)
    for name in TDOMAINS:
        assert analytic.map_deployment_analytics(name) == \
            ref_analytic.map_deployment_analytics(name)


# ---------------------------------------------------------------------------
# key queries through the EvaluationService
# ---------------------------------------------------------------------------


def _services(records):
    def resolver(pipeline, domains):
        def resolve(key):
            rec = records.get(key)
            if rec is None:
                return None
            return pipeline.result_from_record(
                rec, domains[rec["domain"]], key).artifact
        return resolve

    return (EvaluationService(
                artifact_resolver=resolver(tp, TDOMAINS),
                compile_cache=cc.CompileCache(max_entries=32)),
            RefEvaluationService(
                artifact_resolver=resolver(rp, RDOMAINS),
                compile_cache=ref_cc.CompileCache(max_entries=32)))


def _assert_results_equal(mine, ref):
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        assert list(a) == list(b)
        for k in a:
            if isinstance(b[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k])
            else:
                assert a[k] == b[k], k


def test_key_queries_equal_reference(records, arts):
    mine, _ = arts
    keys = _one_per_domain(mine)
    queries = [{"key": k, "n_points": 1000, "interpret": True}
               for k in keys.values()]
    queries += [
        {"key": keys["tri2d"], "n_points": 500, "start": 123_456,
         "interpret": True},
        {"key": keys["gasket2d"], "tier": "membership", "extent": [32, 32],
         "interpret": True},
        {"domain": "tri2d", "n_points": 1000, "interpret": True},
    ]
    ev, ref = _services(records)
    got, meta = ev.evaluate_batch(queries)
    want, ref_meta = ref.evaluate_batch(queries)
    assert meta == ref_meta
    _assert_results_equal(got, want)
    # a key query answers what the same domain query answers
    np.testing.assert_array_equal(got[0]["coords"], got[-1]["coords"])
    assert ev.batch_cache_key(queries) == ref.batch_cache_key(queries)
    assert ev.batch_cache_key(queries)[1] == tuple(sorted(keys.values()))


def test_key_query_refusals_equal_reference(records, arts):
    mine, _ = arts
    bad = next(k for k, a in mine.items() if not a.deployable)
    good = {"key": next(iter(_one_per_domain(mine).values())),
            "n_points": 64, "interpret": True}
    ev, ref = _services(records)
    n0 = kernel.MAP_LAUNCHES
    for q, exc in (({"key": bad, "n_points": 10, "interpret": True},
                    ValueError),
                   ({"key": "0" * 64, "n_points": 10, "interpret": True},
                    KeyError),
                   ({"key": "not-hex", "n_points": 10}, ValueError),
                   ({"key": 7, "n_points": 10}, ValueError)):
        with pytest.raises(exc) as e:
            ev.evaluate_batch([good, q])
        with pytest.raises(exc) as r:
            ref.evaluate_batch([good, q])
        assert str(e.value) == str(r.value)
        assert ev.batch_cache_key([good, q]) is None
    assert ev.stats.errors == ref.stats.errors == 4
    assert kernel.MAP_LAUNCHES == n0
    # without a resolver, a key query is refused as the reference refuses it
    with pytest.raises(ValueError, match="no store attached"):
        EvaluationService(compile_cache=None).evaluate_batch([good])
