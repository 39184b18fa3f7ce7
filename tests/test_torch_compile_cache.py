"""The port's launcher cache (repro_torch.core.compile_cache): LRU and stats
semantics, key sensitivity, in-flight coalescing, env knobs, the same stats
keys as the JAX package's cache, and trace-free repeat launches through
the ops — all on the CPU with the plain versions of the kernels."""
import threading

import numpy as np
import pytest

from repro.core import compile_cache as ref_cc
from repro_torch.core import compile_cache as cc
from repro_torch.core.domains import DOMAINS
from repro_torch.kernels.domain_map import ops


def _key(tag: str, **kw) -> cc.ExecKey:
    base = dict(fingerprint=f"domain:{tag}", tier="map", shape=(0, 256),
                block_n=128, ndigits=13, interpret=True)
    base.update(kw)
    return cc.ExecKey(**base)


def _cheap_build(value: float):
    def build():
        return lambda: np.full((4,), value)

    return build


def test_hit_miss_and_lru_eviction_order():
    cache = cc.CompileCache(max_entries=2)
    a, b, c = _key("a"), _key("b"), _key("c")
    fa = cache.get(a, _cheap_build(1.0))
    assert cache.stats.misses == 1 and cache.stats.hits == 0
    assert cache.get(a, _cheap_build(1.0)) is fa
    assert cache.stats.hits == 1 and cache.stats.misses == 1

    cache.get(b, _cheap_build(2.0))
    cache.get(a, _cheap_build(1.0))       # touch a: b is now the LRU entry
    cache.get(c, _cheap_build(3.0))       # capacity 2: evicts b, keeps a
    assert cache.stats.evictions == 1
    assert a in cache and c in cache and b not in cache
    cache.get(b, _cheap_build(2.0))
    assert cache.stats.misses == 4
    d = cache.stats_dict()
    assert d["entries"] == 2 and d["max_entries"] == 2
    assert d["hit_ratio"] == pytest.approx(2 / 6)
    assert cache.clear() == 2 and len(cache) == 0


def test_stats_keys_match_the_reference_cache():
    mine = cc.CompileCache(max_entries=3).stats_dict()
    ref = ref_cc.CompileCache(max_entries=3).stats_dict()
    assert list(mine) == list(ref)
    assert mine == ref
    assert [f for f in cc.ExecKey.__dataclass_fields__] == \
        [f for f in ref_cc.ExecKey.__dataclass_fields__]


def test_key_fields_are_all_significant():
    base = _key("x")
    variants = [
        _key("y"),
        _key("x", tier="membership"),
        _key("x", shape=(0, 512)),
        _key("x", block_n=256),
        _key("x", ndigits=9),
        _key("x", dtype="int64"),
        _key("x", interpret=False),
        _key("x", device="cuda:other"),
    ]
    assert len({base, *variants}) == len(variants) + 1
    assert len({k.digest() for k in (base, *variants)}) == len(variants) + 1
    cache = cc.CompileCache(max_entries=32)
    for i, k in enumerate((base, *variants)):
        cache.get(k, _cheap_build(float(i)))
    assert cache.stats.misses == len(variants) + 1


def test_concurrent_cold_callers_coalesce_to_one_build():
    cache = cc.CompileCache(max_entries=8)
    key = _key("shared")
    builds = []
    gate = threading.Event()

    def build():
        builds.append(1)
        gate.wait(5)  # hold the leader so followers genuinely queue
        return lambda: np.zeros((2,))

    fns = []
    mu = threading.Lock()

    def caller():
        fn = cache.get(key, build)
        with mu:
            fns.append(fn)

    threads = [threading.Thread(target=caller) for _ in range(6)]
    for t in threads:
        t.start()
    while not builds:  # leader is inside build()
        pass
    gate.set()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    assert sum(builds) == 1
    assert len({id(f) for f in fns}) == 1
    assert cache.stats.misses == 1
    assert cache.stats.coalesced == 5


def test_failed_build_propagates_and_is_not_cached():
    cache = cc.CompileCache(max_entries=8)
    key = _key("boom")

    def bad_build():
        raise RuntimeError("synthetic build failure")

    with pytest.raises(RuntimeError, match="synthetic"):
        cache.get(key, bad_build)
    assert key not in cache
    fn = cache.get(key, _cheap_build(7.0))
    assert float(fn()[0]) == 7.0


def test_second_identical_call_performs_zero_builds(monkeypatch):
    calls = {"map": 0, "bb": 0}
    real_map, real_bb = ops.build_map_call, ops.build_membership_call

    def counting_map(*a, **kw):
        calls["map"] += 1
        return real_map(*a, **kw)

    def counting_bb(*a, **kw):
        calls["bb"] += 1
        return real_bb(*a, **kw)

    monkeypatch.setattr(ops, "build_map_call", counting_map)
    monkeypatch.setattr(ops, "build_membership_call", counting_bb)
    cache = cc.CompileCache(max_entries=16)
    first = ops.map_coordinates("tri2d", 200, block_n=128, interpret=True,
                                compile_cache=cache)
    second = ops.map_coordinates("tri2d", 200, block_n=128, interpret=True,
                                 compile_cache=cache)
    assert calls["map"] == 1
    assert cache.stats.hits == 1 and cache.stats.misses == 1
    np.testing.assert_array_equal(first, second)
    uncached = ops.map_coordinates("tri2d", 200, block_n=128, interpret=True,
                                   compile_cache=None)
    np.testing.assert_array_equal(first, uncached)
    assert calls["map"] == 2
    mask1 = ops.bb_membership("tri2d", (16, 16), block_n=128, interpret=True,
                              compile_cache=cache)
    mask2 = ops.bb_membership("tri2d", (16, 16), block_n=128, interpret=True,
                              compile_cache=cache)
    assert calls["bb"] == 1
    np.testing.assert_array_equal(mask1, mask2)


def test_distinct_launch_parameters_get_distinct_launchers():
    cache = cc.CompileCache(max_entries=32)
    kw = dict(interpret=True, compile_cache=cache)
    ops.map_coordinates("tri2d", 200, block_n=128, **kw)
    ops.map_coordinates("tri2d", 300, block_n=128, **kw)   # pads 256 vs 384
    ops.map_coordinates("tri2d", 200, block_n=64, **kw)
    ops.map_coordinates("tri2d", 200, block_n=128, start=128, **kw)
    ops.map_coordinates("gasket2d", 200, block_n=128, **kw)
    assert cache.stats.misses == 5 and cache.stats.hits == 0


def test_persist_dir_is_accepted_and_nothing_is_persisted(tmp_path):
    cache = cc.CompileCache(max_entries=8, persist_dir=tmp_path / "p")
    ops.map_coordinates("tri2d", 200, block_n=128, interpret=True,
                        compile_cache=cache)
    d = cache.stats_dict()
    assert d["persist_dir"] == str(tmp_path / "p")
    assert d["disk_hits"] == d["disk_stores"] == d["disk_errors"] == 0
    assert not (tmp_path / "p").exists()


@pytest.fixture
def _fresh_default(monkeypatch):
    monkeypatch.setattr(cc, "_default", None)
    monkeypatch.setattr(cc, "_default_off", False)
    yield
    cc._default = None
    cc._default_off = False


def test_env_knobs_shape_the_default_cache(monkeypatch, tmp_path,
                                           _fresh_default):
    monkeypatch.setenv("REPRO_COMPILE_CACHE_ENTRIES", "7")
    monkeypatch.setenv("REPRO_COMPILE_CACHE_DIR", str(tmp_path))
    cache = cc.default_compile_cache()
    assert cache is not None and cache.max_entries == 7
    assert cache.persist_dir == tmp_path
    assert cc.default_compile_cache() is cache
    assert cc.resolve(cc.USE_DEFAULT) is cache
    assert cc.resolve(None) is None
    mine = cc.CompileCache(max_entries=1)
    assert cc.resolve(mine) is mine


def test_env_zero_and_configure_zero_disable_caching(monkeypatch,
                                                     _fresh_default):
    monkeypatch.setenv("REPRO_COMPILE_CACHE_ENTRIES", "0")
    assert cc.default_compile_cache() is None
    monkeypatch.delenv("REPRO_COMPILE_CACHE_ENTRIES")
    assert cc.configure_default(max_entries=4).max_entries == 4
    assert cc.configure_default(max_entries=0) is None
    assert cc.default_compile_cache() is None
    assert cc.configure_default(max_entries=2).max_entries == 2


def test_malformed_env_value_warns_and_falls_back(monkeypatch,
                                                  _fresh_default):
    monkeypatch.setenv("REPRO_COMPILE_CACHE_ENTRIES", "lots")
    with pytest.warns(UserWarning, match="REPRO_COMPILE_CACHE_ENTRIES"):
        cache = cc.default_compile_cache()
    assert cache is not None
    assert cache.max_entries == cc.DEFAULT_MAX_ENTRIES


def test_spec_fingerprint_identities():
    from repro_torch.core.registry import REGISTRY

    assert cc.spec_fingerprint("tri2d") == "domain:tri2d"
    assert cc.spec_fingerprint(DOMAINS["gasket2d"]) == "domain:gasket2d"
    entry = REGISTRY.ground_truth("msimplex3")
    assert cc.spec_fingerprint(entry) == "entry:msimplex3:analytical"
    assert cc.device_kind() in ("cpu:cpu",) or \
        cc.device_kind().startswith("cuda:")
