"""The port's geometry base (repro_torch.core + the in-kernel tiers) against
the JAX package: every tier of all 12 domains equals the reference's exact
numpy tier on λ in [0, 1e5), near 2^31 and near the paper's N = 5e8; the
membership tier equals the reference's ``Domain.contains`` and its own
membership tier bit for bit; and the domain table equals the reference's
field by field."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import domains as ref_domains
from repro.core.maps import np_map as ref_np_map
from repro.core.registry import REGISTRY as REF_REGISTRY
from repro_torch.core import domains
from repro_torch.core.maps import np_map, torch_map
from repro_torch.core.registry import REGISTRY, TIERS
from repro_torch.kernels.domain_map import geometry

ALL = sorted(ref_domains.DOMAINS)
N_PAPER = 500_000_000
RANGES = {
    "low": np.arange(100_000, dtype=np.int64),
    "near_2^31": np.arange(2**31 - 500, 2**31 + 500, dtype=np.int64),
    "near_5e8": np.arange(N_PAPER - 500, N_PAPER + 500, dtype=np.int64),
}
# every box of tests/test_kernels_domain_map.py, plus one per other domain
BOXES = {
    "tri2d": (64, 64), "gasket2d": (64, 64), "carpet2d": (81, 81),
    "pyramid3d": (16, 16, 16), "sierpinski3d": (16, 16, 16),
    "menger3d": (27, 27, 27), "cantor2d": (81, 81), "vicsek2d": (81, 81),
    "msimplex2": (64, 64), "msimplex3": (16, 16, 16),
    "msimplex4": (8, 8, 8, 8), "msimplex5": (6, 6, 6, 6, 6),
}


def _ndigits(dom: str, lams: np.ndarray) -> int:
    d = domains.DOMAINS[dom]
    return max(d.level_for_points(int(lams.max()) + 1), 1) \
        if d.kind == "fractal" else 13


def _box_axes(extent):
    lam = np.arange(int(np.prod(extent)), dtype=np.int64)
    return np.stack(np.unravel_index(lam, extent), axis=-1)


def test_registry_has_every_domain_and_tier():
    assert REGISTRY.domains() == ALL
    assert TIERS == ("scalar", "unmap", "numpy", "torch", "pallas",
                     "membership")
    for dom in ALL:
        entry = REGISTRY.ground_truth(dom)
        assert entry.logic == REF_REGISTRY.ground_truth(dom).logic
        assert sorted(entry.tiers) == sorted(TIERS)


@pytest.mark.parametrize("where", sorted(RANGES))
@pytest.mark.parametrize("dom", ALL)
def test_vector_tiers_match_reference_numpy(dom, where):
    lams = RANGES[where]
    want = ref_np_map(dom, lams)
    np.testing.assert_array_equal(np_map(dom, lams), want)
    t = torch.from_numpy(lams)
    nd = _ndigits(dom, lams)
    got = torch_map(dom, t, nd)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    axes = REGISTRY.tier(dom, None, "pallas")(t, nd)
    assert len(axes) == domains.DOMAINS[dom].dim
    np.testing.assert_array_equal(torch.stack(axes, -1).numpy(), want)


@pytest.mark.parametrize("dom", ALL)
def test_scalar_and_unmap_tiers_match_reference_numpy(dom):
    lams = np.concatenate([RANGES["low"], RANGES["near_2^31"],
                           RANGES["near_5e8"]])
    want = ref_np_map(dom, lams)
    scalar = REGISTRY.tier(dom, None, "scalar")
    unmap = REGISTRY.tier(dom, None, "unmap")
    got = np.array([scalar(int(lam)) for lam in lams], dtype=np.int64)
    np.testing.assert_array_equal(got, want)
    back = np.array([unmap(*map(int, c)) for c in want], dtype=np.int64)
    np.testing.assert_array_equal(back, lams)


@pytest.mark.parametrize("dom", ALL)
def test_pallas_tier_drops_digits_past_ndigits_like_the_reference(dom):
    """With fewer digits than λ needs, the in-kernel tier keeps exactly
    ``ndigits`` of them, as the reference's in-kernel tier does."""
    lams = np.arange(4096, dtype=np.int64)
    for nd in (1, 2, 3):
        want = REF_REGISTRY.tier(dom, None, "pallas")(
            jnp.asarray(lams, dtype=jnp.int32), nd)
        got = REGISTRY.tier(dom, None, "pallas")(torch.from_numpy(lams), nd)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dom", ALL)
def test_membership_tier_matches_reference_contains_and_tier(dom):
    extent = BOXES[dom]
    coords = _box_axes(extent)
    member = REGISTRY.tier(dom, None, "membership")
    ref_member = REF_REGISTRY.tier(dom, None, "membership")
    axes = [torch.from_numpy(coords[:, k].copy()) for k in range(len(extent))]
    level_nd = max(domains.DOMAINS[dom].level_for_points(len(coords)), 1) + 1
    got = member(axes, level_nd).numpy()
    np.testing.assert_array_equal(
        got, ref_domains.DOMAINS[dom].contains(coords))
    # bit for bit against the reference tier, also with too few levels
    for nd in (1, 2, level_nd):
        ref = ref_member([jnp.asarray(coords[:, k], dtype=jnp.int32)
                          for k in range(len(extent))], nd)
        np.testing.assert_array_equal(member(axes, nd).numpy(),
                                      np.asarray(ref), err_msg=f"nd={nd}")


def test_domain_table_equals_reference_field_by_field():
    assert list(domains.DOMAINS) == list(ref_domains.DOMAINS)
    for name, ref in ref_domains.DOMAINS.items():
        mine = domains.DOMAINS[name]
        assert type(mine).__name__ == type(ref).__name__
        ref_fields = {f.name: getattr(ref, f.name)
                      for f in dataclasses.fields(ref)}
        my_fields = {f.name: getattr(mine, f.name)
                     for f in dataclasses.fields(mine)}
        assert my_fields == ref_fields, name
        for n in (1, 100, 4096, 10**6, N_PAPER):
            assert mine.level_for_points(n) == ref.level_for_points(n)
            assert mine.bounding_box_extent(n) == ref.bounding_box_extent(n)
            assert mine.block_accounting(n) == ref.block_accounting(n)
        np.testing.assert_array_equal(mine.enumerate_points(500),
                                      ref.enumerate_points(500))
    for table in ("GASKET_VECS", "CARPET_VECS", "SIERP3D_VECS",
                  "MENGER_VECS", "MENGER_VOIDS", "CANTOR2D_VECS",
                  "VICSEK2D_VECS", "MSIMPLEX_MS"):
        assert getattr(domains, table) == getattr(ref_domains, table), table


@pytest.mark.parametrize("dom", ALL)
def test_kernel_geometry_descriptor_follows_the_domain(dom):
    g = geometry.GEOMETRY[dom]
    d = domains.DOMAINS[dom]
    assert g.dim == d.dim
    if d.kind == "fractal":
        assert (g.family, g.base, g.scale) == (geometry.DIGITS, d.base,
                                               d.scale)
        assert g.vecs == tuple(tuple(v) for v in d.vecs)
        assert bin(g.allowed).count("1") == d.base
        assert d.base <= geometry.MAX_BASE and g.scale ** g.dim <= 32
    else:
        assert g.family == geometry.PEEL and sorted(g.perm) == list(
            range(g.m))
    assert d.dim <= geometry.MAX_DIM
