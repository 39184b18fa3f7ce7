"""The port's domain-map ops (repro_torch.kernels.domain_map) against the
JAX package's, on the CPU: every case of tests/test_kernels_domain_map.py
and the pallas==scalar cases of tests/test_new_domains.py, λ past 2^31
against the reference's exact numpy tier, and ``interpret=False`` raising
where there is no card.  Both packages run with ``interpret=True``: the
reference's Pallas kernels in interpret mode, the port's plain torch
versions of its CUDA kernels."""
import numpy as np
import pytest
import torch

from repro.core.domains import DOMAINS as REF_DOMAINS
from repro.core.maps import np_map as ref_np_map
from repro.core.registry import REGISTRY as REF_REGISTRY
from repro.kernels.domain_map import ops as ref_ops
from repro.kernels.domain_map.ref import (
    bb_membership_ref as ref_bb_membership_ref,
    map_coordinates_ref as ref_map_coordinates_ref,
)
from repro_torch.core.domains import DOMAINS
from repro_torch.kernels.domain_map import kernel, ops
from repro_torch.kernels.domain_map.ref import (
    bb_membership_ref, map_coordinates_ref,
)

ALL = sorted(REF_DOMAINS)
NEW_DOMAINS = ("msimplex2", "msimplex3", "msimplex4", "msimplex5",
               "cantor2d", "vicsek2d")
N_AGREE = 102_400
BOXES = [
    ("tri2d", (64, 64)),
    ("gasket2d", (64, 64)),
    ("carpet2d", (81, 81)),
    ("pyramid3d", (16, 16, 16)),
    ("sierpinski3d", (16, 16, 16)),
    ("menger3d", (27, 27, 27)),
]


@pytest.mark.parametrize("dom", ALL)
@pytest.mark.parametrize("n", [1024, 4096])
def test_map_matches_reference_ops(dom, n):
    got = ops.map_coordinates(dom, n, block_n=1024, interpret=True)
    want = ref_ops.map_coordinates(dom, n, block_n=1024, interpret=True)
    assert got.dtype == want.dtype == np.int32
    assert got.shape == want.shape == (n, DOMAINS[dom].dim)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, map_coordinates_ref(dom, n))
    np.testing.assert_array_equal(map_coordinates_ref(dom, n),
                                  ref_map_coordinates_ref(dom, n))


@pytest.mark.parametrize("dom,ext", BOXES)
def test_membership_matches_reference_ops(dom, ext):
    got = ops.bb_membership(dom, ext, block_n=1024, interpret=True)
    want = ref_ops.bb_membership(dom, ext, block_n=1024, interpret=True)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, bb_membership_ref(dom, ext))
    np.testing.assert_array_equal(bb_membership_ref(dom, ext),
                                  ref_bb_membership_ref(dom, ext))


@pytest.mark.parametrize("dom", ALL)
def test_full_level_member_counts_match_reference(dom):
    d = DOMAINS[dom]
    if d.kind == "dense":
        # a dense domain's box is not a full level: hold the box of its
        # first 500 points instead
        ext = d.bounding_box_extent(500)
        got = ops.bb_membership(dom, ext, interpret=True)
        want = ref_ops.bb_membership(dom, ext, interpret=True)
        np.testing.assert_array_equal(got, want)
        return
    level = 4 if d.base <= 4 else 2
    ext = (d.scale ** level,) * d.dim
    got = ops.bb_membership(dom, ext, block_n=1024, interpret=True)
    want = ref_ops.bb_membership(dom, ext, block_n=1024, interpret=True)
    assert int(got.sum()) == int(want.sum()) == d.size(level)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dom", ALL)
def test_block_counts_and_plans_match_reference(dom):
    for n in (1000, 4096, 500_000_000):
        assert ops.block_counts(dom, n) == ref_ops.block_counts(dom, n)
    for n, start in ((1000, 0), (4096, 12_345), (1 << 21, 2**31 + 5)):
        mine = ops.map_plan(dom, n, 1024, start)
        ref = ref_ops.map_plan(dom, n, 1024, start)
        assert mine[0].name == ref[0].name and mine[1:] == ref[1:]
    ext = REF_DOMAINS[dom].bounding_box_extent(5000)
    mine = ops.membership_plan(dom, ext, 1024)
    ref = ref_ops.membership_plan(dom, ext, 1024)
    assert mine[1:] == ref[1:]


def test_block_counts_paper_scale():
    bc = ops.block_counts("tri2d", 500_000_000)
    assert bc["mapped_steps"] == 1_953_125
    assert bc["waste_fraction"] > 0.4


@pytest.mark.parametrize("name", NEW_DOMAINS)
def test_pallas_tier_agrees_with_reference_scalar_tier_1e5(name):
    scalar = REF_REGISTRY.tier(name, None, "scalar")
    want = np.array([scalar(i) for i in range(N_AGREE)], dtype=np.int64)
    got = ops.map_coordinates(name, N_AGREE, block_n=12_800, interpret=True)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dom", ALL)
def test_map_past_2_31_matches_reference_exact_tier(dom):
    """The reference's in-kernel tiers are int32 and wrong here; the port
    is exact, so it is held against the reference's numpy tier."""
    start = 2**31 + 5
    got = ops.map_coordinates(dom, 4096, start=start, interpret=True)
    want = ref_np_map(dom, np.arange(start, start + 4096, dtype=np.int64))
    np.testing.assert_array_equal(got.astype(np.int64), want)


def test_membership_box_past_2_31_cells_is_exact():
    """Row-major cell indices past 2^31 unravel exactly in the port (the
    reference kernel builds them in int32): a chunk of the paper-scale
    pyramid3d box, 1442^3 = 2,998,442,888 cells, against
    ``Domain.contains``."""
    extent = (1442, 1442, 1442)
    start = 2**31 + 7
    mask = kernel.membership_plain("pyramid3d", extent, 13, 4096, start)
    lam = np.arange(start, start + 4096, dtype=np.int64)
    coords = np.stack(np.unravel_index(lam, extent), axis=-1)
    np.testing.assert_array_equal(mask[0].numpy(),
                                  REF_DOMAINS["pyramid3d"].contains(coords))


def test_plain_versions_keep_the_kernel_layouts():
    out = kernel.map_plain("msimplex5", 2048, 13, 99)
    assert out.dtype == torch.int32 and out.shape == (5, 2048)
    np.testing.assert_array_equal(
        out.T.numpy(), ref_np_map("msimplex5", np.arange(99, 2147)))
    mask = kernel.membership_plain("menger3d", (9, 9, 9), 3)
    assert mask.dtype == torch.int32 and mask.shape == (1, 729)
    call = kernel.build_map_call("tri2d", 2048, block_n=1024,
                                 interpret=True, lam_offset=7)
    np.testing.assert_array_equal(call(), kernel.map_plain("tri2d", 2048,
                                                           13, 7))
    with pytest.raises(ValueError, match="block multiple"):
        kernel.build_map_call("tri2d", 1000, block_n=1024, interpret=True)


def test_kernel_path_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = (kernel.MAP_LAUNCHES, kernel.MEMBERSHIP_LAUNCHES)
    for call in (
        lambda: ops.map_coordinates("tri2d", 1024, compile_cache=None),
        lambda: ops.bb_membership("tri2d", (16, 16), compile_cache=None),
        lambda: kernel.build_map_call("gasket2d", 1024),
        lambda: kernel.build_membership_call("gasket2d", (32, 32)),
        lambda: kernel.launch_map("tri2d", 1024, 13),
    ):
        with pytest.raises(RuntimeError, match="interpret=True"):
            call()
    assert (kernel.MAP_LAUNCHES, kernel.MEMBERSHIP_LAUNCHES) == before


def test_kernel_descriptor_packs_every_domain():
    for name, g in kernel.GEOMETRY.items():
        c = kernel.pack_geometry(g)
        assert (c.family, c.dim, c.base, c.scale) == (g.family, g.dim,
                                                      g.base, g.scale)
        assert c.allowed == g.allowed and c.nchain == len(g.chain)
        for d, vec in enumerate(g.vecs):
            assert tuple(c.vecs[d * 5:d * 5 + g.dim]) == vec, name
