"""The domain-map kernels' run arithmetic, rehearsed on the CPU.

The CUDA kernels (csrc/map_kernel.cu, csrc/membership_kernel.cu) give each
thread a run of consecutive points: the run's first point is derived, the
rest are stepped, in 32-bit arithmetic where the host proves it exact.  The
host's choices are pure Python here (index widths, the 32-bit bounds, the
division multipliers, the digit groups) and are held with exact integers;
the stepping rules are plain-torch functions in ``geometry.py``, held
against the ``pallas``/``membership`` tiers (which test_torch_domain_map.py
ties to the JAX package's kernels).  The kernels themselves are held
against the tiers on the card by ``chip_smoke.py``.
"""
import dataclasses
import math
import re

import numpy as np
import pytest
import torch

from repro.core.domains import DOMAINS as REF_DOMAINS
from repro.core.maps import np_map as ref_np_map
from repro_torch.core import msimplex as ms
from repro_torch.core.domains import DOMAINS
from repro_torch.core.registry import REGISTRY
from repro_torch.kernels.domain_map import geometry as geo
from repro_torch.kernels.domain_map import kernel, ops

PEEL = sorted(n for n, g in geo.GEOMETRY.items() if g.family == geo.PEEL)
DIGITS = sorted(n for n, g in geo.GEOMETRY.items() if g.family == geo.DIGITS)
#: unaligned run starts: small, past 2^28 (the reference's int32 tiers
#: break there), straddling the 32-bit peel bounds and 2^31, near 2^32 and
#: the paper's N = 5e8
STARTS = (0, 1, 3, 2**28 - 5, 2**31 - 1000, 2**32 - 7, 500_000_000 - 2**20)
N_RUN = 1001                    # not a multiple of 4 (a ragged last run)
N_PAPER = 500_000_000
#: chip_smoke.py's boxes: the paper's BB boxes and its ~2^22-cell SMALL_BOX
PAPER_BOXES = {"tri2d": (31623, 31623), "pyramid3d": (1442, 1442, 1442),
               "gasket2d": (32768,) * 2, "carpet2d": (19683,) * 2,
               "sierpinski3d": (1024,) * 3, "menger3d": (729,) * 3}
SMALL_BOX = {2: (2048, 2048), 3: (161, 161, 161), 4: (45,) * 4,
             5: (21,) * 5}
CSRC = kernel.CSRC


def _ndigits(name, n, start):
    return ops.map_plan(name, n, 1, start)[2]


def _pallas(name, n, start, nd):
    lam = torch.arange(n, dtype=torch.int64) + start
    return [a.to(torch.int64) for a in
            REGISTRY.tier(name, None, "pallas")(lam, nd)]


def _strides(extent):
    s = [1] * len(extent)
    for k in range(len(extent) - 2, -1, -1):
        s[k] = s[k + 1] * extent[k + 1]
    return s


# ---------------------------------------------------------------------------
# 32-bit bounds
# ---------------------------------------------------------------------------


def _peel32(lam: int, m: int) -> tuple[list[int], int]:
    """The kernel's 32-bit peel with exact integers: (layers, the largest
    product its ladders form), from the worst seeds (0 and the cap)."""
    worst, layers, rem = 0, [], lam
    for level in range(m, 1, -1):
        cap = geo.PEEL_XMAX32[level] - 1
        for seed in (0, cap):
            x = seed
            size = lambda v: ms.simplex_size(v, level)  # noqa: E731
            worst = max(worst, *geo.peel_size32_steps(x, level),
                        *geo.peel_size32_steps(x + 1, level))
            while size(x + 1) <= rem:
                x += 1
                worst = max(worst, *geo.peel_size32_steps(x + 1, level))
            while size(x) > rem:
                x -= 1
                worst = max(worst, *geo.peel_size32_steps(x, level), 0)
        layers.append(x)
        rem -= ms.simplex_size(x, level)
    return [rem] + layers[::-1], worst


@pytest.mark.parametrize("m", [2, 3, 4, 5])
def test_peel_32_bit_bound_holds_at_the_bound_and_switches_past_it(m):
    bound = geo.PEEL_LAM32[m]
    # the last λ below the bound: every ladder product fits in 32 bits and
    # the layers are the exact peel's
    layers, worst = _peel32(bound - 1, m)
    assert worst < 2**32
    assert tuple(layers) == ms.map_msimplex(bound - 1, m)
    # at the bound some level's layer reaches its cap + 1: its ladder would
    # form a product past 2^32
    top = [lvl for lvl in range(2, m + 1)
           if ms.simplex_size(geo.PEEL_XMAX32[lvl], lvl) == bound][0]
    assert max(geo.peel_size32_steps(geo.PEEL_XMAX32[top] + 1, top)) >= 2**32
    # the host switches to 64 bits exactly there, for every peel domain
    # with a 32-bit path; the others are 64-bit throughout
    for name in PEEL:
        g = geo.GEOMETRY[name]
        if g.m == m:
            below = 32 if m in geo.PEEL32_M else 64
            assert geo.map_index_bits(g, 0, 1024) == below
            assert geo.map_index_bits(g, bound - 5, 5) == below
            assert geo.map_index_bits(g, bound - 5, 6) == 64
            assert geo.map_index_bits(g, bound, 1) == 64


def test_peel_bounds_cover_the_paper_scale_and_match_the_sources():
    for m, bound in geo.PEEL_LAM32.items():
        assert bound >= N_PAPER + 1024          # N = 5e8 is 32-bit throughout
        assert bound < 2**31
    header = (CSRC / "domain_map.cuh").read_text()
    body = re.search(r"dm_xmax32\(int level\) \{(.*?)\}", header, re.S)[1]
    assert {int(a): int(b) for a, b in
            re.findall(r"level == (\d) \? (\d+)u", body)} == geo.PEEL_XMAX32
    src = (CSRC / "map_kernel.cu").read_text()
    table = re.search(r"DM_LAM32_PEEL\[6\] = \{(.*?)\};", src, re.S)[1]
    assert [int(v.strip().rstrip("L")) for v in table.split(",")] == \
        [0, 0] + [geo.PEEL_LAM32[m] if m in geo.PEEL32_M else 0
                  for m in range(2, 6)]
    assert geo.PEEL32_M == {4, 5}


@pytest.mark.parametrize("name", DIGITS)
def test_digit_map_launches_are_64_bit(name):
    g = geo.GEOMETRY[name]
    for start, n in ((0, 1024), (0, N_PAPER), (2**32 - 4096, 4097)):
        assert geo.map_index_bits(g, start, n) == 64
    with pytest.raises(ValueError, match="not proven"):
        kernel._index_bits(geo.map_index_bits(g, 0, 1024), 32, name)


def test_membership_32_bit_bound_and_paper_boxes():
    assert geo.membership_index_bits(2**32) == 32
    assert geo.membership_index_bits(2**32 + 1) == 64
    for name, ext in PAPER_BOXES.items():
        _, padded, _ = ops.membership_plan(name, ext, 1024)
        assert geo.membership_index_bits(padded) == 32, name
    # pyramid3d's box: 1442^3 = 2,998,442,888 cells, padded 2,998,443,008
    assert ops.membership_plan("pyramid3d", PAPER_BOXES["pyramid3d"],
                               1024)[1] == 2_998_443_008


def test_forcing_an_index_width():
    assert kernel._index_bits(32, None, "x") == 32
    assert kernel._index_bits(32, 64, "x") == 64
    assert kernel._index_bits(64, None, "x") == 64
    with pytest.raises(ValueError, match="not proven"):
        kernel._index_bits(64, 32, "x")
    with pytest.raises(ValueError, match="not proven"):
        kernel._index_bits(32, 16, "x")


# ---------------------------------------------------------------------------
# division multipliers
# ---------------------------------------------------------------------------


def _divisors(extent):
    return sorted(set(_strides(extent)) | {extent[0]})


def _magic_div_np32(n: np.ndarray, mg) -> np.ndarray:
    """magic_div at 32 bits, vectorised: n * mul < 2^64 fits a uint64."""
    mul, sh1, sh2 = (np.uint64(v) for v in mg)
    t = (n * mul) >> np.uint64(32)
    return (t + ((n - t) >> sh1)) >> sh2


BOXES = sorted(PAPER_BOXES.items()) + [(f"small{d}", e)
                                       for d, e in SMALL_BOX.items()]


@pytest.mark.parametrize("box,extent", BOXES)
def test_magic_division_equals_floor_division_on_the_boxes(box, extent):
    total = math.prod(extent)
    padded = -(-total // 1024) * 1024
    bits = geo.membership_index_bits(padded)
    rng = np.random.default_rng(1442)
    samples = np.unique(np.concatenate([
        rng.integers(0, padded, 200_000, dtype=np.uint64),
        np.arange(0, 4096, dtype=np.uint64),
        np.arange(padded - 4096, padded, dtype=np.uint64),
        np.array([2**31 - 1, 2**31, 2**32 - 1], dtype=np.uint64)]))
    for d in _divisors(extent):
        mg = geo.magic(d, bits)
        # every index next to a multiple of d inside the padded range
        # (d = 1 divides every index: the samples stand in for them)
        q = np.arange(0, padded // d + 1, dtype=np.uint64) * np.uint64(d)
        near = np.concatenate([q, q + 1, q[q > 0] - 1]) if d > 1 else q[:0]
        for n in (samples, near[near < 2**32]):
            np.testing.assert_array_equal(_magic_div_np32(n, mg),
                                          n // np.uint64(d),
                                          err_msg=f"{box} / {d}")


@pytest.mark.parametrize("bits", [32, 64])
def test_magic_division_exact_across_the_width(bits):
    rng = np.random.default_rng(bits)
    top = 2**bits
    divisors = ([1, 2, 3, 7, 1442, 1442**2, 2**bits - 1, 2**(bits - 1),
                 2**(bits - 1) + 1]
                + [int(v) for v in rng.integers(1, 2**31, 40)])
    for d in divisors:
        mg = geo.magic(d, bits)
        ns = [0, 1, d - 1, d, d + 1, top - 1, top - 2, top - d,
              (top - 1) // d * d, (top - 1) // d * d - 1]
        ns += [int(v) for v in rng.integers(0, 2**62, 64)] if bits == 64 \
            else [int(v) for v in rng.integers(0, top, 64)]
        for n in ns:
            if 0 <= n < top:
                assert geo.magic_div(n, mg, bits) == n // d, (d, n)
    with pytest.raises(ValueError):
        geo.magic(0, 32)
    with pytest.raises(ValueError):
        geo.magic(2**32, 32)


# ---------------------------------------------------------------------------
# the map kernel's runs
# ---------------------------------------------------------------------------


def _carry_starts(name):
    """Starts two λ before every layer of the peel rolls over at once
    (x_M steps, x_1..x_{M-1} return to 0)."""
    m = geo.GEOMETRY[name].m
    return [ms.simplex_size(x, m) - 2 for x in (7, 1000)]


@pytest.mark.parametrize("start", STARTS)
@pytest.mark.parametrize("name", PEEL)
def test_peel_runs_match_the_pallas_tier(name, start):
    nd = _ndigits(name, N_RUN, start)
    got = geo.peel_run_coords(geo.GEOMETRY[name], start, N_RUN)
    want = _pallas(name, N_RUN, start, nd)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", PEEL)
def test_peel_runs_across_every_level_of_carry(name):
    g = geo.GEOMETRY[name]
    for start in _carry_starts(name):
        for run in (4, 8, geo.RUN_PEEL):
            got = geo.peel_run_coords(g, start, 37, run)
            want = _pallas(name, 37, start, 13)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
        # the range really carries through every layer
        layers = ms.torch_peel_msimplex(torch.arange(start, start + 37), g.m)
        assert all(bool((torch.diff(x) < 0).any()) for x in layers[:-1])


def _digit_starts(name):
    """Starts across the table's edge: a run that crosses into the next
    high part, at every level of the high part's groups."""
    g = geo.GEOMETRY[name]
    BL = g.base ** geo.table_digits(g.base, g.dim)
    return [BL - 3, BL * BL - 5, BL**3 - 2, 7 * BL - 1]


@pytest.mark.parametrize("start", STARTS)
@pytest.mark.parametrize("name", DIGITS)
def test_digit_runs_match_the_pallas_tier(name, start):
    nd = _ndigits(name, N_RUN, start)
    got = geo.digit_split_coords(geo.GEOMETRY[name], start, N_RUN, nd)
    want = _pallas(name, N_RUN, start, nd)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", DIGITS)
def test_digit_runs_across_the_table_edge_and_dropped_digits(name):
    g = geo.GEOMETRY[name]
    for start in _digit_starts(name):
        nd = _ndigits(name, 203, start)
        for run in (geo.RUN_DIGITS, 8):
            got = geo.digit_split_coords(g, start, 203, nd, run)
            for a, b in zip(got, _pallas(name, 203, start, nd)):
                assert torch.equal(a, b)
    # fewer digits than the table holds, and λ past base^ndigits: the
    # digits above ndigits are dropped, as the tier drops them
    for nd in (0, 1, 2, geo.table_digits(g.base, g.dim) + 1):
        got = geo.digit_split_coords(g, 123_457, 203, nd)
        for a, b in zip(got, _pallas(name, 203, 123_457, nd)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(geo.GEOMETRY))
def test_map_runs_past_2_31_match_the_exact_numpy_tier(name):
    """Past 2^31 the reference's own in-kernel tiers are int32 and wrong;
    the port's runs are held against its exact numpy tier."""
    start = 2**31 + 5
    g = geo.GEOMETRY[name]
    if g.family == geo.PEEL:
        got = geo.peel_run_coords(g, start, N_RUN)
    else:
        got = geo.digit_split_coords(g, start, N_RUN,
                                     _ndigits(name, N_RUN, start))
    want = ref_np_map(name, np.arange(start, start + N_RUN, dtype=np.int64))
    np.testing.assert_array_equal(torch.stack(got, -1).numpy(), want)


def test_table_sizes_fit_the_shared_memory_budget():
    for name in DIGITS:
        g = geo.GEOMETRY[name]
        L = geo.table_digits(g.base, g.dim)
        assert g.base ** L >= geo.RUN_DIGITS
        assert g.base ** L * g.dim * 4 <= geo.TABLE_BYTES
        T = geo.group_levels(g.scale, g.dim)
        assert g.scale ** (T * g.dim) <= geo.TABLE_BYTES
        table = geo.group_table(g)
        assert table.dtype == torch.uint8
        assert table.numel() == g.scale ** (T * g.dim)
        assert table[0] == 1                     # the origin cell
        assert g.scale ** T >= geo.fractal_run(g.scale, g.dim)
    # the generic base: the fewest digits that hold a run
    L = geo.table_digits(2, 5)
    assert 2 ** L >= geo.RUN_DIGITS > 2 ** (L - 1)
    assert geo.group_levels(5, 2) == 1          # the generic scale
    assert {n: geo.fractal_run(geo.GEOMETRY[n].scale, geo.GEOMETRY[n].dim)
            for n in DIGITS} == {"cantor2d": 16, "carpet2d": 16,
                                 "gasket2d": 16, "menger3d": 8,
                                 "sierpinski3d": 16, "vicsek2d": 16}
    # the run lengths the sources compile in
    src = (CSRC / "map_kernel.cu").read_text() + \
        (CSRC / "membership_kernel.cu").read_text()
    for macro, value in (("DM_RUN_PEEL", geo.RUN_PEEL),
                         ("DM_RUN_DIGITS", geo.RUN_DIGITS),
                         ("DM_RUN_CHAIN", geo.RUN_CHAIN)):
        assert re.search(rf"constexpr int {macro} = (\d+);", src)[1] == \
            str(value)


@pytest.mark.parametrize("name", DIGITS)
def test_group_table_is_the_tier_on_the_group_cube(name):
    """The table each block builds from the generator's codes is the
    membership tier's T-level test on every cell of the scale^T cube."""
    g = geo.GEOMETRY[name]
    T = geo.group_levels(g.scale, g.dim)
    Q = g.scale ** T
    cube = torch.arange(Q ** g.dim, dtype=torch.int64)
    axes = [(cube // Q ** (g.dim - 1 - k)) % Q for k in range(g.dim)]
    want = geo.digit_membership(dataclasses.replace(g, all_levels=False),
                                axes, T)
    assert torch.equal(geo.group_table(g), want.to(torch.uint8))
    assert 0 < int(geo.group_table(g).sum()) < Q ** g.dim


# ---------------------------------------------------------------------------
# the membership kernel's runs
# ---------------------------------------------------------------------------


def _odd_boxes(dim):
    """A box with odd extents, the last one odd, so rows end mid-run."""
    return {2: [(13, 29), (45, 37)], 3: [(7, 9, 11), (13, 5, 27)],
            4: [(5, 7, 3, 9)], 5: [(3, 5, 3, 7, 5)]}[dim]


@pytest.mark.parametrize("name", sorted(geo.GEOMETRY))
def test_run_unravel_matches_the_row_major_unravel(name):
    d = DOMAINS[name]
    for ext in _odd_boxes(d.dim):
        total = math.prod(ext) + 2 * ext[-1] + 3          # wraps the box
        axes = geo.run_unravel(ext, total)
        want = np.stack(np.unravel_index(np.arange(total) % math.prod(ext),
                                         ext), axis=-1)
        np.testing.assert_array_equal(axes.numpy(), want)


@pytest.mark.parametrize("name", sorted(geo.GEOMETRY))
def test_membership_runs_match_the_plain_version(name):
    g, d = geo.GEOMETRY[name], DOMAINS[name]
    boxes = _odd_boxes(d.dim) + [(g.scale ** 3,) * d.dim if g.scale else
                                 (9,) * d.dim]
    for ext in boxes:
        total = math.prod(ext) + 1029                     # the padding wraps
        nd = ops.membership_plan(name, ext, 1)[2]
        want = kernel.membership_plain(name, ext, nd, total)[0]
        run = geo.RUN_CHAIN if g.family == geo.PEEL else \
            geo.fractal_run(g.scale, g.dim)
        axes = geo.run_unravel(ext, total, run)
        if g.family == geo.PEEL:
            got = geo.chain_row_membership(g, axes)
        else:
            levels = geo.ALL_LEVELS if g.all_levels else nd
            got = geo.group_table_membership(g, axes, ext, levels)
        assert torch.equal(got.to(torch.int32), want), ext


@pytest.mark.parametrize("name", DIGITS)
def test_digit_groups_cut_the_levels_where_the_tier_does(name):
    """Fewer levels than the axes have digits: the top group's digits are
    reduced, as the tier stops testing there."""
    g = geo.GEOMETRY[name]
    ext = (g.scale ** 4 + 1,) * g.dim
    axes = geo.run_unravel(ext, math.prod(ext))
    for levels in (0, 1, 2, 3, 5):           # the axes have 5 digits
        T, groups, top_mod = geo.digit_groups(g, ext, levels)
        assert groups == max(1, -(-levels // T))
        assert top_mod == (g.scale ** (levels - T * (groups - 1))
                           if levels < 5 else 0)
        if g.all_levels:
            continue       # the tier ignores ndigits for these two
        want = kernel.membership_plain(name, ext, levels)[0]
        got = geo.group_table_membership(g, axes, ext, levels)
        assert torch.equal(got.to(torch.int32), want), levels


def test_paper_box_digit_groups():
    got = {n: geo.digit_groups(geo.GEOMETRY[n], e,
                               ops.membership_plan(n, e, 1024)[2]
                               if not geo.GEOMETRY[n].all_levels
                               else geo.ALL_LEVELS)
           for n, e in PAPER_BOXES.items() if n in DIGITS}
    # (levels per group, groups, top modulus) on the four fractal boxes
    assert got == {"gasket2d": (7, 3, 0), "carpet2d": (4, 3, 0),
                   "sierpinski3d": (5, 2, 0), "menger3d": (3, 2, 0)}


def test_pack_geometry_rejects_a_generator_without_the_origin():
    g = dataclasses.replace(geo.GEOMETRY["gasket2d"],
                            vecs=((1, 0), (0, 1), (1, 1)), allowed=0b1110)
    with pytest.raises(ValueError, match="origin"):
        kernel.pack_geometry(g)
    # every registered fractal, in both packages, starts at the origin
    for name in DIGITS:
        assert not any(REF_DOMAINS[name].vecs[0])
        assert not any(geo.GEOMETRY[name].vecs[0])
