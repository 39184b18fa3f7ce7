"""In-kernel geometry: each domain's launch descriptor for the CUDA kernels,
and the plain torch tiers that compute the same function.

Each domain registers two tiers into the MapRegistry:

  pallas      ``f(lam_block, ndigits) -> [axis tensors]`` — the in-kernel
              Table-I map, here the plain int64 torch version of what the
              CUDA map kernel computes (the tier keeps the JAX package's
              name: "the in-kernel function"),
  membership  ``f(axes, ndigits) -> bool mask`` — the bounding-box kernel's
              discard condition, bit for bit the JAX package's tier.

Both tiers are generated from one :class:`KernelGeometry` per domain, the
same descriptor ``kernel.py`` packs into the CUDA kernels' arguments, so
the plain version and the kernel cannot drift apart per domain.  Two
families cover all twelve domains:

  PEEL    the m-simplex layer peel (float seed + exact integer ladder per
          level); ``tri2d`` and ``pyramid3d`` are the m = 2, 3 peels with
          their axes permuted.  Membership is a chain of ``<=`` tests.
  DIGITS  the base-B digit engine: digit d adds ``vecs[d] * scale^level``.
          Membership tests each level's cell code ``sum (axis % scale) *
          scale^k`` against a bitmask of the generator's codes.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core import msimplex as ms
from repro_torch.core.domains import DOMAINS, Domain, SimplexDomain
from repro_torch.core.maps.fractal import torch_map_fractal
from repro_torch.core.registry import register_map

PEEL = 0
DIGITS = 1

#: most axes of any domain (msimplex5) and most digits of any generator
#: (menger3d) — the CUDA descriptor's fixed array sizes.
MAX_DIM = 5
MAX_BASE = 20

#: levels tested when a membership test runs to the last nonzero digit
#: (enough for any int64 axis in base 2)
ALL_LEVELS = 64


@dataclasses.dataclass(frozen=True)
class KernelGeometry:
    """One domain's geometry, as the CUDA kernels take it."""

    name: str
    family: int                       # PEEL | DIGITS
    dim: int
    # PEEL: output axis k is peel layer perm[k] (layers ascending x_1..x_m)
    m: int = 0
    perm: tuple[int, ...] = ()
    chain: tuple[tuple[int, int], ...] = ()   # axes[lo] <= axes[hi]
    nonneg0: bool = False             # also axes[0] >= 0 (box axes always are)
    # DIGITS
    base: int = 0
    scale: int = 0
    vecs: tuple[tuple[int, ...], ...] = ()
    allowed: int = 0                  # bit c set <=> cell code c is allowed
    all_levels: bool = False          # test every level, not ndigits levels


def _cell_code(vec, scale: int) -> int:
    code = 0
    for v in vec:
        code = code * scale + int(v)
    return code


def geometry_for(domain: Domain) -> KernelGeometry:
    """The launch descriptor of a registered domain."""
    if domain.kind == "fractal":
        allowed = 0
        for v in domain.vecs:
            allowed |= 1 << _cell_code(v, domain.scale)
        return KernelGeometry(
            domain.name, DIGITS, domain.dim, base=domain.base,
            scale=domain.scale,
            vecs=tuple(tuple(int(x) for x in v) for v in domain.vecs),
            allowed=allowed,
            # the JAX package's gasket/sierpinski tests are bitwise ANDs over
            # the whole axis; the others test exactly ndigits levels
            all_levels=domain.name in ("gasket2d", "sierpinski3d"))
    if isinstance(domain, SimplexDomain):
        m = domain.m
        return KernelGeometry(
            domain.name, PEEL, m, m=m, perm=tuple(range(m)),
            chain=tuple((k, k + 1) for k in range(m - 1)), nonneg0=True)
    if domain.name == "tri2d":          # (x, y) = (x_2, x_1), y <= x
        return KernelGeometry("tri2d", PEEL, 2, m=2, perm=(1, 0),
                              chain=((1, 0),))
    if domain.name == "pyramid3d":      # (x, y, z) = (x_2, x_1, x_3)
        return KernelGeometry("pyramid3d", PEEL, 3, m=3, perm=(1, 0, 2),
                              chain=((1, 0), (0, 2)))
    raise KeyError(f"no kernel geometry for domain {domain.name!r}")


# ---------------------------------------------------------------------------
# Plain torch tiers (int64)
# ---------------------------------------------------------------------------


def peel_coords(g: KernelGeometry, lam, ndigits):
    del ndigits  # closed-form per level; digits are a fractal concept
    layers = ms.torch_peel_msimplex(lam, g.m)
    return [layers[p] for p in g.perm]


def chain_membership(g: KernelGeometry, axes, ndigits):
    del ndigits
    ok = axes[0] >= 0 if g.nonneg0 else torch.ones_like(axes[0],
                                                        dtype=torch.bool)
    for lo, hi in g.chain:
        ok = ok & (axes[lo] <= axes[hi])
    return ok


def digit_coords(g: KernelGeometry, lam, ndigits):
    return list(torch_map_fractal(DOMAINS[g.name], lam, ndigits).unbind(-1))


def digit_membership(g: KernelGeometry, axes, ndigits):
    cur = torch.stack([a.to(torch.int64) for a in axes])    # (dim, N)
    ok = torch.ones(cur.shape[1:], dtype=torch.bool, device=cur.device)
    allowed = torch.tensor(
        [bool(g.allowed >> c & 1) for c in range(g.scale ** g.dim)],
        device=cur.device)
    for _ in range(ALL_LEVELS if g.all_levels else ndigits):
        if not bool(cur.any()):   # every higher level is the origin cell
            break
        code = torch.zeros_like(cur[0])
        for k in range(g.dim):
            code = code * g.scale + cur[k] % g.scale
        ok &= allowed[code]
        cur = cur // g.scale
    return ok


# ---------------------------------------------------------------------------
# Host-side choices of the CUDA kernels (exact Python integers)
# ---------------------------------------------------------------------------

#: consecutive points per thread-run: the map kernel's PEEL and DIGITS
#: runs and the membership kernel's chain runs (DM_RUN_PEEL, DM_RUN_DIGITS
#: in csrc/map_kernel.cu, DM_RUN_CHAIN in csrc/membership_kernel.cu; the
#: fractal runs: fractal_run)
RUN_PEEL, RUN_DIGITS, RUN_CHAIN = 16, 4, 16
#: (base, dim) / (scale, dim) pairs with a compile-time instantiation in
#: csrc/map_kernel.cu / csrc/membership_kernel.cu; others take the generic one
MAP_SPECIFIC = frozenset({(3, 2), (8, 2), (4, 3), (20, 3), (4, 2), (5, 2)})
MEMBERSHIP_SPECIFIC = frozenset({(2, 2), (2, 3), (3, 2), (3, 3)})
#: shared-memory budget of either kernel's table, bytes
TABLE_BYTES = 32768


def peel_size32_steps(x: int, level: int) -> list[int]:
    """The products the 32-bit ladder forms for C(x+level-1, level), in
    order: ``r * (x+i-1)`` for i = 2..level, r = C(x+i-2, i-1) (csrc/
    domain_map.cuh: dm_simplex_size32).  Each must stay below 2^32."""
    r, steps = x, []
    for i in range(2, level + 1):
        steps.append(r * (x + i - 1))
        r = steps[-1] // i
    return steps


def peel_xmax32(level: int) -> int:
    """Largest x whose 32-bit ladder products all stay below 2^32."""
    lo, hi = 0, 1 << 32
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if max(peel_size32_steps(mid, level), default=mid) < 1 << 32:
            lo = mid
        else:
            hi = mid - 1
    return lo


#: per level, the x bound of the 32-bit ladder (csrc/domain_map.cuh:
#: DM_XMAX32)
PEEL_XMAX32 = {level: peel_xmax32(level) for level in range(2, MAX_DIM + 1)}
#: per m, the exclusive λ bound of the 32-bit peel: below it every level l's
#: layer + 1 <= PEEL_XMAX32[l], so the ladder never forms a product past
#: 2^32 (csrc/map_kernel.cu: DM_LAM32_PEEL)
PEEL_LAM32 = {m: min(ms.simplex_size(PEEL_XMAX32[level], level)
                     for level in range(2, m + 1))
              for m in range(2, MAX_DIM + 1)}
#: the m whose map kernel has a 32-bit peel: where it measured faster than
#: the 64-bit one (PERF.md); m = 2, 3 read the same in both widths
PEEL32_M = frozenset({4, 5})


def map_index_bits(g: KernelGeometry, lam_offset: int, n: int) -> int:
    """32 where the peel has a 32-bit path (``PEEL32_M``) and every λ of
    ``[lam_offset, lam_offset + n)`` is below its proven bound, else 64.
    The DIGITS family is 64-bit throughout: its one division per table of
    digits a run measured no faster in 32 bits (PERF.md)."""
    if g.family == PEEL and g.m in PEEL32_M \
            and lam_offset + n <= PEEL_LAM32[g.m]:
        return 32
    return 64


def membership_index_bits(total: int) -> int:
    """32 where every cell index of the launch fits in a uint32, else 64."""
    return 32 if total <= 1 << 32 else 64


def magic(d: int, bits: int) -> tuple[int, int, int]:
    """(mul, sh1, sh2) dividing any ``bits``-wide unsigned n by d >= 1:
    the round-up method with an add step (csrc/domain_map.cuh: dm_div)."""
    if not 1 <= d < 1 << bits:
        raise ValueError(f"divisor {d} out of range for {bits} bits")
    ell = (d - 1).bit_length()                 # ceil(log2 d)
    mul = ((1 << bits) * ((1 << ell) - d)) // d + 1
    return mul, min(ell, 1), max(ell - 1, 0)


def magic_div(n: int, mg: tuple[int, int, int], bits: int) -> int:
    """n // d through ``mg = magic(d, bits)``, as the kernel computes it."""
    mul, sh1, sh2 = mg
    t = (n * mul) >> bits
    return (t + ((n - t) >> sh1)) >> sh2


def table_digits(base: int, dim: int) -> int:
    """Low digits per entry of the map kernel's table: the most with
    base^L * dim * 4 bytes <= TABLE_BYTES for a compile-time base, the fewest
    with base^L >= RUN_DIGITS for the generic one (csrc/map_kernel.cu)."""
    L, e = 0, 1
    if (base, dim) in MAP_SPECIFIC:
        while e < RUN_DIGITS or e * base * dim * 4 <= TABLE_BYTES:
            e, L = e * base, L + 1
    else:
        while e < RUN_DIGITS:
            e, L = e * base, L + 1
    return L


def group_levels(scale: int, dim: int) -> int:
    """Levels per group of the membership kernel's table: the most with
    scale^(T * dim) bytes <= TABLE_BYTES for a compile-time scale, one for
    the generic one (csrc/membership_kernel.cu: dm_group_levels)."""
    if (scale, dim) not in MEMBERSHIP_SPECIFIC:
        return 1
    T, e, sd = 0, 1, scale ** dim
    while e * sd <= TABLE_BYTES:
        e, T = e * sd, T + 1
    return T


def fractal_run(scale: int, dim: int) -> int:
    """Cells per run of the membership kernel's DIGITS path: 16, or 8 where
    the group block scale^T is under 32 (csrc/membership_kernel.cu:
    dm_fractal_run)."""
    specific = (scale, dim) in MEMBERSHIP_SPECIFIC
    return 8 if specific and scale ** group_levels(scale, dim) < 32 else 16


def digit_groups(g: KernelGeometry, extent, levels: int) -> tuple[int, ...]:
    """(T, groups, top_mod) of a digit membership launch: the groups of T
    levels that cover min(levels, the box axes' digits), and scale^(levels
    in the top group) where ``levels`` stops short of the axes' digits (the
    top group's digits are then reduced mod it), else 0."""
    T = group_levels(g.scale, g.dim)
    axis_digits, v = 0, max(extent) - 1
    while v > 0:
        v, axis_digits = v // g.scale, axis_digits + 1
    eff = min(levels, axis_digits)
    groups = max(1, -(-eff // T))
    top_mod = g.scale ** (eff - T * (groups - 1)) if levels < axis_digits \
        else 0
    return T, groups, top_mod


# ---------------------------------------------------------------------------
# The kernels' run arithmetic in plain torch (rehearsals: the kernels
# themselves are held against the tiers on the card)
# ---------------------------------------------------------------------------


def _run_starts(lam_offset: int, n: int, run: int) -> torch.Tensor:
    return lam_offset + run * torch.arange(-(-n // run), dtype=torch.int64)


def peel_run_coords(g: KernelGeometry, lam_offset: int, n: int,
                    run: int = RUN_PEEL):
    """The map kernel's PEEL runs: each run's first λ peeled in full, the
    rest stepped on the layers' odometer (x_1 + 1 up to x_2, then carry).
    Returns the axes, as ``peel_coords`` does."""
    x = ms.torch_peel_msimplex(_run_starts(lam_offset, n, run), g.m)
    cols = [[] for _ in range(g.m)]
    for _ in range(run):
        for level in range(g.m):
            cols[level].append(x[level].clone())
        x[0] = x[0] + 1
        for level in range(g.m - 1):
            c = x[level] > x[level + 1]
            x[level] = torch.where(c, 0, x[level])
            x[level + 1] = x[level + 1] + c.to(torch.int64)
    layers = [torch.stack(c, dim=1).reshape(-1)[:n] for c in cols]
    return [layers[p] for p in g.perm]


def digit_split_coords(g: KernelGeometry, lam_offset: int, n: int,
                       ndigits: int, run: int = RUN_DIGITS):
    """The map kernel's DIGITS runs: map(λ) = table[λ mod B^L] + scale^L ·
    map(λ div B^L), the table holding map_L of every low part (digits past
    ndigits dropped), the high part derived once per run and once more
    where the run crosses into the next.  Returns the axes (int64)."""
    domain = DOMAINS[g.name]
    L = table_digits(g.base, g.dim)
    BL, SL = g.base ** L, g.scale ** L
    table = torch_map_fractal(domain, torch.arange(BL), min(L, ndigits))

    def high(q):
        acc = torch.zeros(q.shape + (g.dim,), dtype=torch.int64)
        rd, s = ndigits - L, SL
        while rd > 0:
            if rd >= L:
                d, q, rd = q % BL, q // BL, rd - L
            else:
                d, rd = q % g.base ** rd, 0
            acc += s * table[d]
            s *= SL
        return acc

    lam0 = _run_starts(lam_offset, n, run)
    q, lo0 = lam0 // BL, lam0 % BL
    hi, hi2 = high(q), high(q + 1)
    vals = []
    for j in range(run):
        lo = lo0 + j
        c = lo >= BL
        vals.append(table[torch.where(c, lo - BL, lo)]
                    + torch.where(c[:, None], hi2, hi))
    out = torch.stack(vals, dim=1).reshape(-1, g.dim)[:n]
    return list(out.unbind(-1))


def run_unravel(extent, total: int, run: int = RUN_CHAIN) -> torch.Tensor:
    """The membership kernel's cells as (total, dim) axes: each run's first
    cell unravelled through the host's multipliers, axis k = q_k - q_{k-1} ·
    extent[k] (axis 0 mod extent[0]: the padding wraps), the rest stepped on
    the last axis with carries."""
    extent = tuple(int(e) for e in extent)
    bits = membership_index_bits(total)
    strides = [1] * len(extent)
    for k in range(len(extent) - 2, -1, -1):
        strides[k] = strides[k + 1] * extent[k + 1]
    mg = [magic(s, bits) for s in strides]
    mg0 = magic(extent[0], bits)
    firsts = []
    for cell in range(0, total, run):
        axes, prev = [], 0
        for k, e in enumerate(extent):
            q = magic_div(cell, mg[k], bits)
            axes.append(q - magic_div(q, mg0, bits) * e if k == 0
                        else q - prev * e)
            prev = q
        firsts.append(axes)
    a = torch.tensor(firsts, dtype=torch.int64).T.clone()    # (dim, runs)
    ext = torch.tensor(extent, dtype=torch.int64)
    cells = []
    for _ in range(run):
        cells.append(a.clone())
        a[-1] += 1
        for k in range(len(extent) - 1, -1, -1):
            c = a[k] == ext[k]
            a[k] = torch.where(c, 0, a[k])
            if k:
                a[k - 1] += c.to(torch.int64)
    return torch.stack(cells, dim=2).reshape(len(extent), -1)[:, :total].T


def chain_row_membership(g: KernelGeometry, axes: torch.Tensor):
    """The membership kernel's PEEL test on (cells, dim) axes: the chain
    folded per row into rowok && lb <= a_last <= ub."""
    last = g.dim - 1
    ok = torch.ones(axes.shape[0], dtype=torch.bool)
    lb = torch.zeros(axes.shape[0], dtype=torch.int64)
    ub = torch.full((axes.shape[0],), torch.iinfo(torch.int64).max)
    for lo, hi in g.chain:
        if lo != last and hi != last:
            ok &= axes[:, lo] <= axes[:, hi]
        elif lo != last:
            lb = torch.maximum(lb, axes[:, lo])
        elif hi != last:
            ub = torch.minimum(ub, axes[:, hi])
    x = axes[:, last]
    return ok & (x >= lb) & (x <= ub)


def group_table(g: KernelGeometry) -> torch.Tensor:
    """The membership kernel's DIGITS table, as each block builds it in
    shared memory (csrc/membership_kernel.cu: dm_group_cell_ok): for every
    cell of the scale^T cube, row-major over its axes (T = group_levels),
    whether each of its T levels' cell codes is among the generator's
    (``allowed``), as uint8."""
    T = group_levels(g.scale, g.dim)
    Q = g.scale ** T
    cube = torch.arange(Q ** g.dim, dtype=torch.int64)
    ax = [(cube // Q ** (g.dim - 1 - k)) % Q for k in range(g.dim)]
    allowed = torch.tensor([g.allowed >> c & 1 for c in
                            range(g.scale ** g.dim)], dtype=torch.uint8)
    ok = torch.ones_like(cube, dtype=torch.uint8)
    for _ in range(T):
        code = torch.zeros_like(cube)
        for k in range(g.dim):
            code = code * g.scale + ax[k] % g.scale
            ax[k] = ax[k] // g.scale
        ok &= allowed[code]
    return ok


def group_table_membership(g: KernelGeometry, axes: torch.Tensor,
                           extent, levels: int):
    """The membership kernel's DIGITS test on (cells, dim) axes: one read
    per group of T levels from ``group_table``, indexed by every axis's
    digits of that group (the top group's reduced mod top_mod)."""
    T, groups, top_mod = digit_groups(g, extent, levels)
    Q = g.scale ** T
    okt = group_table(g).to(torch.bool)
    ok = torch.ones(axes.shape[0], dtype=torch.bool)
    t = axes.clone()
    for gi in range(groups):
        d = t % Q
        if gi == groups - 1 and top_mod:
            d = d % top_mod
        idx = torch.zeros(axes.shape[0], dtype=torch.int64)
        for k in range(g.dim):
            idx = idx * Q + d[:, k]
        ok &= okt[idx]
        t = t // Q
    return ok


#: domain name -> launch descriptor, for every registered domain
GEOMETRY: dict[str, KernelGeometry] = {
    name: geometry_for(d) for name, d in DOMAINS.items()}

for _g in GEOMETRY.values():
    _coords, _member = ((peel_coords, chain_membership) if _g.family == PEEL
                        else (digit_coords, digit_membership))
    register_map(
        _g.name,
        "analytical" if DOMAINS[_g.name].kind == "dense" else "bitwise",
        tiers={"pallas": functools.partial(_coords, _g),
               "membership": functools.partial(_member, _g)})
