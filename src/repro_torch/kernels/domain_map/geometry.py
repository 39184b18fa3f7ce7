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
