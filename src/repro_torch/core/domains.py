"""Computational domains: the paper's six (Table I / Fig. 4) plus the
beyond-paper families — the m-simplex family (m=2..5, Navarro et al.,
arXiv:2208.11617) and the embedded-2D-fractal family (Navarro et al.,
arXiv:2004.13475).

Each Domain knows how to:
  * enumerate its first N points in canonical order (the ground-truth dataset
    of Sec. IV — generated *independently* of the analytical maps so the maps
    can be validated against it),
  * test membership (vectorized) — the bounding-box baseline's `if`,
  * report exact sizes, bounding boxes and block-waste accounting.

Geometry is supplied by subclasses (``DenseTriangularDomain``,
``DensePyramidDomain``, ``SimplexDomain``, ``DigitFractalDomain``) — adding a
domain family means adding a subclass + ``register_domain`` call, never an
if-chain over names.

Canonical orders:
  dense domains   — row-major nested loops (lambda = rank in loop order),
  simplex domains — sorted-ascending coordinates, outermost axis slowest,
  fractal domains — recursive construction, most-significant digit outermost
                    (identical to ascending base-B digit order of lambda).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core import msimplex as ms
from repro_torch.core.inverse import tet, tri

# ---------------------------------------------------------------------------
# Fractal digit -> translation-vector tables (Table I, rightmost column)
# ---------------------------------------------------------------------------

GASKET_VECS = ((0, 0), (1, 0), (0, 1))  # base 3, spatial scale 2
CARPET_VECS = tuple(
    (x, y) for x in range(3) for y in range(3) if not (x == 1 and y == 1)
)  # base 8, spatial scale 3
SIERP3D_VECS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1))  # base 4, scale 2
MENGER_VECS = tuple(
    (x, y, z)
    for x in range(3)
    for y in range(3)
    for z in range(3)
    if (x == 1) + (y == 1) + (z == 1) < 2
)  # base 20 (27 - 7 voids), spatial scale 3
MENGER_VOIDS = tuple(
    (x, y, z)
    for x in range(3)
    for y in range(3)
    for z in range(3)
    if (x == 1) + (y == 1) + (z == 1) >= 2
)

# embedded-2D-fractal family generators (digit 0 must be the origin cell so
# lambda=0 maps to the origin at every recursion depth)
CANTOR2D_VECS = ((0, 0), (0, 2), (2, 0), (2, 2))        # base 4, scale 3
VICSEK2D_VECS = ((0, 0), (0, 2), (1, 1), (2, 0), (2, 2))  # base 5, scale 3

assert len(CARPET_VECS) == 8 and len(MENGER_VECS) == 20 and len(MENGER_VOIDS) == 7
assert all(v[0] == (0,) * len(v[0]) for v in
           (GASKET_VECS, CARPET_VECS, SIERP3D_VECS, MENGER_VECS,
            CANTOR2D_VECS, VICSEK2D_VECS))


def bb_block_dims(dim: int, block: int = 256) -> tuple[int, ...]:
    """CUDA-style block shape for a bounding-box launch: `block` threads
    split into `dim` near-equal power-of-two factors (16x16 in 2D, 8x8x4 in
    3D, 4x4x4x4 in 4D, ...)."""
    if block & (block - 1):
        raise ValueError(f"block must be a power of two, got {block}")
    bits = block.bit_length() - 1
    per = [bits // dim + (1 if k < bits % dim else 0) for k in range(dim)]
    return tuple(1 << b for b in per)


@dataclasses.dataclass(frozen=True)
class Domain:
    """A computational domain with canonical enumeration + membership.

    The base class carries shared metadata and the block-waste accounting;
    geometry (sizes, enumeration, membership, bounding boxes) comes from the
    subclass."""

    name: str          # internal id
    paper_name: str    # name used in the paper's tables
    dim: int
    kind: str          # "dense" | "fractal"
    complexity: str    # ground-truth map cost class, e.g. "O(1)", "O(log3 N)"
    base: int | None = None       # fractal digit base B
    scale: int | None = None      # fractal spatial scale per level
    vecs: Sequence[tuple] | None = None  # fractal digit->vector table

    # -- geometry hooks (subclass responsibility) ---------------------------
    def size(self, n: int) -> int:
        """|domain| for structural parameter n (rows / layers / levels)."""
        raise NotImplementedError(self.name)

    def enumerate_points(self, n_points: int) -> np.ndarray:
        """First n_points coordinates in canonical order, shape (N, dim)."""
        raise NotImplementedError(self.name)

    def contains(self, coords: np.ndarray) -> np.ndarray:
        """Vectorized membership test for (N, dim) int coords."""
        raise NotImplementedError(self.name)

    def bounding_box_extent(self, n_points: int) -> tuple[int, ...]:
        """Per-axis extent of the minimal axis-aligned box holding the first
        n_points canonical points."""
        raise NotImplementedError(self.name)

    # -- shared accounting --------------------------------------------------
    def level_for_points(self, n_points: int) -> int:
        """Smallest structural parameter whose domain holds >= n_points."""
        n = 0
        while self.size(n) < n_points:
            n += 1
        return n

    def block_accounting(self, n_points: int, block: int = 256) -> dict:
        """Blocks launched by the bounding-box strategy vs the mapped strategy.

        Matches the paper's Tables VIII/IX accounting: the mapped (block-space)
        kernel launches ceil(N / block) linear blocks; the BB kernel launches a
        grid over the bounding box with root-shaped CUDA blocks
        (16x16 in 2D, 8x8x4 in 3D -> 256 threads; see ``bb_block_dims``).
        """
        valid = -(-n_points // block)
        ext = self.bounding_box_extent(n_points)
        bb = 1
        for e, b in zip(ext, bb_block_dims(self.dim, block)):
            bb *= -(-e // b)
        return {
            "valid_blocks": valid,
            "bb_blocks": bb,
            "wasted_blocks": max(bb - valid, 0),
            "waste_fraction": max(bb - valid, 0) / bb if bb else 0.0,
        }


# ---------------------------------------------------------------------------
# Dense Table-I domains (row-major nested-loop canonical order)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DenseTriangularDomain(Domain):
    """2D triangular domain: {(x, y) : 0 <= y <= x}."""

    def size(self, n: int) -> int:
        return tri(n)

    def enumerate_points(self, n_points: int) -> np.ndarray:
        out = np.empty((n_points, 2), dtype=np.int64)
        i = 0
        x = 0
        while i < n_points:
            for y in range(x + 1):
                if i >= n_points:
                    break
                out[i] = (x, y)
                i += 1
            x += 1
        return out

    def contains(self, coords: np.ndarray) -> np.ndarray:
        c = np.asarray(coords, dtype=np.int64)
        return (c[:, 1] >= 0) & (c[:, 1] <= c[:, 0])

    def bounding_box_extent(self, n_points: int) -> tuple[int, ...]:
        rows = int(np.ceil((np.sqrt(8.0 * n_points + 1) - 1) / 2))
        return (rows, rows)


@dataclasses.dataclass(frozen=True)
class DensePyramidDomain(Domain):
    """3D pyramid domain: {(x, y, z) : 0 <= y <= x <= z}."""

    def size(self, n: int) -> int:
        return tet(n)

    def enumerate_points(self, n_points: int) -> np.ndarray:
        out = np.empty((n_points, 3), dtype=np.int64)
        i = 0
        z = 0
        while i < n_points:
            for x in range(z + 1):
                for y in range(x + 1):
                    if i >= n_points:
                        break
                    out[i] = (x, y, z)
                    i += 1
                if i >= n_points:
                    break
            z += 1
        return out

    def contains(self, coords: np.ndarray) -> np.ndarray:
        c = np.asarray(coords, dtype=np.int64)
        return (c[:, 1] >= 0) & (c[:, 1] <= c[:, 0]) & (c[:, 0] <= c[:, 2])

    def bounding_box_extent(self, n_points: int) -> tuple[int, ...]:
        z = self.level_for_points(n_points)
        return (z, z, z)


# ---------------------------------------------------------------------------
# m-simplex family (sorted-ascending canonical order; core/msimplex.py math)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SimplexDomain(Domain):
    """The m-simplex {(x_1..x_m) : 0 <= x_1 <= ... <= x_m}; |side n| is the
    binomial C(n+m-1, m).  m=2/3 are the paper's triangular/tetrahedral rows
    in sorted-coordinate convention; the family generalizes them upward."""

    m: int = 2

    def size(self, n: int) -> int:
        return ms.simplex_size(n, self.m)

    def enumerate_points(self, n_points: int) -> np.ndarray:
        return ms.enumerate_msimplex(n_points, self.m)

    def contains(self, coords: np.ndarray) -> np.ndarray:
        c = np.asarray(coords, dtype=np.int64)
        ok = c[:, 0] >= 0
        for k in range(self.m - 1):
            ok &= c[:, k] <= c[:, k + 1]
        return ok

    def bounding_box_extent(self, n_points: int) -> tuple[int, ...]:
        side = self.level_for_points(n_points)
        return (side,) * self.m


# ---------------------------------------------------------------------------
# Digit-decomposition fractals (paper's four + the embedded-2D family)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DigitFractalDomain(Domain):
    """Self-similar fractal built from a digit->cell generator: a point is in
    the fractal iff at every recursion level its (coord % scale) cell is one
    of the generator's `vecs`.  Covers the paper's four fractals and any
    embedded fractal with an origin-anchored generator."""

    def __post_init__(self):
        cells = {tuple(v) for v in self.vecs}
        assert len(cells) == self.base, (self.name, "duplicate generator cell")
        assert (0,) * self.dim in cells, (self.name, "generator must anchor 0")

    def size(self, n: int) -> int:
        return self.base ** n

    def enumerate_points(self, n_points: int) -> np.ndarray:
        # iterative digit construction, vectorized over levels: point(lam) =
        # sum_i vec(d_i) * scale^i — built independently from core/maps so the
        # maps can be validated against it (no shared code path).
        level = self.level_for_points(n_points)
        pts = np.zeros((1, self.dim), dtype=np.int64)
        vecs = np.asarray(self.vecs, dtype=np.int64)
        for lev in range(level):
            # new_points = concat_d [ vec(d)*scale^lev + pts ]: lev grows and
            # d becomes the new most-significant digit (canonical order).
            offs = vecs * (self.scale ** lev)
            pts = (offs[:, None, :] + pts[None, :, :]).reshape(-1, self.dim)
            if len(pts) >= n_points:
                break
        return pts[:n_points]

    def contains(self, coords: np.ndarray) -> np.ndarray:
        c = np.asarray(coords, dtype=np.int64).copy()
        # encode each level's cell as a base-`scale` code and test it against
        # the generator's allowed codes — one rule for every digit fractal.
        allowed = np.sort(np.asarray(
            [self._cell_code(v) for v in self.vecs], dtype=np.int64))
        ok = (c >= 0).all(axis=1)
        while (c > 0).any():
            code = np.zeros(len(c), dtype=np.int64)
            for k in range(self.dim):
                code = code * self.scale + (c[:, k] % self.scale)
            ok &= np.isin(code, allowed, assume_unique=False)
            c //= self.scale
        return ok

    def _cell_code(self, vec) -> int:
        code = 0
        for v in vec:
            code = code * self.scale + int(v)
        return code

    def bounding_box_extent(self, n_points: int) -> tuple[int, ...]:
        ext = self.scale ** self.level_for_points(n_points)
        return (ext,) * self.dim


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

TRI2D = DenseTriangularDomain("tri2d", "2D Triangular", 2, "dense", "O(1)")
PYRAMID3D = DensePyramidDomain("pyramid3d", "3D Pyramid", 3, "dense", "O(1)")
GASKET2D = DigitFractalDomain(
    "gasket2d", "2D Sierpinski Gasket", 2, "fractal", "O(log3 N)",
    base=3, scale=2, vecs=GASKET_VECS,
)
CARPET2D = DigitFractalDomain(
    "carpet2d", "2D Sierpinski Carpet", 2, "fractal", "O(log8 N)",
    base=8, scale=3, vecs=CARPET_VECS,
)
SIERPINSKI3D = DigitFractalDomain(
    "sierpinski3d", "3D Sierpinski Pyramid", 3, "fractal", "O(log4 N)",
    base=4, scale=2, vecs=SIERP3D_VECS,
)
MENGER3D = DigitFractalDomain(
    "menger3d", "3D Menger Sponge", 3, "fractal", "O(log20 N)",
    base=20, scale=3, vecs=MENGER_VECS,
)

#: m-simplex family (beyond-paper; m=2..5)
MSIMPLEX_MS = (2, 3, 4, 5)
MSIMPLEX_DOMAINS = tuple(
    SimplexDomain(f"msimplex{m}", f"{m}-Simplex", m, "dense", "O(1)", m=m)
    for m in MSIMPLEX_MS
)

#: embedded-2D-fractal family (beyond-paper)
CANTOR2D = DigitFractalDomain(
    "cantor2d", "2D Cantor Dust", 2, "fractal", "O(log4 N)",
    base=4, scale=3, vecs=CANTOR2D_VECS,
)
VICSEK2D = DigitFractalDomain(
    "vicsek2d", "2D Vicsek Saltire", 2, "fractal", "O(log5 N)",
    base=5, scale=3, vecs=VICSEK2D_VECS,
)
EMBEDDED_FRACTAL_DOMAINS = (CANTOR2D, VICSEK2D)

#: the six domains the paper measures (Tables II-IX)
PAPER_DOMAINS = (TRI2D, PYRAMID3D, GASKET2D, CARPET2D, SIERPINSKI3D, MENGER3D)

DOMAINS: dict[str, Domain] = {}


def register_domain(domain: Domain) -> Domain:
    """Add a domain to the global name -> Domain table (plugin entry point)."""
    DOMAINS[domain.name] = domain
    return domain


for _d in (*PAPER_DOMAINS, *MSIMPLEX_DOMAINS, *EMBEDDED_FRACTAL_DOMAINS):
    register_domain(_d)


def get_domain(name: str) -> Domain:
    if name not in DOMAINS:
        raise KeyError(f"unknown domain {name!r}; have {sorted(DOMAINS)}")
    return DOMAINS[name]
