"""Generalized m-simplex block-space maps (paper refs [5], [8]; future-work
direction "more heterogeneous HPC topologies").

The m-simplex domain is {(x_1..x_m) : 0 <= x_1 <= x_2 <= ... <= x_m}; its
size at side n is the binomial C(n+m-1, m) (m=2: triangular numbers, m=3:
tetrahedral — paper Table I rows 1-2 are the m=2,3 specializations).

The linear map peels one coordinate per level: the largest x_m with
simplex_size(x_m, m) <= lambda, recursing on the remainder with m-1 — each
level inverted by a float seed (the paper's sqrt/cbrt generalizes to the
m-th root) plus an exact integer correction.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def simplex_size(n: int, m: int) -> int:
    """|m-simplex| with side n: C(n+m-1, m)."""
    return math.comb(n + m - 1, m)


def simplex_layer(lam: int, m: int) -> int:
    """Largest x with simplex_size(x, m) <= lam.

    Float seed x ~ (m! * lam)^(1/m) (the generalized sqrt/cbrt of Table I),
    then an exact ladder — the paper's analytical O(1) structure for any m.
    """
    if lam < 0:
        raise ValueError("negative lambda")
    if m == 1:
        return lam
    x = int(round((math.factorial(m) * lam) ** (1.0 / m)))
    while simplex_size(x + 1, m) <= lam:
        x += 1
    while x > 0 and simplex_size(x, m) > lam:
        x -= 1
    return x


def map_msimplex(lam: int, m: int) -> tuple[int, ...]:
    """lambda -> (x_1 <= x_2 <= ... <= x_m), the canonical enumeration."""
    coords = []
    for level in range(m, 0, -1):
        x = simplex_layer(lam, level)
        coords.append(x)
        lam -= simplex_size(x, level)
    return tuple(reversed(coords))


def unmap_msimplex(coords: tuple[int, ...]) -> int:
    """(x_1 <= ... <= x_m) -> lambda (rank in canonical order)."""
    lam = 0
    for level, x in enumerate(reversed(coords), start=0):
        lam += simplex_size(x, len(coords) - level)
    return lam


def enumerate_msimplex(n_points: int, m: int) -> np.ndarray:
    """First n_points of the canonical enumeration, (N, m) — independent
    nested-loop construction for validating the map."""
    out = np.empty((n_points, m), dtype=np.int64)

    def gen(m_left, bound):
        """Yield tuples (x_1 <= ... <= x_{m_left}) with x_{m_left} <= bound,
        outermost coordinate slowest (canonical order)."""
        if m_left == 0:
            yield ()
            return
        for x in range(bound + 1):
            for rest in gen(m_left - 1, x):
                yield rest + (x,)

    idx = 0
    x_outer = 0
    while idx < n_points:
        for rest in gen(m - 1, x_outer):
            if idx >= n_points:
                break
            out[idx] = rest + (x_outer,)
            idx += 1
        x_outer += 1
    return out


# ---------------------------------------------------------------------------
# Vectorized tiers (module-generic over the array module; the numpy tier is
# exact int64, the torch tier below is exact int64 on any device)
# ---------------------------------------------------------------------------


def vec_simplex_size(xp, x, m: int):
    """C(x+m-1, m) elementwise, with division interleaved stepwise so the
    running value stays a binomial coefficient: after step i the register
    holds C(x+i-1, i), and C(x+i-2, i-1)*(x+i-1) = i*C(x+i-1, i) makes each
    division exact.  Intermediates are bounded by ~m*C(x+m-1, m), so in an
    int32 kernel the tier is exact for lambda up to ~2^31/m (the same order
    as the existing dense tiers' 8*lam+1 / z^3 seeds) instead of the
    ~(2^31)^(1/m) a naive full product would allow."""
    r = xp.ones_like(x)
    for i in range(1, m + 1):
        r = r * (x + i - 1) // i
    return r


def vec_simplex_layer(xp, lam, m: int):
    """Vectorized `simplex_layer`: float m-th-root seed (the generalized
    sqrt/cbrt of Table I) + exact integer correction ladder."""
    if m == 1:
        return lam
    ftype = xp.float64 if xp is np else xp.float32
    seed = xp.power(lam.astype(ftype) * float(math.factorial(m)), 1.0 / m)
    x = seed.astype(lam.dtype)
    for _ in range(4):
        x = xp.where(vec_simplex_size(xp, x + 1, m) <= lam, x + 1, x)
        x = xp.where((x > 0) & (vec_simplex_size(xp, x, m) > lam), x - 1, x)
    return xp.maximum(x, 0)


def vec_map_msimplex(xp, lams, m: int):
    """Vectorized `map_msimplex`: (N,) lambdas -> (N, m) sorted coords.

    `xp` is the array module — numpy (exact int64, the validation tier)."""
    rem = xp.asarray(lams)
    cols = []
    for level in range(m, 0, -1):
        x = vec_simplex_layer(xp, rem, level)
        cols.append(x)
        rem = rem - vec_simplex_size(xp, x, level)
    return xp.stack(list(reversed(cols)), axis=-1)


def np_map_msimplex(lams: np.ndarray, m: int) -> np.ndarray:
    """Exact vectorized int64 map (the 10^6-point validation tier)."""
    return vec_map_msimplex(np, np.asarray(lams, dtype=np.int64), m)


def torch_simplex_layer(lam: torch.Tensor, m: int) -> torch.Tensor:
    """`vec_simplex_layer` for int64 tensors: a float64 m-th-root seed and
    the same exact ladder.  Written out because tensors have no
    ``.astype``; the float64 seed is within 3 of the answer for any lambda
    whose binomial fits int64, so the 4-step ladder is exact there."""
    if m == 1:
        return lam
    seed = torch.pow(lam.to(torch.float64) * float(math.factorial(m)),
                     1.0 / m)
    x = seed.to(torch.int64)
    for _ in range(4):
        x = torch.where(vec_simplex_size(torch, x + 1, m) <= lam, x + 1, x)
        x = torch.where((x > 0) & (vec_simplex_size(torch, x, m) > lam),
                        x - 1, x)
    return torch.clamp(x, min=0)


def torch_peel_msimplex(lams: torch.Tensor, m: int) -> list[torch.Tensor]:
    """The layer peel on int64 tensors: ``[x_1, ..., x_m]`` (ascending)."""
    rem = lams.to(torch.int64)
    cols = []
    for level in range(m, 0, -1):
        x = torch_simplex_layer(rem, level)
        cols.append(x)
        rem = rem - vec_simplex_size(torch, x, level)
    return cols[::-1]


def torch_map_msimplex(lams: torch.Tensor, m: int) -> torch.Tensor:
    """Exact int64 tensor map: (N,) lambdas -> (N, m) sorted coords."""
    return torch.stack(torch_peel_msimplex(lams, m), dim=-1)


def block_accounting_msimplex(n_points: int, m: int, block: int = 256) -> dict:
    """BB waste for the m-simplex: the box is n^m vs C(n+m-1, m) ~ n^m/m!.

    The waste fraction approaches 1 - 1/m! — the paper's 2D ~50% and 3D ~83%
    generalize to 96% (m=4), 99.2% (m=5): the mapped kernel's advantage
    GROWS with dimension.
    """
    n = 0
    while simplex_size(n, m) < n_points:
        n += 1
    valid = -(-n_points // block)
    bb = -(-(n ** m) // block)
    return {
        "side": n, "valid_blocks": valid, "bb_blocks": bb,
        "waste_fraction": (bb - valid) / bb if bb else 0.0,
        "asymptotic_waste": 1.0 - 1.0 / math.factorial(m),
    }
