"""Exact integer inversion helpers.

The paper's dense-domain maps (Table I) invert triangular and tetrahedral
numbers.  Floating-point sqrt/cbrt alone is not exact for large lambda, so
every helper here pairs a float seed with an integer Newton correction.
Scalar (python int) versions are the oracles; the numpy and torch versions
are vectorized and exact in int64.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Scalar (exact, python ints) — oracles
# ---------------------------------------------------------------------------


def isqrt(v: int) -> int:
    """Exact floor(sqrt(v)) for v >= 0."""
    if v < 0:
        raise ValueError("isqrt of negative value")
    return math.isqrt(v)


def tri(n: int) -> int:
    """n-th triangular number T(n) = n(n+1)/2."""
    return n * (n + 1) // 2


def tet(n: int) -> int:
    """n-th tetrahedral number Tet(n) = n(n+1)(n+2)/6."""
    return n * (n + 1) * (n + 2) // 6


def tri_row(lam: int) -> int:
    """Largest x with T(x) <= lam  (row index of linear index lam).

    x = floor(sqrt(1/4 + 2*lam) - 1/2)  ==  (isqrt(8*lam + 1) - 1) // 2
    """
    return (isqrt(8 * lam + 1) - 1) // 2


def tet_layer(lam: int) -> int:
    """Largest z with Tet(z) <= lam (layer index of linear index lam).

    Float cbrt seed (the paper's closed form) + exact integer correction.
    """
    if lam < 0:
        raise ValueError("negative lambda")
    # seed: Tet(z) ~ z^3/6  =>  z ~ cbrt(6*lam)
    z = int(round((6.0 * lam) ** (1.0 / 3.0)))
    while tet(z + 1) <= lam:
        z += 1
    while z > 0 and tet(z) > lam:
        z -= 1
    return z


# ---------------------------------------------------------------------------
# Vectorized numpy (exact via int64 correction) — validation scale (1e6 pts)
# ---------------------------------------------------------------------------


def np_isqrt(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, dtype=np.int64)
    r = np.floor(np.sqrt(v.astype(np.float64))).astype(np.int64)
    # float64 sqrt can be off by 1 ulp near perfect squares — correct both ways.
    r = np.where((r + 1) * (r + 1) <= v, r + 1, r)
    r = np.where(r * r > v, r - 1, r)
    return r


def np_tri_row(lam: np.ndarray) -> np.ndarray:
    lam = np.asarray(lam, dtype=np.int64)
    return (np_isqrt(8 * lam + 1) - 1) // 2


def np_tet_layer(lam: np.ndarray) -> np.ndarray:
    lam = np.asarray(lam, dtype=np.int64)
    z = np.cbrt(6.0 * lam.astype(np.float64)).astype(np.int64)
    # correction window of +-2 covers float64 cbrt error at any int64 lam
    for _ in range(3):
        tet_z1 = (z + 1) * (z + 2) * (z + 3) // 6
        z = np.where(tet_z1 <= lam, z + 1, z)
    for _ in range(3):
        tet_z = z * (z + 1) * (z + 2) // 6
        z = np.where((z > 0) & (tet_z > lam), z - 1, z)
    return np.maximum(z, 0)


# ---------------------------------------------------------------------------
# Vectorized torch (exact int64 on any device: float64 seed + correction)
# ---------------------------------------------------------------------------


def torch_isqrt(v: torch.Tensor) -> torch.Tensor:
    """Exact floor(sqrt(v)) for a non-negative int64 tensor."""
    v = v.to(torch.int64)
    r = torch.floor(torch.sqrt(v.to(torch.float64))).to(torch.int64)
    # float64 sqrt is off by at most one near perfect squares past 2^52; a
    # short monotone ladder restores exactness.
    for _ in range(2):
        r = torch.where((r + 1) * (r + 1) <= v, r + 1, r)
    for _ in range(2):
        r = torch.where(r * r > v, r - 1, r)
    return torch.clamp(r, min=0)


def torch_tri_row(lam: torch.Tensor) -> torch.Tensor:
    lam = lam.to(torch.int64)
    return (torch_isqrt(8 * lam + 1) - 1) // 2


def torch_tet_layer(lam: torch.Tensor) -> torch.Tensor:
    lam = lam.to(torch.int64)
    z = torch.pow(6.0 * lam.to(torch.float64), 1.0 / 3.0).to(torch.int64)
    # the float64 seed is within 2 of the answer; +-3 covers it
    for _ in range(3):
        z = torch.where((z + 1) * (z + 2) * (z + 3) // 6 <= lam, z + 1, z)
    for _ in range(3):
        z = torch.where((z > 0) & (z * (z + 1) * (z + 2) // 6 > lam),
                        z - 1, z)
    return torch.clamp(z, min=0)
