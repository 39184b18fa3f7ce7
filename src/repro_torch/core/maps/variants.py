"""Variant logic classes observed in the paper's Tables VIII/IX.

Sqrt+Loop, BinSearch O(log N), Linear O(N^{1/3}), Approx+If: functionally
correct alternatives with different cost profiles — what several LLMs emitted
instead of the closed form.  The deployment benchmarks need them to reproduce
the performance stratification; each registers a scalar tier under its
(domain, logic) key.
"""
from __future__ import annotations

from repro_torch.core.maps.dense import map_tri2d
from repro_torch.core.registry import register_map


@register_map("tri2d", "sqrt_loop", tier="scalar", complexity_class="O(1)")
def map_tri2d_sqrt_loop(lam: int) -> tuple[int, int]:
    """R1:70b (Stage 100): float sqrt seed then while-loop correction."""
    x = int((2.0 * lam) ** 0.5)
    while (x + 1) * (x + 2) // 2 <= lam:
        x += 1
    while x * (x + 1) // 2 > lam:
        x -= 1
    return x, lam - x * (x + 1) // 2


@register_map("tri2d", "binsearch", tier="scalar", complexity_class="O(log N)")
def map_tri2d_binsearch(lam: int) -> tuple[int, int]:
    """Qw3:32b (Stage 50): O(log N) binary search over rows."""
    lo, hi = 0, 1
    while hi * (hi + 1) // 2 <= lam:
        hi *= 2
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if mid * (mid + 1) // 2 <= lam:
            lo = mid
        else:
            hi = mid - 1
    return lo, lam - lo * (lo + 1) // 2


@register_map("tri2d", "approx_if", tier="scalar", complexity_class="O(1)")
def map_tri2d_approx_if(lam: int) -> tuple[int, int]:
    """OSS:20b: float closed form + a single boundary fix-up `if`."""
    x = int(((8.0 * lam + 1.0) ** 0.5 - 1.0) / 2.0)
    if (x + 1) * (x + 2) // 2 <= lam:
        x += 1
    if x * (x + 1) // 2 > lam:
        x -= 1
    return x, lam - x * (x + 1) // 2


@register_map("pyramid3d", "cbrt_loop", tier="scalar", complexity_class="O(1)")
def map_pyramid3d_cbrt_loop(lam: int) -> tuple[int, int, int]:
    """R1:70b / Qw3:32b: cbrt seed + short correction loop (still O(1))."""
    z = int(round((6.0 * lam) ** (1.0 / 3.0)))
    while (z + 1) * (z + 2) * (z + 3) // 6 <= lam:
        z += 1
    while z > 0 and z * (z + 1) * (z + 2) // 6 > lam:
        z -= 1
    x, y = map_tri2d(lam - z * (z + 1) * (z + 2) // 6)
    return x, y, z


@register_map("pyramid3d", "binsearch", tier="scalar",
              complexity_class="O(log N)")
def map_pyramid3d_binsearch(lam: int) -> tuple[int, int, int]:
    """OSS:120b (Stage 100) / Qw3:235b: O(log N) binary search over layers."""
    lo, hi = 0, 1
    while hi * (hi + 1) * (hi + 2) // 6 <= lam:
        hi *= 2
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if mid * (mid + 1) * (mid + 2) // 6 <= lam:
            lo = mid
        else:
            hi = mid - 1
    x, y = map_tri2d(lam - lo * (lo + 1) * (lo + 2) // 6)
    return x, y, lo


@register_map("pyramid3d", "linear", tier="scalar",
              complexity_class="O(N^1/3)")
def map_pyramid3d_linear(lam: int) -> tuple[int, int, int]:
    """OSS:120b (Stage 20): O(N^{1/3}) linear scan over candidate layers."""
    z = 0
    while (z + 1) * (z + 2) * (z + 3) // 6 <= lam:
        z += 1
    x, y = map_tri2d(lam - z * (z + 1) * (z + 2) // 6)
    return x, y, z
