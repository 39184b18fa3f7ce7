"""m-simplex family plugin (m=2..5) — registry tiers over ``core/msimplex``.

The math lives in :mod:`repro_torch.core.msimplex` (scalar peel + the vectorized
float-seed/exact-ladder layer inversion); this module is the one-file
registration that makes each family member a first-class domain: scalar,
unmap, numpy and torch tiers under the ``analytical`` logic class (the
generalized sqrt/cbrt of Table I is O(1) per level).  The in-kernel pallas
and membership tiers register from ``kernels/domain_map/geometry.py``.
"""
from __future__ import annotations

import torch

from repro_torch.core import msimplex as ms
from repro_torch.core.domains import MSIMPLEX_MS
from repro_torch.core.registry import MapRegistry, register_map


def torch_map_msimplex(lams: torch.Tensor, m: int,
                       ndigits: int = 13) -> torch.Tensor:
    """Exact int64 tensor map (digits are a fractal concept)."""
    del ndigits
    return ms.torch_map_msimplex(lams, m)


def register_simplex_domain(m: int, *, registry: MapRegistry | None = None):
    """Register all scalar/unmap/numpy/torch tiers for the m-simplex in one
    call (the plugin path for new family members)."""
    return register_map(
        f"msimplex{m}", "analytical",
        complexity_class="O(1)", ground_truth=True, registry=registry,
        tiers={
            "scalar": lambda lam, _m=m: ms.map_msimplex(lam, _m),
            "unmap": lambda *c: ms.unmap_msimplex(c),
            "numpy": lambda lams, _m=m: ms.np_map_msimplex(lams, _m),
            "torch": lambda lams, ndigits=13, _m=m: torch_map_msimplex(
                lams, _m, ndigits),
        },
    )


for _m in MSIMPLEX_MS:
    register_simplex_domain(_m)

# backward-compatible named scalar maps
map_msimplex = ms.map_msimplex
unmap_msimplex = ms.unmap_msimplex
np_map_msimplex = ms.np_map_msimplex
