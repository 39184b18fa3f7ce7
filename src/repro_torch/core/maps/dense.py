"""Ground-truth maps for the dense domains (Table I rows 1-2).

Three tiers per domain — scalar (exact python int), numpy (vectorized exact
int64 for the 10^6-point validation) and torch (exact int64 tensors) —
plus the exact inverse, all registered into the MapRegistry under the
``analytical`` logic class.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import inverse as inv
from repro_torch.core.registry import register_map

# ---------------------------------------------------------------------------
# 2D triangular
# ---------------------------------------------------------------------------


def map_tri2d(lam: int) -> tuple[int, int]:
    """x = floor(sqrt(1/4 + 2*lam) - 1/2), y = lam - x(x+1)/2  (Table I)."""
    x = inv.tri_row(lam)
    return x, lam - inv.tri(x)


def unmap_tri2d(x: int, y: int) -> int:
    return inv.tri(x) + y


def np_map_tri2d(lams: np.ndarray) -> np.ndarray:
    lams = np.asarray(lams, dtype=np.int64)
    x = inv.np_tri_row(lams)
    y = lams - x * (x + 1) // 2
    return np.stack([x, y], axis=-1)


def torch_map_tri2d(lams: torch.Tensor, ndigits: int = 13) -> torch.Tensor:
    del ndigits  # dense maps are closed-form; digits are a fractal concept
    lams = lams.to(torch.int64)
    x = inv.torch_tri_row(lams)
    y = lams - x * (x + 1) // 2
    return torch.stack([x, y], dim=-1)


# ---------------------------------------------------------------------------
# 3D pyramid
# ---------------------------------------------------------------------------


def map_pyramid3d(lam: int) -> tuple[int, int, int]:
    """z from tetrahedral-number inversion, then the 2D map on the residual."""
    z = inv.tet_layer(lam)
    x, y = map_tri2d(lam - inv.tet(z))
    return x, y, z


def unmap_pyramid3d(x: int, y: int, z: int) -> int:
    return inv.tet(z) + unmap_tri2d(x, y)


def np_map_pyramid3d(lams: np.ndarray) -> np.ndarray:
    lams = np.asarray(lams, dtype=np.int64)
    z = inv.np_tet_layer(lams)
    rem = lams - z * (z + 1) * (z + 2) // 6
    xy = np_map_tri2d(rem)
    return np.concatenate([xy, z[:, None]], axis=-1)


def torch_map_pyramid3d(lams: torch.Tensor,
                        ndigits: int = 13) -> torch.Tensor:
    del ndigits
    lams = lams.to(torch.int64)
    z = inv.torch_tet_layer(lams)
    rem = lams - z * (z + 1) * (z + 2) // 6
    xy = torch_map_tri2d(rem)
    return torch.cat([xy, z[:, None]], dim=-1)


# ---------------------------------------------------------------------------
# Registration
# ---------------------------------------------------------------------------

register_map("tri2d", "analytical", complexity_class="O(1)", ground_truth=True,
             tiers={"scalar": map_tri2d, "unmap": unmap_tri2d,
                    "numpy": np_map_tri2d, "torch": torch_map_tri2d})
register_map("pyramid3d", "analytical", complexity_class="O(1)",
             ground_truth=True,
             tiers={"scalar": map_pyramid3d, "unmap": unmap_pyramid3d,
                    "numpy": np_map_pyramid3d,
                    "torch": torch_map_pyramid3d})
