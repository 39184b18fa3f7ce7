"""Pure-numpy oracles for the domain-map kernels."""
from __future__ import annotations

import numpy as np

from repro_torch.core.artifact import resolve_domain
from repro_torch.core.domains import get_domain
from repro_torch.core.maps import np_map


def map_coordinates_ref(spec, n_points: int) -> np.ndarray:
    """(N, dim) coordinates of the first N domain points (mapped strategy)."""
    return np_map(resolve_domain(spec), np.arange(n_points, dtype=np.int64))


def bb_membership_ref(spec, extent: tuple[int, ...]) -> np.ndarray:
    """Row-major membership mask over the bounding box (BB strategy)."""
    d = get_domain(resolve_domain(spec))
    lam = np.arange(int(np.prod(extent)), dtype=np.int64)
    coords = np.stack(np.unravel_index(lam, extent), axis=-1)
    return d.contains(coords).astype(np.int32)
