"""Ground-truth mapping functions lambda -> coordinates (Table I).

Facade over the per-tier modules — ``dense`` (closed-form Table-I maps),
``fractal`` (base-B digit engine + per-geometry plugins), ``variants``
(the Tables VIII/IX logic classes), ``simplex`` (the m-simplex family) and
``embedded`` (the embedded-2D-fractal family).  Importing this package
registers every built-in map into the :mod:`repro_torch.core.registry`; the
dispatch helpers below (``np_map``/``torch_map``) and the compatibility dicts
(``SCALAR_MAPS``/``VARIANT_MAPS``) all resolve through that registry, so
``VARIANT_MAPS`` holds the ground-truth entries and the variant logic
classes under the same ``(domain, logic)`` keys as the JAX package's.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.core.maps.dense import (  # noqa: F401
    map_pyramid3d, map_tri2d, np_map_pyramid3d, np_map_tri2d,
    torch_map_pyramid3d, torch_map_tri2d, unmap_pyramid3d, unmap_tri2d,
)
from repro_torch.core.maps.embedded import (  # noqa: F401
    map_cantor2d, map_vicsek2d,
)
from repro_torch.core.maps.fractal import (  # noqa: F401
    map_carpet2d, map_fractal, map_gasket2d, map_menger3d, map_sierpinski3d,
    np_map_fractal, register_fractal_domain, torch_map_fractal,
    unmap_fractal,
)
from repro_torch.core.maps.simplex import (  # noqa: F401
    map_msimplex, np_map_msimplex, register_simplex_domain,
    torch_map_msimplex, unmap_msimplex,
)
from repro_torch.core.maps.variants import (  # noqa: F401
    map_pyramid3d_binsearch, map_pyramid3d_cbrt_loop, map_pyramid3d_linear,
    map_tri2d_approx_if, map_tri2d_binsearch, map_tri2d_sqrt_loop,
)
from repro_torch.core.registry import REGISTRY

# ---------------------------------------------------------------------------
# Registry-driven dispatch
# ---------------------------------------------------------------------------


def np_map(domain_name: str, lams: np.ndarray) -> np.ndarray:
    """Vectorized exact int64 ground-truth map for any registered domain."""
    return REGISTRY.tier(domain_name, None, "numpy")(lams)


def torch_map(domain_name: str, lams: torch.Tensor,
              ndigits: int = 13) -> torch.Tensor:
    """Exact int64 tensor ground-truth map for any registered domain."""
    return REGISTRY.tier(domain_name, None, "torch")(lams, ndigits)


def scalar_map(domain_name: str, logic: str | None = None):
    """Exact scalar map for (domain, logic); logic=None -> ground truth."""
    return REGISTRY.tier(domain_name, logic, "scalar")


def unmap(domain_name: str, logic: str | None = None):
    """Exact inverse coords -> lambda for a registered domain."""
    return REGISTRY.tier(domain_name, logic, "unmap")


# ---------------------------------------------------------------------------
# Backward-compatible views of the registry
# ---------------------------------------------------------------------------

class _RegistryView(Mapping):
    """Live read-only dict view over the registry's scalar tiers — maps
    registered after import (plugins, derived artifacts) appear too."""

    def __init__(self, build):
        self._build = build

    def __getitem__(self, key):
        return self._build()[key]

    def __iter__(self):
        return iter(self._build())

    def __len__(self):
        return len(self._build())


#: domain -> ground-truth scalar callable.
SCALAR_MAPS = _RegistryView(lambda: {
    entry.domain: entry.scalar
    for entry in REGISTRY.snapshot().values()
    if entry.ground_truth and "scalar" in entry.tiers
})

#: (domain, logic-class) -> scalar callable; "analytical" is the paper map.
VARIANT_MAPS = _RegistryView(lambda: {
    key: entry.tiers["scalar"]
    for key, entry in sorted(REGISTRY.snapshot().items())
    if "scalar" in entry.tiers
})
