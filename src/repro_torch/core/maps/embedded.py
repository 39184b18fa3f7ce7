"""Embedded-2D-fractal family plugin (related work: efficient GPU thread
mapping on embedded self-similar fractals).

Each family member is a digit-decomposition fractal with an origin-anchored
generator inside a ``scale x scale`` cell grid, so the generic digit engine
in :mod:`repro_torch.core.maps.fractal` covers every tier — registration is one
``register_fractal_domain`` call per member.  The in-kernel pallas and
membership tiers register generically from
``kernels/domain_map/geometry.py``.
"""
from __future__ import annotations

import functools

from repro_torch.core.domains import EMBEDDED_FRACTAL_DOMAINS
from repro_torch.core.maps.fractal import map_fractal, register_fractal_domain

for _d in EMBEDDED_FRACTAL_DOMAINS:
    register_fractal_domain(_d, complexity_class="O(log N)")

# backward-compatible named scalar maps
map_cantor2d = functools.partial(
    map_fractal, next(d for d in EMBEDDED_FRACTAL_DOMAINS
                      if d.name == "cantor2d"))
map_vicsek2d = functools.partial(
    map_fractal, next(d for d in EMBEDDED_FRACTAL_DOMAINS
                      if d.name == "vicsek2d"))
