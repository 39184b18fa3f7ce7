"""Ground-truth maps for the fractal domains: base-B digit decomposition.

One generic digit engine covers every self-similar geometry; a concrete
fractal domain is a *one-call* plugin registration
(:func:`register_fractal_domain`), which is how the four paper fractals below
are wired and how future geometries (e.g. the embedded-2D-fractal family)
plug in.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.domains import DOMAINS, Domain
from repro_torch.core.registry import MapRegistry, register_map

# ---------------------------------------------------------------------------
# Generic digit engine (all tiers)
# ---------------------------------------------------------------------------


def map_fractal(domain: Domain, lam: int) -> tuple[int, ...]:
    """c = sum_i vec(d_i) * scale^i  where  lam = sum_i d_i * B^i."""
    c = [0] * domain.dim
    s = 1
    while lam > 0:
        d = lam % domain.base
        v = domain.vecs[d]
        for k in range(domain.dim):
            c[k] += v[k] * s
        lam //= domain.base
        s *= domain.scale
    return tuple(c)


def unmap_fractal(domain: Domain, c: tuple[int, ...]) -> int:
    """Inverse: coordinates -> lambda (digit recovery per level)."""
    c = list(c)
    lam = 0
    bpow = 1
    vec_to_digit = {tuple(v): d for d, v in enumerate(domain.vecs)}
    while any(c):
        key = tuple(x % domain.scale for x in c)
        lam += vec_to_digit[key] * bpow
        c = [x // domain.scale for x in c]
        bpow *= domain.base
    return lam


def np_map_fractal(domain: Domain, lams: np.ndarray) -> np.ndarray:
    lams = np.asarray(lams, dtype=np.int64)
    ndig = max(domain.level_for_points(int(lams.max()) + 1), 1) if lams.size else 1
    vecs = np.asarray(domain.vecs, dtype=np.int64)  # (B, dim)
    out = np.zeros((len(lams), domain.dim), dtype=np.int64)
    rem = lams.copy()
    s = 1
    for _ in range(ndig):
        d = rem % domain.base
        out += vecs[d] * s
        rem //= domain.base
        s *= domain.scale
    return out


def torch_map_fractal(domain: Domain, lams: torch.Tensor,
                      ndigits: int) -> torch.Tensor:
    """Exactly ``ndigits`` base-B digits (higher ones are dropped), int64."""
    rem = lams.to(torch.int64)
    vecs = torch.tensor(domain.vecs, dtype=torch.int64,
                        device=rem.device)  # (B, dim)
    out = torch.zeros(rem.shape + (domain.dim,), dtype=torch.int64,
                      device=rem.device)
    s = 1
    for _ in range(ndigits):
        d = rem % domain.base
        out += vecs[d] * s
        rem = rem // domain.base
        s *= domain.scale
    return out


# ---------------------------------------------------------------------------
# Plugin registration — one call per geometry
# ---------------------------------------------------------------------------


def register_fractal_domain(
    domain: Domain,
    *,
    logic: str = "bitwise",
    complexity_class: str = "O(log N)",
    registry: MapRegistry | None = None,
):
    """Register all scalar/unmap/numpy/torch tiers for a digit-decomposition
    fractal domain in one call (the plugin path for new geometries)."""
    return register_map(
        domain.name, logic,
        complexity_class=complexity_class, ground_truth=True,
        registry=registry,
        tiers={
            "scalar": functools.partial(map_fractal, domain),
            "unmap": lambda *c, _d=domain: unmap_fractal(_d, c),
            "numpy": functools.partial(np_map_fractal, domain),
            "torch": functools.partial(torch_map_fractal, domain),
        },
    )


for _name in ("gasket2d", "carpet2d", "sierpinski3d", "menger3d"):
    register_fractal_domain(DOMAINS[_name])

# backward-compatible named scalar maps
map_gasket2d = functools.partial(map_fractal, DOMAINS["gasket2d"])
map_carpet2d = functools.partial(map_fractal, DOMAINS["carpet2d"])
map_sierpinski3d = functools.partial(map_fractal, DOMAINS["sierpinski3d"])
map_menger3d = functools.partial(map_fractal, DOMAINS["menger3d"])
