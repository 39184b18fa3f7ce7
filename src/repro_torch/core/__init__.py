"""Core library: the domains, their exact thread maps and the registry that
resolves them (the derivation half of ``repro.core`` is not ported yet)."""
from repro_torch.core.domains import DOMAINS, Domain, get_domain  # noqa: F401
from repro_torch.core.maps import (  # noqa: F401
    SCALAR_MAPS, VARIANT_MAPS, np_map, torch_map,
)
from repro_torch.core.registry import (  # noqa: F401
    REGISTRY, MapEntry, MapRegistry, get_registry, register_map,
)
