"""Core library: the paper's contribution — automated derivation and
deployment of exact thread-mapping functions for non-box domains."""
from repro_torch.core.artifact import (  # noqa: F401
    ArtifactCache, MappingArtifact, cache_key, default_cache,
)
from repro_torch.core.store import (  # noqa: F401
    ArtifactStore, DiskStore, MemoryStore, PeerStore, TieredStore,
    build_store, default_store,
)
from repro_torch.core.domains import DOMAINS, Domain, get_domain  # noqa: F401
from repro_torch.core.maps import (  # noqa: F401
    SCALAR_MAPS, VARIANT_MAPS, np_map, torch_map,
)
from repro_torch.core.pipeline import (  # noqa: F401
    DerivationResult, derive_mapping, run_grid,
)
from repro_torch.core.registry import (  # noqa: F401
    REGISTRY, MapEntry, MapRegistry, get_registry, register_map,
)
from repro_torch.core.validate import ValidationReport  # noqa: F401
