from repro_torch.kernels.domain_map.ops import (  # noqa: F401
    bb_membership, block_counts, map_coordinates,
)
from repro_torch.kernels.domain_map.ref import (  # noqa: F401
    bb_membership_ref, map_coordinates_ref,
)
