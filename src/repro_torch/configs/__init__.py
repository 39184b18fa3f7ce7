"""Model configurations: framework-free data, copied from ``repro.configs``
(every field and value kept, so a config round-trips).  In the port,
``attn_impl="xla"`` is the plain torch attention, ``"pallas_mapped"`` /
``"pallas_bb"`` the CUDA ``tri_attn`` kernel in that grid mode, and
``pallas_interpret=True`` the kernel's plain version on the CPU."""
from repro_torch.configs.base import ModelConfig  # noqa: F401
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config  # noqa: F401
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable  # noqa: F401
