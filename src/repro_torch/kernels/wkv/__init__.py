from repro_torch.kernels.wkv.ops import wkv_chunked  # noqa: F401
from repro_torch.kernels.wkv.ref import wkv_ref  # noqa: F401
