from repro_torch.kernels.tri_attn.ops import causal_attention, tri_grid_size  # noqa: F401
from repro_torch.kernels.tri_attn.ref import causal_attention_ref  # noqa: F401
