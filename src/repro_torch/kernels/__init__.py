"""Hand-written CUDA kernels for Hopper, each beside its plain torch
version: ``domain_map`` (mapped-grid map evaluation and the bounding-box
membership baseline), ``tri_attn`` (causal attention over the triangular
block domain) and ``wkv`` (the chunked RWKV-6 WKV)."""
