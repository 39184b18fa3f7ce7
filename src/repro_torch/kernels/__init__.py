"""Hand-written CUDA kernels for Hopper, each beside its plain torch
version: ``domain_map`` (mapped-grid map evaluation and the bounding-box
membership baseline)."""
