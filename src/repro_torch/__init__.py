"""PyTorch and CUDA port of the thread-mapping system (``repro``), for an
NVIDIA H100.  It mirrors ``repro``'s module paths, imports neither JAX nor
``repro``, and grows slice by slice; this slice is the map-evaluation path:
the domain registry, the two domain-map CUDA kernels, their launch
wrappers and launcher cache, and the batched ``EvaluationService``."""
