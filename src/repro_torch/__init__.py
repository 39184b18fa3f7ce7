"""PyTorch and CUDA port of the thread-mapping system (``repro``), for an
NVIDIA H100.  It mirrors ``repro``'s module paths, imports neither JAX nor
``repro``, and grows slice by slice: the map-evaluation path (the domain
registry, the two domain-map CUDA kernels, their launch wrappers and
launcher cache, the batched ``EvaluationService``), the derive path
(prompts, the mock replay bank, synthesis, validation, the pipeline, the
tiered artifact store, ``MappingArtifact``, ``obs``), and the dense and
RWKV-6 language-model paths with their CUDA kernels."""
