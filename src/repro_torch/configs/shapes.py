"""Assigned input shapes (one set shared by all 10 LM archs): a copy of the
JAX package's ``configs/shapes.py``.

``decode_*`` / ``long_*`` lower ``serve_step`` (one token against a KV cache
of seq_len), NOT ``train_step``.  ``long_500k`` requires sub-quadratic
sequence mixing and only runs for SSM/hybrid archs (8 of the 40 cells are
skipped).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"


TRAIN_4K = ShapeSpec("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def applicable(cfg, shape: ShapeSpec) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) for an (arch, shape) cell."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: long_500k requires sub-quadratic "
                       "sequence mixing (assignment spec; see DESIGN.md)")
    return True, ""
