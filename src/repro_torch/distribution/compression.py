"""Gradient compression for cross-pod data parallelism.

int8 block-quantized all-reduce: each gradient tensor is chunked, quantized
to int8 against a per-chunk absmax scale, summed across the group in int32,
and dequantized.  On a real fabric this cuts the DCN/cross-pod all-reduce
bytes 4x (bf16 -> int8 payload + fp32 scales/chunk); semantics (bounded
quantization error, exact zero preservation) are validated in tests.

The reference runs it under ``shard_map`` over a mesh axis; here it runs on
each rank of a ``torch.distributed`` process group, with the gradient tree
the usual DP layout before the all-reduce: one whole copy per rank.  The
collectives are the reference's: an fp32 MAX of the scales, an int32 sum of
the quantized values.  Nothing in the train step calls it: the reference's
``TrainConfig.grad_compression`` is never read either (ROADMAP queue 3).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

CHUNK = 256
#: the reference's ``/ 127.0`` as XLA compiles it, a multiply by the
#: reciprocal: the scales are bit-equal to the jitted reference's
_INV_127 = 1.0 / 127.0


def _chunks(x: torch.Tensor) -> torch.Tensor:
    """x -> fp32 (n_chunks, CHUNK), zero-padded at the end."""
    flat = x.to(torch.float32).reshape(-1)
    pad = (-flat.numel()) % CHUNK
    return torch.nn.functional.pad(flat, (0, pad)).reshape(-1, CHUNK)


def _quantize(x: torch.Tensor):
    """x fp -> (int8 values, fp32 scales) with per-chunk absmax scaling."""
    chunks = _chunks(x)
    scale = chunks.abs().amax(dim=1, keepdim=True) * _INV_127
    # torch.round rounds half to even, as jnp.round does
    q = torch.round(chunks / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return q, scale


def _dequantize(q, scale, shape, dtype):
    flat = (q.to(torch.float32) * scale).reshape(-1)
    size = 1
    for s in shape:
        size *= s
    return flat[:size].reshape(shape).to(dtype)


def compressed_psum_mean_leaf(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean-all-reduce one tensor over ``group`` via int8 quantization.

    A shared per-chunk scale (the MAX of every rank's absmax / 127) makes the
    quantized sum exact up to the int8 rounding of each replica:
        result = sum(round(x / s)) * s / n.
    """
    chunks = _chunks(x)
    scale = chunks.abs().amax(dim=1, keepdim=True) * _INV_127
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)  # shared scale
    q = torch.round(chunks / torch.clamp(scale, min=1e-12)).to(torch.int8)
    qsum = q.to(torch.int32)
    dist.all_reduce(qsum, group=group)                         # wide sum
    return _dequantize(qsum, scale / dist.get_world_size(group), x.shape,
                       x.dtype)


def compressed_psum_mean(tree, group=None):
    """``compressed_psum_mean_leaf`` over every tensor of a nested dict (or
    on one tensor)."""
    if isinstance(tree, dict):
        return {k: compressed_psum_mean(v, group) for k, v in tree.items()}
    return compressed_psum_mean_leaf(tree, group)


def quantization_error_bound(x) -> float:
    """Worst-case per-element absolute error of one quantize/dequantize."""
    q, scale = _quantize(x)
    return float(scale.max()) * 0.5
