"""The yardstick's arithmetic: peaks of one H100 and the operations and bytes
of a call or a step, counted from shapes alone.

Frozen here so that a change to the program cannot move it.  The peaks are
the values of ``repro_torch/core/energy.py`` (NVIDIA's H100 SXM data sheet,
dense rates); the kernels' counts follow ``repro_torch/launch/analytic.py``
(``_attn_flops``), counted exactly: causal attention over the lower
triangle with its diagonal, S(S+1)/2 pairs.  A model family's FLOPs live in
``bench/flops/<family>.py``.
"""
from __future__ import annotations

#: dense tensor-core FLOP/s by the dtype of the inputs (fp32 inputs may be
#: multiplied on the tensor cores as TF32)
FLOPS_PEAK = {"bfloat16": 989e12, "float32": 495e12}
#: HBM3 bytes/s
HBM_BYTES_PER_S = 3.35e12
#: bf16 dense peak the step's share (``*_mfu``) is taken against
MFU_PEAK = FLOPS_PEAK["bfloat16"]

ITEMSIZE = {"bfloat16": 2, "float32": 4}


def least_time(flops: float, nbytes: float, dtype: str) -> float:
    """Seconds no implementation can beat: the larger of the work at the
    highest dense rate the inputs may be multiplied at and the bytes read
    and written once at the memory rate."""
    return max(flops / FLOPS_PEAK[dtype], nbytes / HBM_BYTES_PER_S)


# -- kernels ------------------------------------------------------------------


def causal_pairs(s: int) -> int:
    """(query, key) pairs with key <= query: the lower triangle and its
    diagonal."""
    return s * (s + 1) // 2


def tri_attn_forward(b: int, h: int, hk: int, s: int, d: int,
                     dtype: str) -> tuple[float, float]:
    """(FLOPs, bytes) of causal attention of q (b, h, s, d) against k, v
    (b, hk, s, d): Q·Kᵀ and P·V over the causal pairs, 2 FLOPs a
    multiply-add; q, k, v read once and o written once."""
    flops = 2 * 2 * d * causal_pairs(s) * b * h
    it = ITEMSIZE[dtype]
    nbytes = it * s * d * (2 * b * h + 2 * b * hk)
    return float(flops), float(nbytes)


def tri_attn_backward(b: int, h: int, hk: int, s: int, d: int,
                      dtype: str) -> tuple[float, float]:
    """(FLOPs, bytes) of its backward from the forward's probabilities:
    dV = Pᵀ·dO, dP = dO·Vᵀ, dQ = dS·K, dK = dSᵀ·Q over the causal pairs
    (twice the forward; no recompute counted); q, k, v, dO read once, dq,
    dk, dv written once."""
    f, _ = tri_attn_forward(b, h, hk, s, d, dtype)
    it = ITEMSIZE[dtype]
    nbytes = it * s * d * (4 * b * h + 4 * b * hk)
    return 2 * f, float(nbytes)


def wkv_chunked(bh: int, s: int, d: int, chunk: int, in_dtype: str,
                out_dtype: str) -> tuple[float, float]:
    """(FLOPs, bytes) of the chunked RWKV-6 WKV over (bh, s, d): per
    (bh, chunk) the strictly-lower pairs' scores and their P·v,
    2·d·C(C-1), the bonus diagonal, 5·C·d, r·S_in and the state update,
    4·C·d²; r, k, v read once in ``in_dtype``, w (fp32) read once, o
    written once, the fp32 state read and written once, u read once."""
    flops = bh * (s // chunk) * (2 * d * chunk * (chunk - 1)
                                 + 5 * chunk * d + 4 * chunk * d * d)
    nbytes = bh * s * d * (3 * ITEMSIZE[in_dtype] + 4 + ITEMSIZE[out_dtype]) \
        + 2 * bh * d * d * 4 + bh * d * 4
    return float(flops), float(nbytes)
