"""Public wrapper for the triangular-domain attention kernel.

``causal_attention(q, k, v)`` takes (batch, heads, seq, head_dim), with
``heads`` a multiple of k's and v's (GQA: each kv head serves its group, read
in place), runs the forward, and differentiates through the plain oracle
(``torch.autograd.Function``), as the reference's ``custom_vjp`` does.

``interpret=False`` launches the CUDA kernel on CUDA tensors, by the route
``kernel.attention_route`` picks (``"sm90"`` for bf16, block 128, head_dim
64 or 128; ``"simt"`` otherwise), and raises on CPU tensors, without a card
or when a launch fails; ``interpret=True`` runs, on CPU tensors, the plain
version of the route the card would take (``attention_stream_plain`` with
an H100's CTA grid, or ``attention_pairs_plain`` with an H100's strip
length).  Nothing falls back from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.tri_attn.kernel import (  # noqa: F401
    MODES, attention_plain, launch_attention, tri_grid_size,
)
from repro_torch.kernels.tri_attn.ref import causal_attention_ref


def _forward(q, k, v, block_q, block_k, grid_mode, interpret):
    if block_q != block_k:
        raise ValueError("the triangular block space needs square blocks")
    if grid_mode not in MODES:
        raise ValueError(f"grid_mode {grid_mode!r}")
    devices = {t.device.type for t in (q, k, v)}
    if interpret:
        if devices != {"cpu"}:
            raise ValueError("interpret=True runs the plain version on CPU "
                             f"tensors; these are on {sorted(devices)}")
        return attention_plain(q, k, v, block_q, grid_mode)
    if devices != {"cuda"}:
        raise ValueError("the tri_attn kernel takes CUDA tensors; pass "
                         "interpret=True to run its plain version on the CPU")
    return launch_attention(q, k, v, block_q, grid_mode)


def _repeat_kv(t, groups):
    return t if groups == 1 else t.repeat_interleave(groups, dim=1)


class _CausalAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, block_q, block_k, grid_mode, interpret):
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v, block_q, block_k, grid_mode, interpret)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        groups = q.shape[1] // k.shape[1]
        with torch.enable_grad():
            qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
            out = causal_attention_ref(qq, _repeat_kv(kk, groups),
                                       _repeat_kv(vv, groups))
            dq, dk, dv = torch.autograd.grad(out, (qq, kk, vv), g)
        return dq, dk, dv, None, None, None, None


def causal_attention(q, k, v, block_q: int = 128, block_k: int = 128,
                     grid_mode: str = "mapped", interpret: bool = False):
    """Causal attention over the lower-triangular block domain.

    grid_mode: "mapped" (linear λ grid, the paper's technique) or
    "bounding_box" (square grid + discard, the paper's baseline).  Where no
    gradient is wanted the forward runs without the autograd node, whose
    host time per call is about that of the launch itself."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _CausalAttention.apply(q, k, v, block_q, block_k, grid_mode,
                                      interpret)
    return _forward(q, k, v, block_q, block_k, grid_mode, interpret)


def grid_steps(seq: int, block: int, grid_mode: str) -> int:
    """Pair blocks launched per (batch·head) — the waste accounting."""
    nb = seq // block
    return tri_grid_size(nb) if grid_mode == "mapped" else nb * nb
