"""Public wrapper for the triangular-domain attention kernel.

``causal_attention(q, k, v)`` takes (batch, heads, seq, head_dim), with
``heads`` a multiple of k's and v's (GQA: each kv head serves its group, read
in place), runs the forward, and differentiates through one autograd node,
``_CausalAttention``.  Its backward, where the forward took the sm90 route
(bf16, block 128, head_dim 64 or 128), is the sm90 backward kernel
(``kernel.launch_attention_backward``) from q, k, v, o and the rows'
log-sum-exp that the forward then also stores; on every other route it is
the plain oracle's vjp, as the reference's ``custom_vjp`` is.  The choice
is made from the inputs' dtype and shape alone.

``interpret=False`` launches the CUDA kernel on CUDA tensors, by the route
``kernel.attention_route`` picks (``"sm90"`` for bf16, block 128, head_dim
64 or 128; ``"simt"`` otherwise), and raises on CPU tensors, without a card
or when a launch fails; ``interpret=True`` runs, on CPU tensors, the plain
version of the route the card would take (``attention_stream_plain`` with
an H100's CTA grid, or ``attention_pairs_plain`` with an H100's strip
length), and for the sm90 route's backward ``attention_backward_plain``.
Nothing falls back from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.tri_attn.kernel import (  # noqa: F401
    MODES, SM90_BLOCK, attention_backward_plain, attention_plain,
    attention_route, launch_attention, launch_attention_backward,
    tri_grid_size,
)
from repro_torch.kernels.tri_attn.ref import causal_attention_ref


def _forward(q, k, v, block_q, block_k, grid_mode, interpret, lse=False):
    if block_q != block_k:
        raise ValueError("the triangular block space needs square blocks")
    if grid_mode not in MODES:
        raise ValueError(f"grid_mode {grid_mode!r}")
    devices = {t.device.type for t in (q, k, v)}
    if interpret:
        if devices != {"cpu"}:
            raise ValueError("interpret=True runs the plain version on CPU "
                             f"tensors; these are on {sorted(devices)}")
        return attention_plain(q, k, v, block_q, grid_mode, lse)
    if devices != {"cuda"}:
        raise ValueError("the tri_attn kernel takes CUDA tensors; pass "
                         "interpret=True to run its plain version on the CPU")
    return launch_attention(q, k, v, block_q, grid_mode, lse)


def _repeat_kv(t, groups):
    return t if groups == 1 else t.repeat_interleave(groups, dim=1)


class _CausalAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, block_q, block_k, grid_mode, interpret):
        ctx.sm90 = (block_q == block_k and attention_route(
            q.dtype, block_q, q.shape[-1]) == "sm90")
        if not ctx.sm90:
            ctx.save_for_backward(q, k, v)
            return _forward(q, k, v, block_q, block_k, grid_mode, interpret)
        o, lse = _forward(q, k, v, block_q, block_k, grid_mode, interpret,
                          lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.grid_mode, ctx.interpret = grid_mode, interpret
        return o

    @staticmethod
    def backward(ctx, g):
        if ctx.sm90:
            q, k, v, o, lse = ctx.saved_tensors
            if ctx.interpret:
                grads = attention_backward_plain(q, k, v, o, lse, g,
                                                 SM90_BLOCK, ctx.grid_mode)
            else:
                grads = launch_attention_backward(q, k, v, o, lse, g,
                                                  ctx.grid_mode)
            return (*grads, None, None, None, None)
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
