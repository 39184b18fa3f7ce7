"""Public wrapper for the chunked WKV kernel.

``wkv_chunked(r, k, v, w, u, state, chunk=64)`` keeps the reference's
contract: r, k, v, w (BH, S, D), u (BH, D), state (BH, D, D) fp32, w the
decay in (0, 1); it returns (o (BH, S, D) in r's dtype, final state fp32).
``out_dtype`` sets o's dtype instead: bf16 r, k, v with fp32 o is what the
RWKV-6 model passes (its projections in place, o unrounded before the
group norm).
It also takes the model's layout, r, k, v, w (B, S, H, D) with u (H, D) and
state (B, H, D, D), read in place, and then returns o (B, S, H, D) and the
state (B, H, D, D).  Gradients go through the plain version
(``torch.autograd.Function``), as the reference's jnp form is
differentiable.

``interpret=False`` launches the CUDA kernels on CUDA tensors and raises on
CPU tensors or without a card; ``interpret=True`` runs their plain
composition (``wkv_chunked_plain``) on CPU tensors.  Nothing falls back from one
to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.wkv.kernel import (
    check_shapes, heads_to_rows, launch_wkv, rows_to_heads, wkv_chunked_plain,
)


def _plain_heads(r, k, v, w, u, state, chunk, out_dtype=None):
    """``wkv_chunked_plain`` on the (B, S, H, D) layout."""
    b, _, h, _ = r.shape
    o, s_out = wkv_chunked_plain(*heads_to_rows(r, k, v, w, u, state), chunk,
                                 out_dtype)
    return rows_to_heads(o, s_out, b, h)


def _forward(r, k, v, w, u, state, chunk, interpret, heads_major,
             out_dtype):
    """(B, S, H, D) in, (o, final state) out: the plain version or the
    kernels."""
    if interpret:
        return _plain_heads(r, k, v, w, u, state, chunk, out_dtype)
    return launch_wkv(r, k, v, w, u, state, chunk, heads_major=heads_major,
                      out_dtype=out_dtype)


class _WKV(torch.autograd.Function):
    """``_forward`` with gradients through the plain version, in each
    input's dtype."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state, chunk, interpret, heads_major,
                out_dtype):
        ctx.save_for_backward(r, k, v, w, u, state)
        ctx.chunk, ctx.out_dtype = chunk, out_dtype
        return _forward(r, k, v, w, u, state, chunk, interpret, heads_major,
                        out_dtype)

    @staticmethod
    def backward(ctx, g_o, g_s):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(t.is_floating_point())
                  for t in saved]
            o, s_out = _plain_heads(*xs, ctx.chunk, ctx.out_dtype)
            outs, grads = [o], [g_o]
            if g_s is not None:
                outs.append(s_out)
                grads.append(g_s)
            got = torch.autograd.grad(outs, xs, grads, allow_unused=True)
        return (*got, None, None, None, None)


def wkv_chunked(r, k, v, w, u, state, chunk: int = 64,
                interpret: bool = False, out_dtype=None):
    """The chunked WKV: (BH, S, D) as the reference, or (B, S, H, D) with u
    (H, D) and state (B, H, D, D).  Returns (o in ``out_dtype``, default r's
    dtype; final state fp32), in the layout of the inputs.  Where no input
    wants a gradient the forward runs without the autograd node, whose host
    time a call is about that of the launch itself."""
    devices = {t.device.type for t in (r, k, v, w, u, state)}
    if interpret and devices != {"cpu"}:
        raise ValueError("interpret=True runs the plain version on CPU "
                         f"tensors; these are on {sorted(devices)}")
    if not interpret and devices != {"cuda"}:
        raise ValueError("the wkv kernel takes CUDA tensors; pass "
                         "interpret=True to run its plain version on the CPU")
    if interpret:   # the kernel's route checks them in launch_plan
        check_shapes(r, k, v, w, u, state, chunk)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (r, k, v, w, u, state))
    fwd = _WKV.apply if grad else _forward
    if r.dim() == 4:
        return fwd(r, k, v, w, u, state, chunk, interpret, False, out_dtype)
    # (BH, S, D) as (1, S, BH, D): u (BH, D) is indexed by "head" bh
    o, s_out = fwd(*(t.transpose(0, 1)[None] for t in (r, k, v, w)), u,
                   state[None], chunk, interpret, True, out_dtype)
    return o[0].transpose(0, 1), s_out[0]
