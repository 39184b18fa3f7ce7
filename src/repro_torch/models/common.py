"""Parameter helpers and the small layers every model shares.

Weights keep the reference's layouts: a projection is (in, *out), applied as
``x @ w`` over the flattened out dims.  Inits draw from an explicit
``torch.Generator``; they give the reference's distributions, not
``jax.random``'s numbers.  The logical-axis names and ``prepend_layers_axis``
are sharding plumbing and wait for the training slice.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def frozen_param(t: torch.Tensor) -> nn.Parameter:
    """A weight that asks for no gradient until a caller says so."""
    return nn.Parameter(t, requires_grad=False)


class SwiGLU(nn.Module):
    """gate / up (d, d_ff), down (d_ff, d)."""

    def __init__(self, gate, up, down):
        super().__init__()
        self.gate, self.up, self.down = (frozen_param(w)
                                         for w in (gate, up, down))


def dense_init(generator: torch.Generator, in_dim: int, out_dims,
               dtype: torch.dtype, scale: float | None = None,
               device=None) -> torch.Tensor:
    """Truncated-normal init for an (in, *out) projection, fan-in scaled."""
    out_dims = (out_dims,) if isinstance(out_dims, int) else tuple(out_dims)
    if scale is None:
        scale = 1.0 / math.sqrt(in_dim)
    w = torch.empty((in_dim, *out_dims), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w.mul_(scale)).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype, device=None) -> torch.Tensor:
    w = torch.empty((vocab, d), dtype=torch.float32, device=device)
    w.normal_(0.0, 1.0, generator=generator)
    return w.mul_(0.02).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with fp32 statistics, then the affine in x's dtype."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * weight + bias


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor) -> torch.Tensor:
    """Whisper's MLP: down( gelu(x@up) ), with the tanh GELU that
    ``jax.nn.gelu`` computes by default (torch's default is the erf form)."""
    return F.gelu(x @ w_up, approximate="tanh") @ w_down


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: down( silu(x@gate) * (x@up) )."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding over the last dim of (..., seq, n_heads, head_dim)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., :, None, :]   # broadcast over heads
    sin = torch.sin(angles)[..., :, None, :]
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def count_params(params) -> int:
    """Elements in a module's parameters (or an iterable of tensors)."""
    tensors = params.parameters() if hasattr(params, "parameters") else params
    return int(sum(t.numel() for t in tensors))
