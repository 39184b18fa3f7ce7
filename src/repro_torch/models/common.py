"""Parameter helpers and the small layers every model shares.

Weights keep the reference's layouts: a projection is (in, *out), applied as
``x @ w`` over the flattened out dims.  Inits draw from an explicit
``torch.Generator``; they give the reference's distributions, not
``jax.random``'s numbers.

Logical-axis spec trees (the reference's ``models/common.py``): nested dicts
mirroring the reference's parameter trees, each leaf a tuple of logical axis
names per dim, which ``distribution/sharding.py`` resolves onto mesh axes.
``jax_path`` names the reference leaf (and the slice of its stacked axes)
that one port parameter is.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distribution import tensor_parallel as tp

# Logical axis names (mapped to mesh axes by distribution/sharding.py)
BATCH = "batch"
SEQ = "seq"
EMBED = "embed"          # d_model — FSDP-sharded on weights
FFN = "ffn"              # hidden ffn dim — TP-sharded
HEADS = "heads"          # q heads — TP-sharded
KV_HEADS = "kv_heads"    # kv heads — replicated when < TP degree
HEAD_DIM = "head_dim"
VOCAB = "vocab"          # TP-sharded
EXPERTS = "experts"      # EP-sharded
LAYERS = "layers"        # scan axis — never sharded
STATE = "state"          # ssm state dim
CAP = "capacity"


def frozen_param(t: torch.Tensor) -> nn.Parameter:
    """A weight that asks for no gradient until a caller says so."""
    return nn.Parameter(t, requires_grad=False)


class SwiGLU(nn.Module):
    """gate / up (d, d_ff), down (d_ff, d)."""

    def __init__(self, gate, up, down):
        super().__init__()
        self.gate, self.up, self.down = (frozen_param(w)
                                         for w in (gate, up, down))


def mlp_specs():
    return {"gate": (EMBED, FFN), "up": (EMBED, FFN), "down": (FFN, EMBED)}


def prepend_layers_axis(spec_tree):
    """Add the scan ``layers`` axis in front of every leaf spec."""
    if isinstance(spec_tree, tuple):
        return (LAYERS, *spec_tree)
    return {k: prepend_layers_axis(v) for k, v in spec_tree.items()}


def jax_path(name: str) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """A port parameter name -> (the reference leaf's key path, the index of
    this parameter's slice along its stacked axes).  ``layers.3.attn.wq`` ->
    (``layers/attn/wq``, (3,)); ``groups.1.self_layers.2.ln1`` ->
    (``groups/self/ln1``, (1, 2)); ``shared.attn.wq`` -> (``shared/attn/wq``,
    ())."""
    keys, ix = [], []
    for part in name.split("."):
        if part.isdigit():
            ix.append(int(part))
        else:
            keys.append("self" if part == "self_layers" else part)
    return tuple(keys), tuple(ix)


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


def island_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of an fp32 island (norm statistics, rope, softmax, logits,
    loss): fp32, or float64 in a float64 model (``dtype="float64"``, for
    numerics checks on the CPU)."""
    return torch.promote_types(dtype, torch.float32)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(island_dtype(x.dtype))
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with fp32 statistics, then the affine in x's dtype."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * weight + bias


def _ffn_split(w_in: torch.Tensor) -> bool:
    return tp.split(FFN, tp.full_size(w_in, 1))


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor) -> torch.Tensor:
    """Whisper's MLP: down( gelu(x@up) ), with the tanh GELU that
    ``jax.nn.gelu`` computes by default (torch's default is the erf form).
    With ``ffn`` split over ``model``: up column-parallel, down
    row-parallel, one all-reduce."""
    if _ffn_split(w_up):
        x = tp.copy_in(x)
        out = F.gelu(x @ tp.take(w_up, 1), approximate="tanh") \
            @ tp.take(w_down, 0)
        return tp.reduce_out(out)
    return F.gelu(x @ tp.take(w_up), approximate="tanh") @ tp.take(w_down)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: down( silu(x@gate) * (x@up) ).  With ``ffn`` split over
    ``model`` (the sharded step): gate and up column-parallel on this
    rank's columns, down row-parallel on its rows, one all-reduce."""
    if _ffn_split(w_gate):
        x = tp.copy_in(x)
        out = (F.silu(x @ tp.take(w_gate, 1)) * (x @ tp.take(w_up, 1))) \
            @ tp.take(w_down, 0)
        return tp.reduce_out(out)
    w_gate, w_up, w_down = (tp.take(w) for w in (w_gate, w_up, w_down))
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding over the last dim of (..., seq, n_heads, head_dim)."""
    half = x.shape[-1] // 2
    dt = island_dtype(x.dtype)
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., :, None, :]   # broadcast over heads
    sin = torch.sin(angles)[..., :, None, :]
    xf1 = x[..., :half].to(dt)
    xf2 = x[..., half:].to(dt)
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def count_params(params) -> int:
    """Elements in a module's parameters (or an iterable of tensors)."""
    tensors = params.parameters() if hasattr(params, "parameters") else params
    return int(sum(t.numel() for t in tensors))
