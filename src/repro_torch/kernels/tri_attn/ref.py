"""Plain torch oracle for causal (lower-triangular domain) attention."""
from __future__ import annotations

import torch


def causal_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float | None = None) -> torch.Tensor:
    """Reference causal attention.

    q, k, v: (batch, heads, seq, head_dim); returns the same shape as q.
    Computation in float32 regardless of input dtype (the kernel does the
    same)."""
    *_, seq, head_dim = q.shape
    if scale is None:
        scale = head_dim ** -0.5
    qf = q.to(torch.float32) * scale
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, k.to(torch.float32))
    mask = torch.tril(torch.ones((seq, seq), dtype=torch.bool,
                                 device=q.device))
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.to(torch.float32))
    return out.to(q.dtype)
