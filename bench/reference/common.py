"""What the plain references share: fp32 arithmetic with TF32 off, the
product of two operands (optionally rounded to fp8 first, the control), the
RMS norm, rotary embedding, the causal-LM loss and AdamW.

Plain PyTorch only: nothing here imports the program under test.
"""
from __future__ import annotations

import contextlib
import math

import torch

#: largest finite float8_e4m3fn value
_E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_fp32():
    """fp32 products as fp32 (no TF32) for the block, restored after."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd
        torch.set_float32_matmul_precision(prec)


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one absmax scale for the tensor,
    returned in fp32 (the control's precision).  The rounding passes the
    gradient straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / _E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x.detach())


class Precision:
    """How the reference multiplies: fp32, or with both operands rounded to
    fp8 first (``"float8"``, the control)."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "float8"):
            raise ValueError(f"precision {name!r}")
        self.name = name

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return to_fp8(x) if self.name == "float8" else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of (B, S, heads, D) at positions 0..S-1, the two
    halves of D rotated as pairs (i, i + D/2)."""
    s, d = x.shape[1], x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            z_loss_coef: float) -> torch.Tensor:
    """Mean next-token cross entropy plus ``z_loss_coef`` times the mean
    squared log-partition, over every position."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (lse - picked).mean() + z_loss_coef * (lse * lse).mean()


def lr_at(opt: dict, step: int) -> float:
    """Linear warm-up to ``lr`` over ``warmup_steps``, then a cosine to
    ``lr · min_lr_ratio`` at ``total_steps``."""
    lr, warm = opt["lr"], opt["warmup_steps"]
    if step < warm:
        return lr * min((step + 1) / max(warm, 1), 1.0)
    prog = min(max((step - warm) / max(opt["total_steps"] - warm, 1), 0.0),
               1.0)
    r = opt["min_lr_ratio"]
    return lr * (r + (1 - r) * 0.5 * (1 + math.cos(math.pi * prog)))


@torch.no_grad()
def adamw_step(params: dict, grads: dict, m: dict, v: dict, opt: dict,
               step: int, store_dtype: torch.dtype) -> dict:
    """One AdamW step in fp32 on fp32 ``params`` from ``grads`` (clipped
    first by the global norm), moments in ``m`` and ``v``; weight decay on
    leaves of two or more dims, applied to the old value; each new value
    is then held in ``store_dtype``, the parameters' stored type.  Returns
    each leaf's clipped gradient norm."""
    gnorm = math.sqrt(sum(float(torch.sum(g * g)) for g in grads.values()))
    scale = min(1.0, opt["clip_norm"] / (gnorm + 1e-9))
    lr = lr_at(opt, step)
    t = step + 1
    bc1, bc2 = 1 - opt["b1"] ** t, 1 - opt["b2"] ** t
    norms = {}
    for n, p in params.items():
        g = grads[n] * scale
        norms[n] = float(torch.linalg.vector_norm(g))
        m[n].mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
        v[n].mul_(opt["b2"]).addcmul_(g, g, value=1 - opt["b2"])
        del g
        delta = m[n] / (torch.sqrt(v[n] / bc2) + opt["eps"]) * (lr / bc1)
        if p.ndim >= 2 and opt["weight_decay"]:
            p.mul_(1 - lr * opt["weight_decay"])
        p.sub_(delta)
        del delta
        p.copy_(p.to(store_dtype).to(p.dtype))
    return norms
