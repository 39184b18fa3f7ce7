"""AdamW with fp32 moments, global-norm clipping and a cosine schedule.

The reference's hand-rolled AdamW (``repro/train/optimizer.py``) on a
model's parameters.  There is no fp32 master copy: each update is computed in
fp32 and cast back to the parameter's dtype.  Decoupled weight decay applies
to matrices only, as the reference's comment says: each layer's own tensors
with two or more dims.  (The reference tests ``ndim >= 2`` on leaves stacked
over a leading layer axis, so it also decays the per-layer norm scales; this
package does not.)

State: ``{"step": 0-d int32, "m": {name: fp32}, "v": {name: fp32}}``, keyed
by the model's parameter names; ``state_specs`` gives its logical axes (the
parameters').  ``apply_updates`` updates the parameters and the state in
place with in-place ``torch._foreach_*`` ops over groups of tensors of at
most ``_GROUP_BYTES``: the fp32 temporaries (the scaled gradient, the
denominator, the step) stay bounded.  ``update_`` is its elementwise part
given the clipping norm, which the sharded step runs on each rank's shards.
"""
from __future__ import annotations

import dataclasses
import math

import torch

#: fp32 bytes of parameters updated per foreach group
_GROUP_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def lr_at(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warmup to ``lr``, then cosine to ``lr · min_lr_ratio``; fp32,
    on ``step``'s device (a 0-d tensor or an int)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * torch.clamp((step + 1) / max(cfg.warmup_steps, 1),
                                max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def init_state(model) -> dict:
    """fp32 zero moments for every parameter of ``model``."""
    named = dict(model.named_parameters())
    device = next(iter(named.values())).device

    def zeros():
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in named.items()}

    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "m": zeros(), "v": zeros()}


def state_specs(param_spec_tree):
    """Logical-axis specs for the optimizer state (same sharding as params)."""
    return {
        "step": (),
        "m": param_spec_tree,
        "v": param_spec_tree,
    }


def decays(p: torch.Tensor) -> bool:
    """Whether AdamW decays this parameter: a matrix (two or more dims)."""
    return p.ndim >= 2


def norms(tensors: list) -> list:
    """Each tensor's 2-norm as a 0-d fp32 tensor, taken in fp32 (in
    float64 for float64 tensors, then rounded)."""
    if tensors and tensors[0].dtype == torch.float64:
        return [n.to(torch.float32) for n in torch._foreach_norm(tensors, 2)]
    return torch._foreach_norm(tensors, 2, dtype=torch.float32)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor, in fp32."""
    grads = list(grads.values()) if isinstance(grads, dict) else list(grads)
    return torch.linalg.vector_norm(torch.stack(norms(grads)))


def _groups(names: list, named: dict):
    group, size = [], 0
    for n in names:
        group.append(n)
        size += named[n].numel() * 4
        if size >= _GROUP_BYTES:
            yield group
            group, size = [], 0
    if group:
        yield group


@torch.no_grad()
def apply_updates(model, grads: dict, state: dict, cfg: OptimizerConfig
                  ) -> dict:
    """One AdamW step on ``model``'s parameters from ``grads`` (name ->
    gradient, in any float dtype), in place; ``state`` advances in place.
    Returns ``{"grad_norm", "lr"}`` as 0-d fp32 tensors (no host sync)."""
    return update_(dict(model.named_parameters()), grads, state, cfg,
                   global_norm(grads))


@torch.no_grad()
def update_(named: dict, grads: dict, state: dict, cfg: OptimizerConfig,
            gnorm: torch.Tensor) -> dict:
    """``apply_updates`` on the tensors of ``named`` (name -> parameter),
    clipped by ``gnorm``: elementwise, so a shard of every tensor (with the
    same shard of its gradient and moments) takes its part of the step."""
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, state["step"])
    state["step"] += 1
    step = state["step"].to(torch.float32)
    bc1 = 1 - cfg.b1 ** step
    bc2 = 1 - cfg.b2 ** step
    for group in _groups(list(named), named):
        g = [grads[n].to(torch.float32, copy=True) for n in group]
        torch._foreach_mul_(g, scale)
        m = [state["m"][n] for n in group]
        v = [state["v"][n] for n in group]
        torch._foreach_lerp_(m, g, 1 - cfg.b1)
        torch._foreach_mul_(v, cfg.b2)
        torch._foreach_addcmul_(v, g, g, value=1 - cfg.b2)
        del g
        denom = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.eps)
        delta = torch._foreach_div(m, denom)
        del denom
        torch._foreach_mul_(delta, lr / bc1)
        p32 = [named[n].to(torch.float32) for n in group]
        decayed = [p32[i] for i, n in enumerate(group) if decays(named[n])]
        if decayed and cfg.weight_decay:
            torch._foreach_mul_(decayed, 1 - lr * cfg.weight_decay)
        torch._foreach_sub_(p32, delta)
        del delta
        for n, new in zip(group, p32):
            if new is not named[n]:
                named[n].copy_(new)
    return {"grad_norm": gnorm, "lr": lr}
