"""Loss and the eval step over ``forward`` — the scoring entry point.

Causal-LM cross entropy (fp32 logsumexp), z-loss and the MoE aux term (0
for dense).  The optimizer, ``make_train_step``, microbatching and gradient
compression wait for the training slice (ROADMAP queue 1 item 9).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import transformer as T


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    z_loss_coef: float = 1e-4
    moe_aux_coef: float = 1e-2


def lm_loss(params, cfg, batch, z_loss_coef=1e-4, moe_aux_coef=1e-2):
    """Next-token cross entropy; labels = tokens shifted by the data layer.

    Returns (total, {"ce", "z_loss", "moe_aux"}) as 0-d fp32 tensors."""
    logits, aux = T.forward(params, cfg, batch["tokens"], batch.get("extra"),
                            with_aux=True)
    labels = torch.as_tensor(batch["labels"], dtype=torch.int64,
                             device=logits.device)
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None])[..., 0]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(labels, dtype=torch.float32)
    else:
        mask = torch.as_tensor(mask, dtype=torch.float32, device=logits.device)
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = torch.sum((lse - picked) * mask) / denom
    zl = z_loss_coef * torch.sum(torch.square(lse) * mask) / denom
    total = ce + zl + moe_aux_coef * aux
    return total, {"ce": ce, "z_loss": zl, "moe_aux": aux}


def make_eval_step(cfg, tcfg: TrainConfig):
    def eval_step(params, batch):
        loss, metrics = lm_loss(params, cfg, batch, tcfg.z_loss_coef,
                                tcfg.moe_aux_coef)
        return {"loss": loss, **metrics}
    return eval_step
