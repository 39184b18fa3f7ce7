"""Loss and the train / eval steps over ``forward``.

Causal-LM cross entropy (fp32 logsumexp), z-loss and the MoE aux term
(``forward(..., with_aux=True)``: the moe family's summed load-balancing
loss, 0 for the other families).  ``make_train_step`` differentiates it
with autograd, accumulates microbatches (slices of the batch's leading dim)
in fp32 and applies AdamW (``train/optimizer.py``), as the reference's
``make_train_step`` does on one device.  Each layer is recomputed in the
backward by ``cfg.remat_policy`` (``models/transformer.py``).
``grad_compression`` is accepted and changes nothing: the reference declares
it and its step never reads it (ROADMAP queue 3); ``train/sharded.py`` runs
this step over a mesh.  While a torch profiler records, each step opens the
range ``repro_torch.step`` and ``lm_loss`` opens ``repro_torch.loss`` after
``forward`` (``obs/trace.py``'s ``region``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.distribution import tensor_parallel as tp
from repro_torch.models import transformer as T
from repro_torch.models.common import VOCAB, island_dtype
from repro_torch.obs.trace import region
from repro_torch.train import optimizer as opt

@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: opt.OptimizerConfig = dataclasses.field(
        default_factory=opt.OptimizerConfig)
    microbatches: int = 1
    z_loss_coef: float = 1e-4
    moe_aux_coef: float = 1e-2
    grad_compression: bool = False   # int8 cross-pod all-reduce (unread)


def _lse_and_label_logit(logits, labels, vocab: int):
    """The logsumexp over the vocab and the label's logit, (B, S) each.
    With ``vocab`` split over ``model`` (the sharded step) ``logits`` is
    this rank's chunk of the vocab: the max and the sum of exps are
    all-reduced over ``model``, and the label's logit is read on the rank
    that holds it."""
    if not tp.split(VOCAB, vocab):
        return (torch.logsumexp(logits, dim=-1),
                torch.gather(logits, -1, labels[..., None])[..., 0])
    j, _ = tp.model_rank()
    rows = logits.shape[-1]
    mx = tp.model_max(logits.detach().amax(dim=-1))
    lse = mx + torch.log(tp.reduce_out(
        torch.exp(logits - mx[..., None]).sum(dim=-1)))
    local = labels - j * rows
    keep = (local >= 0) & (local < rows)
    picked = torch.gather(logits, -1,
                          torch.where(keep, local, 0)[..., None])[..., 0]
    return lse, tp.reduce_out(torch.where(keep, picked, 0.0))


def lm_loss(params, cfg, batch, z_loss_coef=1e-4, moe_aux_coef=1e-2):
    """Next-token cross entropy; labels = tokens shifted by the data layer.

    Returns (total, {"ce", "z_loss", "moe_aux"}) as 0-d fp32 tensors."""
    logits, aux = T.forward(params, cfg, batch["tokens"], batch.get("extra"),
                            with_aux=True)
    with region("loss"):
        labels = torch.as_tensor(batch["labels"], dtype=torch.int64,
                                 device=logits.device)
        logits = logits.to(island_dtype(logits.dtype))
        lse, picked = _lse_and_label_logit(logits, labels, cfg.padded_vocab)
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones_like(labels, dtype=torch.float32)
        else:
            mask = torch.as_tensor(mask, dtype=torch.float32,
                                   device=logits.device)
        denom = torch.clamp(mask.sum(), min=1.0)
        ce = torch.sum((lse - picked) * mask) / denom
        zl = z_loss_coef * torch.sum(torch.square(lse) * mask) / denom
        total = ce + zl + moe_aux_coef * aux
    return total, {"ce": ce, "z_loss": zl, "moe_aux": aux}


def make_grads_fn(cfg, tcfg: TrainConfig, local=None):
    """Returns grads_of(params, batch) -> (loss, metrics, {name: gradient}).

    The batch's leading dim is split into ``tcfg.microbatches`` slices; their
    gradients are summed in fp32 and averaged.  With one microbatch the
    gradients keep the parameters' dtype, as the reference's do.  ``local``
    maps each microbatch to the rows this process computes (the sharded
    step's data shard); by default all of them."""

    def grads_of(params, batch):
        named = dict(params.named_parameters())
        for p in named.values():
            p.requires_grad_(True)
        n = tcfg.microbatches
        if n <= 1:
            slices = [batch]
        else:
            rows = len(batch["tokens"]) // n
            slices = [{k: None if v is None else v[i * rows:(i + 1) * rows]
                       for k, v in batch.items()} for i in range(n)]
        loss_a, metrics_a, grads_a = None, None, None
        for mb in slices:
            if local is not None:
                mb = local(mb)
            loss, metrics = lm_loss(params, cfg, mb, tcfg.z_loss_coef,
                                    tcfg.moe_aux_coef)
            grads = torch.autograd.grad(loss, list(named.values()))
            loss, metrics = loss.detach(), {k: v.detach()
                                            for k, v in metrics.items()}
            if n <= 1:
                return loss, metrics, dict(zip(named, grads))
            if grads_a is None:
                loss_a, metrics_a = loss, metrics
                grads_a = [g.to(torch.float32) for g in grads]
            else:
                loss_a = loss_a + loss
                metrics_a = {k: metrics_a[k] + metrics[k] for k in metrics}
                torch._foreach_add_(grads_a, list(grads))
            del grads
        inv = 1.0 / n
        torch._foreach_mul_(grads_a, inv)
        return (loss_a * inv, {k: v * inv for k, v in metrics_a.items()},
                dict(zip(named, grads_a)))

    return grads_of


def make_train_step(cfg, tcfg: TrainConfig):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): ``params`` (the model) and ``opt_state`` are updated in place
    and returned; metrics are 0-d fp32 tensors ``loss``, ``ce``, ``z_loss``,
    ``moe_aux``, ``grad_norm`` and ``lr``.  Gradients as ``make_grads_fn``
    gives them."""
    grads_of = make_grads_fn(cfg, tcfg)

    def train_step(params, opt_state, batch):
        with region("step"):
            loss, metrics, grads = grads_of(params, batch)
            om = opt.apply_updates(params, grads, opt_state, tcfg.optimizer)
        return params, opt_state, {"loss": loss, **metrics, **om}

    return train_step


def make_eval_step(cfg, tcfg: TrainConfig):
    def eval_step(params, batch):
        with region("step"):
            loss, metrics = lm_loss(params, cfg, batch, tcfg.z_loss_coef,
                                    tcfg.moe_aux_coef)
        return {"loss": loss, **metrics}
    return eval_step
