"""Sharded training over a ``DeviceMesh`` with the reference's axes
(``("data", "model")``, or ``("pod", "data", "model")``): the reference's
``make_train_step`` under ``use_sharding`` (``launch/train.py:27-42``).

Storage.  ``shard_`` lays every parameter of the model, and the AdamW
moments ``m`` and ``v``, out as DTensors with the placements of
``param_sharding(param_axes)`` and ``state_specs`` (``layout``): each rank
holds only its shard between steps.  ``step`` stays a plain 0-d tensor that
every rank holds.

Compute.  A step gathers the whole model (``full_tensor()``), runs the
single-device forward and backward (``train_step.make_grads_fn``, the
kernels included) on this rank's rows of each microbatch, averages the
gradients over the data axes, takes this rank's shard of each, clips them by
the global norm (each element counted once: a shard replicated over some
mesh dims counts on the rank at coordinate 0 of each) and updates the shards
in place.  The rows: each microbatch is cut from the global batch as the
single-device step cuts it, then split over the data axes present as
``ACT_RULES["batch"]`` says; ranks along ``model`` take the same rows.
``lm_loss`` normalises by the mask's sum over the rows it sees.  With no
mask and equal rows on every rank, the mean of the ranks' means is the
batch's mean, so the averaged gradients and metrics are the single-device
step's; a masked batch is refused.

Compute along ``model`` is replicated: every rank of a model group runs the
same forward and backward on the same rows, where the reference's GSPMD
splits heads, ffn, vocab and experts into real split products (ROADMAP
queue 1 item 9c).  Only ``moe_impl="a2a"`` splits work over ``model``
(``models/moe.py``).  Every activation is a plain rank-local tensor, so
``logical_constraint`` leaves it as it is.  The gradient's mean over data
is an all-reduce of each whole gradient, then a slice.

Memory.  The shards save memory between steps only.  Within a step each
rank holds the whole weights gathered, the whole gradients and its shards,
so its peak is the single-device step's plus one gathered copy of the
weights; the global and grouped MoE dispatch also route every data rank's
tokens on every rank (``models/moe.py``).  A model whose whole weights and
gradients do not fit one card (deepseek-v2-236b on ``--production-mesh``)
cannot train here until the gather is per layer and the gradient mean a
reduce-scatter (ROADMAP queue 1 item 9c).
"""
from __future__ import annotations

import contextlib
import functools
import math

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Shard

from repro_torch.distribution import sharding as shd
from repro_torch.models import transformer as T
from repro_torch.models.moe import DATA_AXES
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import TrainConfig, make_grads_fn


def layout(params, cfg, mesh) -> dict:
    """``{"params": {name: NamedSharding}, "opt_state": {"step", "m":
    {name: ...}, "v": {name: ...}}}`` for a model on ``mesh``: the
    reference's ``param_sharding`` of ``param_specs`` and ``state_specs``,
    per port parameter name."""
    axes = T.param_axes(params, cfg)
    shapes = {n: tuple(p.shape) for n, p in params.named_parameters()}
    return {
        "params": shd.param_sharding(axes, shapes, mesh, shd.PARAM_RULES),
        "opt_state": shd.param_sharding(
            opt.state_specs(axes), {"step": (), "m": shapes, "v": shapes},
            mesh, shd.PARAM_RULES),
    }


def shard_(params, cfg, mesh):
    """Lay the model's parameters out on ``mesh`` in place, with a new zero
    optimizer state made as shards.  Returns (params, opt_state)."""
    lay = layout(params, cfg, mesh)
    named = dict(params.named_parameters())
    dev = named[next(iter(named))].device
    opt_state = {"step": torch.zeros((), dtype=torch.int32, device=dev),
                 "m": {}, "v": {}}
    for part in ("m", "v"):
        for n, sh in lay["opt_state"][part].items():
            block = torch.zeros(sh.shard_shape(named[n].shape),
                                dtype=torch.float32, device=dev)
            opt_state[part][n] = shd.dtensor(block, sh, named[n].shape)
    for n, sh in lay["params"].items():
        shd.set_param(params, n, shd.distribute(named.pop(n).detach(), sh))
    return params, opt_state


@contextlib.contextmanager
def gathered(model: nn.Module):
    """Within the block the model's DTensor parameters are whole plain
    tensors (one all-gather each); the DTensors are back after it."""
    saved = []
    with torch.no_grad():
        for name, p in list(model.named_parameters()):
            if isinstance(p, DTensor):
                mod, leaf = shd.owner(model, name)
                saved.append((mod, leaf, p))
                mod._parameters[leaf] = nn.Parameter(p.full_tensor(),
                                                     requires_grad=False)
    try:
        yield model
    finally:
        for mod, leaf, p in saved:
            mod._parameters[leaf] = p


def shard_rows(batch: dict, mesh) -> dict:
    """This rank's rows of every array of ``batch``: the leading ``batch``
    dim split over the data axes ``ACT_RULES`` name, major axis first.
    Refuses rows that do not split: every rank must hold as many."""
    dsh = math.prod(shd.mesh_shape(mesh).get(a, 1) for a in DATA_AXES)
    out = {}
    for k, v in batch.items():
        if v is None:
            out[k] = None
            continue
        v = torch.as_tensor(v)
        spec = shd.resolve_spec(("batch",), shd.ACT_RULES, mesh,
                                tuple(v.shape[:1]))
        if dsh > 1 and not spec:
            raise ValueError(f"{v.shape[0]} rows of {k!r} do not split over "
                             f"{dsh} data ranks")
        out[k] = shd.local_shard(v, mesh, shd.placements(spec, mesh))
    return out


def _owns(mesh, placements) -> bool:
    """Whether this rank counts its shard in the global norm: it is at
    coordinate 0 of every mesh dim the tensor is replicated over."""
    coord = mesh.get_coordinate()
    return all(coord[m] == 0 for m, pl in enumerate(placements)
               if not isinstance(pl, Shard))


def global_norm(shards: dict, named: dict, mesh) -> torch.Tensor:
    """The gradient's global norm from each rank's shards, every element
    counted once (one all-reduce over the mesh).  Each rank takes the norm
    of its counted shards' norms, as ``optimizer.global_norm`` does, and
    the ranks sum its square: on one rank that is the single-device norm,
    bit for bit (a square's square root gives the number back)."""
    norms = torch._foreach_norm(list(shards.values()), 2,
                                dtype=torch.float32)
    local = torch.linalg.vector_norm(torch.stack([
        n if _owns(mesh, named[k].placements) else torch.zeros_like(n)
        for k, n in zip(shards, norms)]))
    sq = local * local
    dist.all_reduce(sq)
    return torch.sqrt(sq)


def make_sharded_train_step(cfg, tcfg: TrainConfig, mesh):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics) for a model and state that ``shard_`` laid out on ``mesh``;
    ``batch`` is the global batch, the same on every rank.  Metrics are the
    single-device step's, as 0-d fp32 tensors every rank holds."""
    sizes = shd.mesh_shape(mesh)
    data_groups = [mesh.get_group(a) for a in DATA_AXES if a in sizes]
    dsh = math.prod(sizes.get(a, 1) for a in DATA_AXES)
    grads_of = make_grads_fn(cfg, tcfg,
                             local=functools.partial(shard_rows, mesh=mesh))

    def data_mean_(t: torch.Tensor) -> torch.Tensor:
        for g in data_groups:
            dist.all_reduce(t, group=g)
        return t.div_(dsh) if dsh > 1 else t

    def train_step(params, opt_state, batch):
        if batch.get("mask") is not None:
            raise ValueError("the sharded step takes no mask: each rank "
                             "normalises by its own rows")
        with shd.use_sharding(mesh), gathered(params):
            loss, metrics, grads = grads_of(params, batch)
        named = dict(params.named_parameters())
        with torch.no_grad():
            shards = {}
            for n in list(grads):
                g = data_mean_(grads.pop(n).contiguous())
                block = shd.local_shard(g, mesh, named[n].placements)
                shards[n] = block.clone() if block.numel() != g.numel() \
                    else block
                del g, block
            keys = list(metrics)
            vals = data_mean_(torch.stack([loss, *metrics.values()]))
            loss, metrics = vals[0], dict(zip(keys, vals[1:]))
            gnorm = global_norm(shards, named, mesh)
            state = {"step": opt_state["step"],
                     **{part: {n: t.to_local()
                               for n, t in opt_state[part].items()}
                        for part in ("m", "v")}}
            om = opt.update_({n: p.to_local() for n, p in named.items()},
                             shards, state, tcfg.optimizer, gnorm)
        return params, opt_state, {"loss": loss, **metrics, **om}

    return train_step
