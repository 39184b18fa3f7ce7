"""Sharded training over a ``DeviceMesh`` with the reference's axes
(``("data", "model")``, or ``("pod", "data", "model")``): the reference's
``make_train_step`` under ``use_sharding`` (``launch/train.py:27-42``).

Storage.  ``shard_`` lays every parameter of the model, and the AdamW
moments ``m`` and ``v``, out as DTensors with the placements of
``param_sharding(param_axes)`` and ``state_specs`` (``layout``): each rank
holds only its shard between steps.  ``step`` stays a plain 0-d tensor that
every rank holds.

Compute.  A step is a split step (``distribution/tensor_parallel.py``):
the forward and backward (``train_step.make_grads_fn``, the kernels
included) run on this rank's rows of each microbatch with the parameters as
this rank's blocks.  Each layer gathers its weights over the data axes
inside the function remat checkpoints, so the recompute gathers them again,
and each microbatch gathers again.  Along ``model`` the products are split
where ``resolve_spec`` splits the axis: heads (``wq``, ``wo``; MLA's
``wuq``, ``wuk``, ``wuv``), ffn (the MLPs), vocab (the lookup, the logits
and the cross entropy) and experts (the MoE's global, grouped and a2a
dispatch), rwkv6's time mix (heads, or its projections' columns where
the heads do not divide) and channel mix (ffn), and mamba2's heads; a
width that does not divide the ``model`` size is computed whole on every
rank of the model group.  The rows:
each microbatch is cut from the global batch as the single-device step
cuts it, then split over the data axes present as ``ACT_RULES["batch"]``
says; ranks along ``model`` take the same rows.  ``lm_loss`` normalises by
the mask's sum over the rows it sees.  With no mask and equal rows on every
rank, the mean of the ranks' means is the batch's mean, so the averaged
gradients and metrics are the single-device step's; a masked batch is
refused.

Gradients.  Each arrives as this rank's block: the gather's backward
reduce-scatters it over the data axes (the mean over the data ranks in one
collective), and a weight's gradient along ``model`` is its own chunk's.
The step clips them by the global norm (each element counted once: a block
replicated over some mesh dims counts on the rank at coordinate 0 of each)
and updates the blocks in place.

Memory.  Within a step a rank holds its shards, one layer's weights
gathered over the data axes, its gradients' blocks and the activations:
the whole model is never gathered.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard

from repro_torch.distribution import sharding as shd
from repro_torch.distribution import tensor_parallel as tp
from repro_torch.distribution.tensor_parallel import DATA_AXES
from repro_torch.models import transformer as T
from repro_torch.obs.trace import region
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
    norms = opt.norms(list(shards.values()))
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
        with region("step"):
            with shd.use_sharding(mesh), tp.use_split(params, mesh):
                loss, metrics, grads = grads_of(params, batch)
            named = dict(params.named_parameters())
            with torch.no_grad():
                shards = {n: g.contiguous() for n, g in grads.items()}
                del grads
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
