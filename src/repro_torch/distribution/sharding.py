"""Logical-axis sharding: params and activations carry *logical* axis names
(models/common.py); this module resolves them onto mesh axes per a rule set.

Resolution is best-effort: a logical axis whose dimension is not divisible by
the product of its mesh axes is dropped (replicated) rather than erroring —
the divisibility fallback that lets e.g. a 24-head model run on a 16-wide
tensor axis (the weight stays FSDP-sharded on `embed`).

The reference's ``PartitionSpec`` is a tuple here, one entry per tensor dim
(trailing ``None`` entries dropped): ``None``, a mesh axis name, or a tuple
of names.  ``placements`` turns it into DTensor placements over a
``torch.distributed.device_mesh.DeviceMesh`` whose dim names are the
reference's axis names.  Every function that only reads axis sizes
(``resolve_spec``, ``placements``, ``mesh_shape``) also takes anything with a
``.shape`` mapping from axis name to size, so the production mesh's layout
can be computed without its 256 ranks.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

# logical axis -> mesh axis (str), tuple of mesh axes, or None (replicated)
PARAM_RULES: dict[str, Any] = {
    "batch": None, "seq": None,
    "embed": "data",          # FSDP/ZeRO-3: weights + opt state sharded on data
    "ffn": "model",           # TP
    "heads": "model",         # TP
    "kv_heads": None,         # GQA kv groups are narrower than the TP axis
    "head_dim": None,
    "vocab": "model",         # TP on embedding/lm_head
    "experts": "model",       # EP
    "layers": None,           # scan axis
    "state": None, "capacity": None, "kv_lora": None, "q_lora": None,
    "conv": None, "frames": None, "experts_group": None, "attn_seq": None,
}

# activation rules (training / prefill): batch data-parallel over pod+data
ACT_RULES: dict[str, Any] = {
    **{k: None for k in PARAM_RULES},
    "batch": ("pod", "data"),
    "heads": "model", "ffn": "model", "vocab": "model", "experts": "model",
    "embed": None, "kv_seq": None,
    "experts_group": ("pod", "data"),  # grouped MoE dispatch locality
    "attn_seq": None,                  # optional SP for unshardable heads
}

# activation rules for long-context decode (batch too small to shard):
# sequence-parallel KV cache over the data axis.
ACT_RULES_SP: dict[str, Any] = {
    **ACT_RULES,
    "batch": None,
    "kv_seq": "data",
    "seq": None,
}


def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size}, in the mesh's axis order: a ``DeviceMesh``'s dim
    names and sizes, or a ``.shape`` mapping as it is."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


@dataclasses.dataclass
class ShardingCtx:
    mesh: Any
    param_rules: dict[str, Any]
    act_rules: dict[str, Any]


_STATE = threading.local()


def current_ctx() -> ShardingCtx | None:
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def use_sharding(mesh, param_rules=None, act_rules=None):
    prev = current_ctx()
    _STATE.ctx = ShardingCtx(
        mesh=mesh,
        param_rules=dict(param_rules or PARAM_RULES),
        act_rules=dict(act_rules or ACT_RULES),
    )
    try:
        yield _STATE.ctx
    finally:
        _STATE.ctx = prev


def _mesh_axes_for(logical: str, rules: dict, shape: dict):
    mapped = rules.get(logical)
    if mapped is None:
        return None
    axes = (mapped,) if isinstance(mapped, str) else tuple(mapped)
    axes = tuple(a for a in axes if a in shape)
    return axes or None


def resolve_spec(logical_axes: tuple, rules: dict, mesh,
                 shape: tuple | None = None) -> tuple:
    """Logical axes tuple -> spec tuple, with divisibility fallback."""
    sizes = mesh_shape(mesh)
    used: set[str] = set()
    parts = []
    for d, name in enumerate(logical_axes):
        if name is None:
            parts.append(None)
            continue
        axes = _mesh_axes_for(name, rules, sizes)
        if axes is None:
            parts.append(None)
            continue
        axes = tuple(a for a in axes if a not in used)
        if not axes:
            parts.append(None)
            continue
        if shape is not None:
            size = 1
            for a in axes:
                size *= sizes[a]
            if shape[d] % size != 0:
                parts.append(None)  # divisibility fallback: replicate
                continue
        used.update(axes)
        parts.append(axes if len(axes) > 1 else axes[0])
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def placements(spec: tuple, mesh) -> tuple:
    """A spec tuple -> one DTensor placement per mesh dim: ``Shard(d)`` where
    tensor dim ``d`` maps to that mesh axis, ``Replicate()`` otherwise.  A
    dim mapped to several axes (the batch's ``("pod", "data")``) is
    ``Shard(d)`` on each, split by the major axis first: DTensor's order,
    which needs the entry's axes in the mesh's order."""
    names = list(mesh_shape(mesh))
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis "
                             f"order {tuple(names)}")
        for m in dims:
            out[m] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec tuple: the layout of one tensor."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def shard_shape(self, shape) -> tuple:
        """The shape of each rank's shard of a tensor of ``shape``."""
        sizes = mesh_shape(self.mesh)
        out = list(shape)
        for d, entry in enumerate(self.spec):
            if entry is not None:
                axes = (entry,) if isinstance(entry, str) else entry
                out[d] //= math.prod(sizes[a] for a in axes)
        return tuple(out)


def _tree_map(fn, spec_tree, tree):
    """Map ``fn(spec, leaf)`` over nested dicts whose spec leaves are
    tuples."""
    if isinstance(spec_tree, tuple):
        return fn(spec_tree, tree)
    return {k: _tree_map(fn, v, tree[k]) for k, v in spec_tree.items()}


def param_sharding(spec_tree, params, mesh=None, rules: dict | None = None):
    """Logical-spec tree -> ``NamedSharding`` tree (shape-aware).  The trees
    are nested dicts with tuple spec leaves; ``params``' leaves are anything
    with a ``.shape`` (tensors, numpy arrays, shape structs), or shapes."""
    ctx = current_ctx()
    mesh = mesh or (ctx.mesh if ctx else None)
    rules = rules or (ctx.param_rules if ctx else PARAM_RULES)
    if mesh is None:
        raise ValueError("no mesh: call inside use_sharding() or pass mesh=")

    def one(spec, p):
        shape = tuple(getattr(p, "shape", p))
        return NamedSharding(mesh, resolve_spec(spec, rules, mesh, shape))

    return _tree_map(one, spec_tree, params)


def logical_constraint(x, *logical_axes):
    """The reference's ``with_sharding_constraint`` by logical names: the
    identity, outside a mesh and in the sharded step alike, whose every
    activation is a plain rank-local tensor (``train/sharded.py``)."""
    return x


def local_shard(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of ``full`` (a tensor every rank holds whole) under
    ``placements`` on ``mesh``, as a view: each ``Shard(d)`` mesh dim cuts
    dim ``d`` into even chunks, the major mesh dim first."""
    coord = mesh.get_coordinate()
    out = full
    for m, pl in enumerate(placements):
        if isinstance(pl, Shard):
            out = out.chunk(mesh.shape[m], dim=pl.dim)[coord[m]]
    return out


def dtensor(block: torch.Tensor, sharding: NamedSharding, shape) -> DTensor:
    """The DTensor of global ``shape`` (contiguous) whose block on this
    rank is ``block``."""
    shape = torch.Size(shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(block, sharding.mesh, sharding.placements,
                              run_check=False, shape=shape, stride=stride)


def distribute(t: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """A DTensor of ``t`` (which every rank holds whole, the same) laid out
    by ``sharding``: each rank keeps a copy of its own block only."""
    block = local_shard(t, sharding.mesh, sharding.placements)
    if block.numel() != t.numel():
        block = block.clone()
    return dtensor(block.contiguous(), sharding, t.shape)


def owner(model: nn.Module, name: str) -> tuple[nn.Module, str]:
    """The module that holds the parameter ``name``, and its name there."""
    prefix, _, leaf = name.rpartition(".")
    return (model.get_submodule(prefix) if prefix else model), leaf


def set_param(model: nn.Module, name: str, t: torch.Tensor) -> None:
    """Put ``t`` in place of the parameter ``name`` (no gradient asked)."""
    mod, leaf = owner(model, name)
    mod._parameters[leaf] = nn.Parameter(t, requires_grad=False)
