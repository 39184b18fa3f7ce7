"""Tensor-parallel compute over the mesh's ``model`` axis, and the weights
gathered over the data axes one layer at a time: the sharded step's half
of what the reference gets from GSPMD through its specs and its
``logical_constraint`` calls (heads ``models/attention.py:216``, ``:247``,
``:353``, ``:403``; vocab ``models/transformer.py:111``, ``:503``; experts
``models/moe.py:127``, ``:131``, ``:200``).

``use_split(model, mesh)`` opens a split step: every DTensor parameter of
the model is replaced by this rank's block (a plain tensor sharing the
DTensor's storage, the leaf the step's gradients are taken of) for the
block.  The layer functions then gather each layer's blocks inside the
function that remat checkpoints (``gather_params``), so a recompute gathers
them again:

  * over the data axes (``pod``, ``data``) the gather is an all-gather along
    each dim a weight is stored split on, whose backward is a reduce-scatter
    and one scale: the gradient arrives as this rank's block of the mean
    over the data ranks, in one collective (an all-reduce over a data axis
    the weight is replicated on);
  * along ``model`` a weight keeps its storage block.  ``take`` hands the
    compute this rank's chunk of the dim it splits, or the whole weight,
    gathered over ``model`` where it is stored split.

Along ``model`` the compute follows the Megatron pattern: an activation
that every rank of the model group holds whole enters a split region
through ``copy_in`` (identity forward, all-reduce backward) and a
row-parallel product leaves it through ``reduce_out`` (all-reduce forward,
identity backward).  A weight used in a split region that is not split
there (``wk``/``wv`` under split heads, whose kv heads are replicated) is
taken ``partial``: its gradient is summed over ``model``.  Compute that
must see a whole activation of which each rank holds its columns (rwkv6's
WKV where its heads do not divide ``model``) gathers it (``gather_model``,
backward: the rank's own chunk) and, after it, takes its columns back
(``split_in``, backward: an all-gather).  Every other weight outside a
split region is computed the same way on every rank of the model group,
so its gradient is the whole one on each, and a weight stored split over
``model`` but computed whole keeps its own chunk of it.

``split(axis, size)`` says whether a logical axis is split on this mesh:
``resolve_spec`` with its divisibility fallback, on a ``model`` axis larger
than one, so a width that does not divide it stays replicated, as in the
reference (``src/repro/distribution/sharding.py:110-117``).  Outside a
split step every helper is the identity, and on a mesh of one rank every
collective is left out, so the step's ops are the single-device step's.

A decode step may be handed its caches as this rank's blocks along
``kv_seq`` (``use_split``'s ``kv_len``; ``launch/specs.py``): where the
activation rules split ``kv_seq`` (``model`` at decode_32k, ``data`` then
``model`` at long_500k) ``seq_block`` says which positions the rank holds
and over which groups, and ``seq_stack`` gathers each rank's partial
softmax over them (``models/attention.py``), as the reference's GSPMD
keeps the cache split along ``kv_seq``
(``src/repro/models/attention.py:231-232``, ``:369``).

The context is thread-local, as ``use_sharding``'s is: autograd runs a
CUDA backward, and so remat's recompute, in its own device thread, which
``models/transformer.py``'s remat opens with the contexts the forward saw
(``restored``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Shard
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.distribution import sharding as shd

#: the reference's data axes, major first, and its tensor-parallel axis
DATA_AXES = ("pod", "data")
MODEL_AXIS = "model"


# ---------------------------------------------------------------------------
# collectives as autograd functions
# ---------------------------------------------------------------------------


def _gather(t, dim: int, group) -> torch.Tensor:
    """The ranks' ``t`` of ``group`` concatenated along ``dim``."""
    n = dist.get_world_size(group)
    out = t.new_empty((n * t.shape[0], *t.shape[1:]))
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out.unflatten(0, (n, t.shape[0])).movedim(0, dim) \
        .flatten(dim, dim + 1)


def _reduce_scatter(t, dim: int, group) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the sum of the ranks' ``t``."""
    n = dist.get_world_size(group)
    parts = t.unflatten(dim, (n, t.shape[dim] // n)).movedim(dim, 0)
    out = t.new_empty(parts.shape[1:])
    dist.reduce_scatter_tensor(out, parts.flatten(0, 1).contiguous(),
                               group=group)
    return out


def _all_reduce(t, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    return out


class _CopyIn(torch.autograd.Function):
    """Forward: the identity on a tensor each rank of ``groups`` holds
    whole; backward: the sum of the ranks' gradients over each group."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        for grp in ctx.groups:
            g = _all_reduce(g, grp)
        return g, None


class _ReduceOut(torch.autograd.Function):
    """Forward: the sum over ``groups`` of each rank's part; backward: the
    identity (each rank's part reaches the whole through the sum once)."""

    @staticmethod
    def forward(ctx, x, groups):
        for g in groups:
            x = _all_reduce(x, g)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(torch.autograd.Function):
    """Forward: the whole of ``w`` along ``dim`` over ``group`` (stored
    split there).  Backward: ``"sum"`` reduce-scatters the gradient (each
    rank's compute was a part), ``"own"`` keeps this rank's chunk of it
    (each rank computed the whole gradient)."""

    @staticmethod
    def forward(ctx, w, dim, group, rank, backward):
        ctx.dim, ctx.group, ctx.rank, ctx.mode = dim, group, rank, backward
        ctx.size = w.shape[dim]
        return _gather(w, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.mode == "sum":
            g = _reduce_scatter(g, ctx.dim, ctx.group)
        else:
            g = g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size)
        return g, None, None, None, None


class _SplitIn(torch.autograd.Function):
    """Forward: this rank's chunk along ``dim`` of a tensor every rank of
    ``group`` holds whole; backward: the ranks' chunks' gradients
    concatenated (one all-gather), the whole gradient on every rank."""

    @staticmethod
    def forward(ctx, x, dim, group, rank, n):
        ctx.dim, ctx.group = dim, group
        size = x.shape[dim] // n
        return x.narrow(dim, rank * size, size).clone()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None, None, None


def _all_to_all(t, split: int, cat: int, group) -> torch.Tensor:
    """Rank r sends chunk k of ``t`` along ``split`` to rank k and
    concatenates what it gets along ``cat``, in rank order."""
    n = dist.get_world_size(group)
    parts = t.unflatten(split, (n, t.shape[split] // n)).movedim(split, 0)
    parts = parts.contiguous()
    out = torch.empty_like(parts)
    dist.all_to_all_single(out, parts, group=group)
    return out.movedim(0, cat).flatten(cat, cat + 1)


class _Reshard(torch.autograd.Function):
    """Forward: a weight stored split along ``stored`` over ``group`` as
    this rank's chunk of dim ``dim`` instead, whole along ``stored`` (one
    all-to-all); backward: the inverse all-to-all (this rank's compute with
    its chunk is the group's only one)."""

    @staticmethod
    def forward(ctx, w, stored, dim, group):
        ctx.stored, ctx.dim, ctx.group = stored, dim, group
        return _all_to_all(w, dim, stored, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.stored, ctx.dim, ctx.group), None, None, \
            None


class _GatherData(torch.autograd.Function):
    """Forward: this rank's block of a weight, whole over the data axes (an
    all-gather along each data mesh dim it is stored split on).  Backward:
    this rank's block of the mean over the data ranks of the gradient: a
    reduce-scatter along each of those dims, an all-reduce over each data
    dim it is replicated on, then one division by the data ranks' count."""

    @staticmethod
    def forward(ctx, w, steps, n):
        ctx.steps, ctx.n = steps, n
        for group, dim in steps:
            if dim is not None:
                w = _gather(w, dim, group)
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        for group, dim in reversed(ctx.steps):
            g = (_all_reduce(g, group) if dim is None
                 else _reduce_scatter(g, dim, group))
        return g.div(ctx.n), None, None


# ---------------------------------------------------------------------------
# the split step
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Split:
    mesh: object
    m: int                      # the model group's size
    j: int                      # this rank's place in it
    model_group: object
    model_dim: int | None       # the model axis' mesh dim
    data: list                  # (mesh dim, group) of each data axis > 1
    dsh: int                    # data ranks
    #: a step's block -> its placements and global shape
    blocks: WeakIdKeyDictionary = dataclasses.field(
        default_factory=WeakIdKeyDictionary)
    #: a weight gathered over data -> (its model dim or None, global shape)
    gathered: WeakIdKeyDictionary = dataclasses.field(
        default_factory=WeakIdKeyDictionary)
    #: the global length along ``kv_seq`` of the caches the step is handed
    #: as this rank's blocks (``launch/specs.py``'s decode); None: whole
    kv_len: int | None = None


_STATE = threading.local()


def current() -> _Split | None:
    return getattr(_STATE, "ctx", None)


def _open(mesh, kv_len: int | None = None) -> _Split:
    sizes = shd.mesh_shape(mesh)
    names = list(sizes)
    coord = mesh.get_coordinate()
    md = names.index(MODEL_AXIS) if MODEL_AXIS in sizes else None
    data = [(names.index(a), mesh.get_group(a)) for a in DATA_AXES
            if sizes.get(a, 1) > 1]
    return _Split(
        mesh=mesh, m=sizes.get(MODEL_AXIS, 1),
        j=0 if md is None else coord[md],
        model_group=None if md is None else mesh.get_group(MODEL_AXIS),
        model_dim=md, data=data,
        dsh=math.prod(sizes.get(a, 1) for a in DATA_AXES), kv_len=kv_len)


@contextlib.contextmanager
def use_split(model: nn.Module, mesh, kv_len: int | None = None):
    """A split step over ``mesh`` for the block: the model's DTensor
    parameters are this rank's blocks (``nn.Parameter``s sharing their
    storage, asking for no gradient until the step says so), restored as
    DTensors after it.  ``kv_len``: the step's caches are this rank's
    blocks along ``kv_seq`` of caches of that global length, where the
    rules split it (``seq_block``)."""
    ctx = _open(mesh, kv_len)
    saved = []
    for name, p in list(model.named_parameters()):
        if not isinstance(p, DTensor):
            continue
        mod, leaf = shd.owner(model, name)
        block = nn.Parameter(p.to_local(), requires_grad=False)
        ctx.blocks[block] = (p.placements, tuple(p.shape))
        saved.append((mod, leaf, p))
        mod._parameters[leaf] = block
    prev, _STATE.ctx = current(), ctx
    try:
        yield ctx
    finally:
        _STATE.ctx = prev
        for mod, leaf, p in saved:
            mod._parameters[leaf] = p


@contextlib.contextmanager
def restored(ctx):
    """``ctx`` (``current()`` as a function saw it) open for the block: a
    recompute in autograd's thread sees what the forward saw."""
    prev, _STATE.ctx = current(), ctx
    try:
        yield
    finally:
        _STATE.ctx = prev


def _gather_data(ctx: _Split, block) -> torch.Tensor:
    placements, shape = ctx.blocks[block]
    if ctx.dsh > 1:
        steps = tuple(
            (group, placements[d].dim if isinstance(placements[d], Shard)
             else None) for d, group in ctx.data)
        w = _GatherData.apply(block, steps, ctx.dsh)
    else:
        w = block
    mp = None if ctx.model_dim is None else placements[ctx.model_dim]
    if isinstance(mp, Shard) and ctx.m > 1:
        ctx.gathered[w] = (mp.dim, shape)
    else:
        ctx.gathered[w] = (None, shape)
    return w


@contextlib.contextmanager
def gather_params(module: nn.Module, recurse: bool = True,
                  whole: bool = False):
    """Within the block each parameter of ``module`` (its own only, unless
    ``recurse``) that is a block of the split step is whole over the data
    axes; with ``whole`` also over ``model``, for compute that is the same
    on every rank of the model group (each keeps its own chunk of the
    gradient).  Outside a split step the module is left as it is."""
    ctx = current()
    if ctx is None:
        yield module
        return
    saved = []
    for name, p in list(module.named_parameters(recurse=recurse)):
        if p not in ctx.blocks:
            continue
        mod, leaf = shd.owner(module, name)
        w = _gather_data(ctx, p)
        if whole:
            w = take(w)
        saved.append((mod, leaf, p))
        mod._parameters[leaf] = w
    try:
        yield module
    finally:
        for mod, leaf, p in saved:
            mod._parameters[leaf] = p


def split(axis: str, size: int) -> bool:
    """Whether the compute splits logical ``axis`` of ``size`` over
    ``model`` on the current mesh: ``ACT_RULES`` (or the context's rules)
    map it there and ``size`` divides, on a model axis of more than one
    rank."""
    ctx = current()
    if ctx is None or ctx.m <= 1:
        return False
    sctx = shd.current_ctx()
    rules = sctx.act_rules if sctx is not None else shd.ACT_RULES
    return shd.resolve_spec((axis,), rules, ctx.mesh, (size,)) == (
        MODEL_AXIS,)


@dataclasses.dataclass(frozen=True)
class SeqBlock:
    """This rank's block of a cache split along ``kv_seq``: global
    positions [offset, offset + length), and the process groups of the
    mesh axes ``kv_seq`` resolves to (larger than one), major first."""
    offset: int
    length: int
    groups: tuple


def seq_block(t: int) -> SeqBlock | None:
    """This rank's block of the step's caches along ``kv_seq``, for a
    cache tensor of ``t`` positions, or None where the caches are whole:
    outside a split step, in one not handed blocks (``use_split``'s
    ``kv_len``), where the activation rules do not split ``kv_seq`` (or
    ``split()``'s divisibility fallback keeps it whole), or where its axes
    are one rank.  A cache of another length than the block's raises: a
    rule that splits ``kv_seq`` never falls back to a whole cache."""
    ctx = current()
    if ctx is None or ctx.kv_len is None:
        return None
    sctx = shd.current_ctx()
    rules = sctx.act_rules if sctx is not None else shd.ACT_RULES
    spec = shd.resolve_spec(("kv_seq",), rules, ctx.mesh, (ctx.kv_len,))
    sizes = shd.mesh_shape(ctx.mesh)
    axes = () if not spec else (
        (spec[0],) if isinstance(spec[0], str) else tuple(spec[0]))
    axes = tuple(a for a in axes if sizes[a] > 1)
    if not axes:
        return None
    names, coord = list(sizes), ctx.mesh.get_coordinate()
    block = 0
    for a in axes:
        block = block * sizes[a] + coord[names.index(a)]
    length = ctx.kv_len // math.prod(sizes[a] for a in axes)
    if t != length:
        raise ValueError(f"a cache of {t} positions in a step handed blocks "
                         f"of {length} along kv_seq ({axes})")
    return SeqBlock(block * length, length,
                    tuple(ctx.mesh.get_group(a) for a in axes))


def seq_stack(x: torch.Tensor, blk: SeqBlock) -> torch.Tensor:
    """Every rank's ``x`` of ``blk``'s groups, stacked along a new first
    dim in block order (an all-gather over each group, the minor first).
    No gradient: decode runs without autograd."""
    out = x[None]
    for g in reversed(blk.groups):
        out = _gather(out, 0, g)
    return out


def model_rank() -> tuple[int, int]:
    """(this rank's place in the model group, the group's size); (0, 1)
    outside a split step."""
    ctx = current()
    return (0, 1) if ctx is None else (ctx.j, ctx.m)


def full_size(w: torch.Tensor, dim: int) -> int:
    """The global size of dim ``dim`` of a gathered weight (its storage
    may split it over ``model``)."""
    ctx = current()
    if ctx is not None and w in ctx.gathered:
        return ctx.gathered[w][1][dim]
    return w.shape[dim]


def take(w: torch.Tensor, dim: int | None = None,
         partial: bool = False) -> torch.Tensor:
    """The weight ``w`` (gathered over data by ``gather_params``) as the
    compute uses it along ``model``: this rank's chunk of dim ``dim`` (its
    storage block, an all-to-all from a block of another dim, or a slice of
    a replicated weight), or whole with ``dim=None``.  ``partial``: the
    rank's use of the whole weight is a part of the model group's compute,
    so its gradient is summed over ``model``.  Outside a split step, ``w``
    itself."""
    ctx = current()
    if ctx is None or ctx.m <= 1:
        return w
    sdim = ctx.gathered[w][0] if w in ctx.gathered else None
    if sdim is not None and sdim == dim:
        return w
    if sdim is not None and dim is not None:
        return _Reshard.apply(w, sdim, dim, ctx.model_group)
    summed = partial or dim is not None
    if sdim is not None:
        w = _GatherModel.apply(w, sdim, ctx.model_group, ctx.j,
                               "sum" if summed else "own")
    elif summed:
        w = _CopyIn.apply(w, (ctx.model_group,))
    if dim is not None:
        size = w.shape[dim] // ctx.m
        w = w.narrow(dim, ctx.j * size, size)
    return w


def _groups(groups) -> tuple:
    """``groups``, or the model group of a split step where none are given
    (none outside a split step or on a model axis of one)."""
    if groups is not None:
        return tuple(groups)
    ctx = current()
    return () if ctx is None or ctx.m <= 1 else (ctx.model_group,)


def copy_in(x: torch.Tensor, groups=None) -> torch.Tensor:
    """``x``, whole on every rank of ``groups`` (the model group by
    default), entering a split region: the identity forward, the sum of the
    groups' gradients backward (``shard_map``'s transpose of an input
    replicated over an axis)."""
    groups = _groups(groups)
    return _CopyIn.apply(x, groups) if groups else x


def reduce_out(x: torch.Tensor, groups=None) -> torch.Tensor:
    """A row-parallel product's part leaving a split region: the sum over
    ``groups`` (the model group by default) forward, the identity backward.
    Over data groups: parts that fill disjoint places of one tensor, each
    place read back only by the rank that filled it."""
    groups = _groups(groups)
    return _ReduceOut.apply(x, groups) if groups else x


def model_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max over ``model`` of a tensor that takes no
    gradient."""
    ctx = current()
    if ctx is None or ctx.m <= 1:
        return x
    return _all_reduce(x, ctx.model_group, dist.ReduceOp.MAX)


def row_axes(sizes: dict) -> tuple[str, ...]:
    """The data axes (present, larger than one) that split the batch's
    rows under the current activation rules, major first."""
    sctx = shd.current_ctx()
    rules = sctx.act_rules if sctx is not None else shd.ACT_RULES
    mapped = rules.get("batch")
    axes = (mapped,) if isinstance(mapped, str) else tuple(mapped or ())
    return tuple(a for a in axes if sizes.get(a, 1) > 1)


def sum_over(x: torch.Tensor, groups=None) -> torch.Tensor:
    """The sum over ``groups`` (the model group by default) of each rank's
    ``x``, used by every rank (its gradient summed back over them)."""
    return copy_in(reduce_out(x, groups), groups)


def gather_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """An activation each rank of the model group holds its chunk of along
    ``dim``, whole along it (one all-gather), for compute that every rank
    then does the same; backward: this rank's chunk of the gradient (each
    rank's is the whole one).  ``x`` itself outside a split step."""
    ctx = current()
    if ctx is None or ctx.m <= 1:
        return x
    return _GatherModel.apply(x, dim % x.dim(), ctx.model_group, ctx.j,
                              "own")


def split_in(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's chunk along ``dim`` of an activation every rank of the
    model group holds whole, entering a split region: a slice forward, the
    ranks' gradients gathered backward.  ``x`` itself outside a split
    step."""
    ctx = current()
    if ctx is None or ctx.m <= 1:
        return x
    return _SplitIn.apply(x, dim % x.dim(), ctx.model_group, ctx.j, ctx.m)
