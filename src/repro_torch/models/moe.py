"""Mixture-of-Experts layer with sort-based capacity dispatch.

Dispatch keeps tensors at (E, C, d), never (tokens, E, C):

  1. router: softmax top-k over expert logits (fp32),
  2. flatten (token, k) assignments, sort by expert id (stable),
  3. rank within the expert group; drop beyond capacity C,
  4. fill the (E, C, d) buffer, run the gated-SwiGLU experts batched over E,
  5. combine with the routing weights; dropped assignments add zero (plus the
     shared experts, which always run densely).

``moe_impl`` ``"global"`` dispatches over all tokens at once; ``moe_groups >
1`` or ``"grouped"`` splits the tokens into G groups, each with its own
capacity, sort and buffer.  The global dispatch is the grouped one at G = 1
(same capacity, sort, drops and aux), so one batched body computes both.
``"a2a"`` is the reference's all-to-all expert parallelism over a mesh's
``model`` axis (``moe_apply_a2a``); without a mesh, on a ``model`` axis of 1,
or where the tokens or experts do not split, it falls through to the global
or grouped dispatch, as the reference's does.

Under ``use_sharding`` (the sharded train step) ``x`` holds this rank's rows
of the batch: the rows of its data coordinate, the same on every rank of its
``model`` group.  The global and grouped dispatch route only these rows, with
the whole batch's capacities, drops and aux, as the reference's global arrays
are routed under GSPMD (``_moe_apply_grouped``): where a group spans several
data ranks an exclusive scan of the per-expert counts over them (one small
all-gather) places each assignment in the slot the whole batch's sort gives
it, and a sum over the data ranks fills the whole buffer.  The aux's mean
probability is summed over the data ranks with the sum's adjoint, so each
rank's gradient carries the aux term of the whole batch, which the step's
average over data leaves once.  With ``experts`` split over ``model`` (a
split step, ``distribution/tensor_parallel.py``) each rank runs its own
experts on their whole capacity and the sum over k of a token's outputs
ends in an all-reduce over ``model``: a rank sums its own experts' terms,
rounded once, and the all-reduce adds the ranks' sums, each addition
rounded again (in bf16 on the card).

How the port differs from the reference's jnp, on purpose:
  * the buffer is filled by a gather (each slot reads the token the sort put
    there) and the combine gathers each token's k expert outputs through the
    inverse of the sort, (n, k, d), and sums over k.  The reference
    scatter-adds the k weighted outputs into the token rows, k roundings in
    the activations' dtype in an order the backend picks (CUDA's bf16
    ``index_add_`` uses atomics, so its order changes from run to run); the
    sum over k rounds once (once per rank, then the all-reduce's roundings,
    with experts split over ``model``) and is deterministic.
  * no step reads a value back to the host: group starts come from
    ``searchsorted`` over the sorted expert ids (CUDA's ``bincount`` syncs to
    size its output), and capacities from the token count alone.

``record_routing()`` collects each call's routing (top-k ids, kept slots)
for checks that compare passes; nothing is recorded outside it.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch import nn

from repro_torch.distribution import tensor_parallel as tp
from repro_torch.distribution.sharding import current_ctx, mesh_shape
from repro_torch.distribution.tensor_parallel import DATA_AXES, MODEL_AXIS
from repro_torch.models.common import (
    EMBED, EXPERTS, FFN, SwiGLU, dense_init, frozen_param, mlp_specs, swiglu,
)

_RECORDERS: list[list] = []


class MoE(nn.Module):
    """router (d, E) fp32, gate / up (d, E, f), down (f, E, d); ``shared``:
    a SwiGLU of width ``expert_d_ff · n_shared_experts``, or None."""

    def __init__(self, router, gate, up, down, shared: SwiGLU | None = None):
        super().__init__()
        self.router = frozen_param(router)
        self.gate, self.up, self.down = (frozen_param(w)
                                         for w in (gate, up, down))
        self.shared = shared


def moe_init(generator: torch.Generator, cfg, dtype, device=None) -> MoE:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.expert_d_ff

    def dense(i, o, dt=dtype):
        return dense_init(generator, i, o, dt, device=device)

    router, gate, up, down = (dense(d, e, torch.float32), dense(d, (e, f)),
                              dense(d, (e, f)), dense(f, (e, d)))
    shared = None
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        shared = SwiGLU(dense(d, fs), dense(d, fs), dense(fs, d))
    return MoE(router, gate, up, down, shared)


def moe_specs(cfg):
    s = {
        "router": (EMBED, EXPERTS),
        "gate": (EMBED, EXPERTS, FFN),
        "up": (EMBED, EXPERTS, FFN),
        "down": (FFN, EXPERTS, EMBED),
    }
    if cfg.n_shared_experts:
        s["shared"] = mlp_specs()
    return s


def capacity_for(n_tokens: int, cfg) -> int:
    """Slots per expert: top_k · capacity_factor of an even share, padded
    to a multiple of 8 (the reference's TPU sublanes, kept so capacities and
    drops are the reference's)."""
    c = int(n_tokens * cfg.moe_top_k * cfg.capacity_factor / cfg.n_experts)
    return max(-(-c // 8) * 8, 8)


@contextlib.contextmanager
def record_routing():
    """Within the block, every ``moe_apply`` appends its routing to the
    yielded list: ``{"top_e": (G, Tg, k), "keep": (G, Tg·k), "slot":
    (G, Tg·k), "cap": int}``, assignments in token order (token t's choice j
    at t·k + j), ``slot`` = expert · cap + rank, E · cap where dropped."""
    rec: list = []
    _RECORDERS.append(rec)
    try:
        yield rec
    finally:
        _RECORDERS.remove(rec)


def _route(p: MoE, cfg, toks, cap: int, offsets=None):
    """toks (G, Tg, d) -> probs (G, Tg, E), top_w / top_e (G, Tg, k), and
    in sorted order: the token of each assignment (G, Tg·k), group starts
    and counts (G, E); in token order: slot and keep (G, Tg·k).
    ``offsets(counts)`` -> (G, E): the slots of each expert that the data
    ranks before this one fill in each group (none if not given)."""
    g, tg, _ = toks.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    dev = toks.device
    probs = torch.softmax(toks.to(torch.float32) @ tp.take(p.router), dim=-1)
    top_w, top_e = torch.topk(probs, k, dim=-1)
    if cfg.moe_renormalize:
        top_w = top_w / (top_w.sum(dim=-1, keepdim=True) + 1e-9)
    flat_e = top_e.reshape(g, tg * k)
    order = torch.argsort(flat_e, dim=1, stable=True)
    se = torch.gather(flat_e, 1, order)
    experts = torch.arange(e, device=dev).expand(g, e).contiguous()
    start = torch.searchsorted(se, experts)
    counts = torch.searchsorted(se, experts, right=True) - start
    ranks = torch.arange(tg * k, device=dev).expand(g, -1)
    pos = ranks - torch.gather(start, 1, se)
    off = None
    if offsets is not None:
        off = offsets(counts)
        pos = pos + torch.gather(off, 1, se)
    keep_sorted = pos < cap
    slot_sorted = torch.where(keep_sorted, se * cap + pos, e * cap)
    # back to token order: inv[order[i]] = i (order is a permutation)
    inv = torch.empty_like(order).scatter_(1, order, ranks)
    slot = torch.gather(slot_sorted, 1, inv)
    return {"probs": probs, "top_w": top_w, "top_e": top_e, "cap": cap,
            "token_sorted": order // k, "start": start, "counts": counts,
            "off": off, "slot": slot, "keep": slot < e * cap}


def _experts(gate, up, down, buf):
    """buf (E, R, d) -> (E, R, d): per expert silu(x@gate)·(x@up) @ down.
    The weights gate / up (d, E, f) and down (f, E, d) are read in place as
    (E, d, f) / (E, f, d) strided views."""
    gate, up, down = (w.transpose(0, 1) for w in (gate, up, down))
    return torch.bmm(F.silu(torch.bmm(buf, gate)) * torch.bmm(buf, up), down)


def _data_rank(mesh, axes) -> int:
    """This rank's place among the data ranks of ``axes``, major first."""
    sizes = mesh_shape(mesh)
    row = 0
    for a in axes:
        row = row * sizes[a] + mesh.get_local_rank(a)
    return row


def _moe_apply_grouped(p: MoE, cfg, x, groups: int, with_aux: bool,
                       mesh=None, rows: tuple = ()):
    """The global (G = 1) and grouped dispatch of this rank's tokens.

    ``rows``: the data axes that split the batch's rows (none without a
    mesh).  Where the G groups split over them, this rank's rows are
    G / (data ranks) whole groups, routed here alone.  Where each group
    spans several data ranks (the global dispatch), this rank routes its
    part of one group: an all-gather of the per-expert counts gives the
    slots the ranks before it fill (an exclusive scan), so each assignment
    lands in the slot the whole batch's routing gives it; each rank fills
    its slots of the (E, G·C) buffer and a sum over the data ranks gives
    every rank the whole buffer.  Capacities, drops and aux are the whole
    batch's.  With ``experts`` split over ``model``, a rank runs only its
    own experts, on their whole capacity, and the sum over k of each
    token's weighted outputs is completed by an all-reduce over ``model``."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    dev = x.device
    sizes = mesh_shape(mesh) if mesh is not None else {}
    dsh = math.prod(sizes[a] for a in rows)
    data_groups = [mesh.get_group(a) for a in rows]
    n_loc = b * s
    n = n_loc * dsh
    if n % groups:
        raise ValueError(f"{n} tokens do not split into {groups} moe_groups")
    tg = n // groups
    cap = capacity_for(tg, cfg)
    offsets, cs = None, None
    if groups % dsh == 0:                 # whole groups on this rank
        g_r, col = groups // dsh, None
    elif dsh % groups == 0:               # part of one group on this rank
        per = dsh // groups
        me = _data_rank(mesh, rows)
        g_r, col = 1, me // per
        first = col * per

        def offsets(counts):
            nonlocal cs
            whole = counts
            for grp in reversed(data_groups):   # pod-major rank order
                whole = _all_gather(whole, grp)
            cs = whole.reshape(dsh, e)
            return cs[first:me].sum(0, keepdim=True)
    else:
        raise ValueError(f"{groups} moe_groups do not split over, or into, "
                         f"{dsh} data ranks")
    toks = x.reshape(g_r, n_loc // g_r, d)
    r = _route(p, cfg, toks, cap, offsets)
    tgr = toks.shape[1]
    for rec in _RECORDERS:
        rec.append({"top_e": r["top_e"], "keep": r["keep"],
                    "slot": r["slot"], "cap": cap})
    split = tp.split(EXPERTS, e)
    j, m = tp.model_rank()
    e_loc = e // m if split else e
    e0 = j * e_loc if split else 0
    gi = torch.arange(g_r, device=dev)[:, None]

    # the buffer: slot (e, c) of group g holds the token at sorted index
    # start[g, e] + c - off[g, e] where this rank fills it, else zeros
    c_idx = torch.arange(cap, device=dev)
    start = r["start"][:, e0:e0 + e_loc, None]
    counts = r["counts"][:, e0:e0 + e_loc, None]
    if r["off"] is None:
        rel = c_idx
        filled = rel < counts                                # (G, E, C)
    else:
        rel = c_idx - r["off"][:, e0:e0 + e_loc, None]
        filled = (rel >= 0) & (rel < counts)
    src = torch.where(filled, start + rel, 0)
    tok = torch.gather(r["token_sorted"], 1, src.reshape(g_r, e_loc * cap))
    toks_in = tp.copy_in(toks) if split else toks
    buf = torch.where(filled.reshape(g_r, e_loc * cap, 1), toks_in[gi, tok],
                      0)
    buf = buf.reshape(g_r, e_loc, cap, d).transpose(0, 1) \
        .reshape(e_loc, g_r * cap, d)
    if col is not None:                   # this rank's slots of every group
        buf = tp.reduce_out(F.pad(buf, (0, 0, col * cap,
                                        (groups - col - 1) * cap)),
                            data_groups)
    if split:
        gate, up, down = (tp.take(w, 1) for w in (p.gate, p.up, p.down))
    else:
        gate, up, down = (tp.take(w) for w in (p.gate, p.up, p.down))
    out_e = _experts(gate, up, down, buf)                 # (E, G·C, d)

    # the combine: each token's k outputs, weighted, summed over k
    slot, keep = r["slot"], r["keep"]
    if split:
        keep = keep & (slot >= e0 * cap) & (slot < (e0 + e_loc) * cap)
        slot = slot - e0 * cap
    safe = torch.where(keep, slot, 0)
    gcol = gi if col is None else col
    picked = out_e[safe // cap, gcol * cap + safe % cap]  # (G, Tg·k, d)
    w = r["top_w"].reshape(g_r, tgr * k, 1).to(x.dtype)
    if split:
        w = tp.copy_in(w)
    per_assign = torch.where(keep[..., None], picked * w, 0)
    out = per_assign.reshape(g_r, tgr, k, d).sum(dim=2)
    if split:
        out = tp.reduce_out(out)
    if p.shared is not None:
        out = out + swiglu(toks, p.shared.gate, p.shared.up, p.shared.down)
    out = out.reshape(b, s, d)
    if not with_aux:
        return out
    # Switch-style load balancing: e · Σ_e (share of assignments) · (mean p)
    if dsh == 1:
        total = r["counts"].sum(0)
        mean_p = r["probs"].mean(dim=(0, 1))
    else:
        total = (cs.sum(0) if cs is not None
                 else tp.reduce_out(r["counts"].sum(0), data_groups))
        mean_p = tp.sum_over(r["probs"].sum(dim=(0, 1)), data_groups) / n
    frac = total.to(torch.float32) / (n * k)
    aux = e * torch.sum(frac * mean_p)
    return out, aux


def _all_gather(t, group):
    """``t`` of every rank of ``group``, stacked along dim 0.  Through
    autograd only where a gradient can be asked: a pass without one takes
    the plain collective, whose fake kernel every torch has (the dry run
    runs prefill and decode on fake tensors)."""
    if torch.is_grad_enabled():
        return funcol.all_gather_tensor_autograd(t, 0, group)
    return funcol.all_gather_tensor(t, 0, group)


def _all_to_all(t, group):
    """Even all-to-all of ``t``'s rows over ``group``, as ``_all_gather``
    picks its collective."""
    if torch.is_grad_enabled():
        return funcol.all_to_all_single_autograd(t, None, None, group)
    return funcol.all_to_all_single(t, None, None, group)


def moe_apply(p: MoE, cfg, x, with_aux: bool = False):
    """x: (B, S, d) -> (B, S, d)  [or (out, aux_loss) with with_aux].

    ``moe_impl == "a2a"`` under a mesh whose ``model`` axis is larger than 1
    runs ``moe_apply_a2a`` when the batch's tokens split over every rank and
    the experts over ``model`` (the reference's condition, ``moe.py:75-88``;
    decode steps have too few tokens).  Otherwise grouped dispatch
    (G = ``cfg.moe_groups``) when ``moe_groups > 1`` or ``moe_impl ==
    "grouped"``, global (G = 1) else, of this rank's rows
    (``_moe_apply_grouped``)."""
    ctx = current_ctx()
    sizes = mesh_shape(ctx.mesh) if ctx is not None else {}
    rows = tp.row_axes(sizes) if ctx is not None else ()
    dsh = math.prod(sizes[a] for a in rows)
    if cfg.moe_impl == "a2a" and sizes.get(MODEL_AXIS, 1) > 1:
        # x holds one data shard's rows: the batch has dsh times its tokens
        n = x.shape[0] * x.shape[1] * dsh
        if (n % math.prod(sizes.values()) == 0
                and cfg.n_experts % sizes[MODEL_AXIS] == 0):
            return moe_apply_a2a(p, cfg, x, ctx.mesh, with_aux)
    grouped = cfg.moe_groups > 1 or cfg.moe_impl == "grouped"
    groups = cfg.moe_groups if grouped else 1
    return _moe_apply_grouped(p, cfg, x, groups, with_aux,
                              None if ctx is None else ctx.mesh, rows)


# ---------------------------------------------------------------------------
# Explicit all-to-all expert parallelism — the reference's shard_map body
# ---------------------------------------------------------------------------


class _ScaleGrad(torch.autograd.Function):
    """Forward: the identity; backward: the gradient times ``scale``."""

    @staticmethod
    def forward(ctx, x, scale: float):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


class _MeanOverMesh(torch.autograd.Function):
    """Forward: the mean of a 0-d tensor over ``model`` and then each data
    axis (the reference's pmeans); backward: the gradient over the ``model``
    size.  Every rank's loss carries the same mean; the router's gradient is
    summed over ``model`` (``tp.take(..., partial=True)``) and the step
    averages over data, so each rank's own term takes 1/model of the
    cotangent: the reference's 1/(all ranks) once the data average is
    taken."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.n_model = mesh_shape(mesh)[axes[0]]
        out = x.detach().clone()
        for a in axes:
            dist.all_reduce(out, group=mesh.get_group(a))
            out /= mesh_shape(mesh)[a]
        return out

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n_model, None, None


def _local_sort_dispatch(ids, n_buckets: int, cap: int):
    """Sort rows by bucket id; returns (slot, keep) with slot = b*cap+pos,
    ``n_buckets * cap`` where dropped.

    Pure index math on one shard (no cross-device semantics)."""
    order = torch.argsort(ids, stable=True)
    sorted_ids = ids[order]
    # each bucket's first row, as the global dispatch finds it: bincount
    # would size its output on the host
    start = torch.searchsorted(
        sorted_ids, torch.arange(n_buckets, device=ids.device,
                                 dtype=sorted_ids.dtype))
    pos = torch.arange(ids.shape[0], device=ids.device) - start[sorted_ids]
    keep = pos < cap
    slot_sorted = torch.where(keep, sorted_ids * cap + pos, n_buckets * cap)
    # scatter back to original order
    slot = torch.empty_like(slot_sorted).scatter_(0, order, slot_sorted)
    keep_orig = torch.empty_like(keep).scatter_(0, order, keep)
    return slot, keep_orig


def _put_rows(n_rows: int, slot, rows):
    """(n_rows, d) zeros with ``rows[i]`` at ``slot[i]``; a slot of
    ``n_rows`` or more is dropped (jnp's ``.at[slot].set(mode="drop")``)."""
    buf = rows.new_zeros((n_rows + 1, *rows.shape[1:]))
    buf = buf.index_put((torch.clamp(slot, max=n_rows),), rows)
    return buf[:n_rows]


def moe_apply_a2a(p: MoE, cfg, x, mesh, with_aux: bool = False,
                  data_axes=DATA_AXES, model_axis=MODEL_AXIS):
    """DeepSeek-style EP: token shards exchange with expert shards via two
    all-to-alls over the mesh's ``model`` axis (send: token -> expert shard;
    return: expert outputs), instead of all-gathering every expert's
    outputs.  The reference's ``shard_map`` body (``moe.py:259-363``) on one
    rank of a ``DeviceMesh``.

    Runs in a split step over ``mesh`` (``distribution/tensor_parallel.py``):
    ``x`` (b, s, d) is this rank's data shard, the same on every rank of its
    ``model`` group, and ``p``'s experts are this rank's, as its weights are
    stored.  Rank j of the ``model`` group (jax's ``axis_index``) routes
    tokens [j·t_loc, (j+1)·t_loc) of the shard and runs experts [j·e_loc,
    (j+1)·e_loc); an all-gather over ``model`` reassembles the shard's
    output.  Gradients follow ``shard_map``'s transpose: the inputs
    replicated over ``model`` (tokens, router) sum their gradients over it,
    the output's cotangent is divided by the ``model`` size before the
    all-gather's backward sums it."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    sizes = mesh_shape(mesh)
    axes_present = tuple(a for a in data_axes if a in sizes)
    msh = sizes[model_axis]
    n_loc = b * s
    if n_loc % msh or e % msh:
        raise ValueError(f"{n_loc} tokens or {e} experts do not split over "
                         f"a model axis of {msh}")
    if tp.model_rank()[1] != msh:
        raise ValueError("moe_apply_a2a runs in a split step over its mesh "
                         "(tensor_parallel.use_split)")
    t_loc = n_loc // msh
    e_loc = e // msh
    cap_send = max(-(-int(t_loc * k * cfg.capacity_factor) // msh) // 8 * 8, 8)
    cap_loc = max(-(-msh * cap_send // e_loc) // 8 * 8, 8)
    group = mesh.get_group(model_axis)
    j = mesh.get_local_rank(model_axis)

    xt = tp.copy_in(x.reshape(n_loc, d)).narrow(0, j * t_loc, t_loc)
    router = tp.take(p.router, partial=True)
    gate, up, down = (tp.take(w, 1) for w in (p.gate, p.up, p.down))

    probs = torch.softmax(xt.to(torch.float32) @ router, dim=-1)
    top_w, top_e = torch.topk(probs, k, dim=-1)
    if cfg.moe_renormalize:
        top_w = top_w / (top_w.sum(dim=-1, keepdim=True) + 1e-9)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if with_aux:
        frac = F.one_hot(top_e, e).to(torch.float32).mean(dim=(0, 1))
        aux = e * torch.sum(frac * probs.mean(dim=0))
        aux = _MeanOverMesh.apply(aux, mesh, (model_axis, *axes_present))

    eid = top_e.reshape(-1)                              # (t_loc*k,)
    tid = torch.arange(t_loc, device=x.device).repeat_interleave(k)
    wgt = top_w.reshape(-1)
    slot, keep = _local_sort_dispatch(eid // e_loc, msh, cap_send)
    sendx = _put_rows(msh * cap_send, slot, xt[tid])
    # the expert within the shard and a valid flag, one int exchange
    meta = _put_rows(msh * cap_send, slot,
                     torch.stack([eid % e_loc, torch.ones_like(eid)], 1))

    # ---- exchange tokens with expert shards ------------------------------
    rx = _all_to_all(sendx, group)
    rmeta = torch.empty_like(meta)
    dist.all_to_all_single(rmeta, meta, group=group)
    # invalid rows -> bucket e_loc (dropped by capacity sentinel)
    rid = torch.where(rmeta[:, 1].bool(), rmeta[:, 0], e_loc)
    slot2, keep2 = _local_sort_dispatch(torch.clamp(rid, max=e_loc),
                                        e_loc + 1, cap_loc)
    drop2 = ~keep2 | (rid >= e_loc)
    slot2 = torch.where(drop2, (e_loc + 1) * cap_loc, slot2)
    buf = _put_rows((e_loc + 1) * cap_loc, slot2, rx)
    buf = buf[:e_loc * cap_loc].reshape(e_loc, cap_loc, d)

    # ---- local expert compute --------------------------------------------
    oute = _experts(gate, up, down, buf)

    # ---- return path -----------------------------------------------------
    flat = oute.reshape(e_loc * cap_loc, d)
    safe2 = torch.clamp(slot2, max=e_loc * cap_loc - 1)
    back = torch.where(drop2[:, None], 0.0, flat[safe2])
    backx = _all_to_all(back, group)
    safe1 = torch.clamp(slot, max=msh * cap_send - 1)
    per_assign = torch.where(keep[:, None],
                             backx[safe1] * wgt[:, None].to(x.dtype), 0.0)
    out_loc = per_assign.reshape(t_loc, k, d).sum(dim=1)
    # reassemble the data shard's tokens across the model axis; its
    # cotangent is replicated over model, so it is divided by the model size
    # before the all-gather's backward sums it (shard_map's transpose)
    out = _ScaleGrad.apply(_all_gather(out_loc, group), 1.0 / msh)
    out = out.reshape(b, s, d)
    if p.shared is not None:
        out = out + swiglu(x, p.shared.gate, p.shared.up, p.shared.down)
    return (out, aux) if with_aux else out
