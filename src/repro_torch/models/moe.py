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
``model`` axis (``shard_map``); without a mesh it falls through to the global
or grouped dispatch, and so it does here: the mesh path waits for the
training slice (ROADMAP queue 1 item 9).

How the port differs from the reference's jnp, on purpose:
  * the buffer is filled by a gather (each slot reads the token the sort put
    there) and the combine gathers each token's k expert outputs through the
    inverse of the sort, (n, k, d), and sums over k.  The reference
    scatter-adds the k weighted outputs into the token rows, k roundings in
    the activations' dtype in an order the backend picks (CUDA's bf16
    ``index_add_`` uses atomics, so its order changes from run to run); the
    sum over k rounds once and is deterministic.
  * no step reads a value back to the host: group starts come from
    ``searchsorted`` over the sorted expert ids (CUDA's ``bincount`` syncs to
    size its output), and capacities from the token count alone.

``record_routing()`` collects each call's routing (top-k ids, kept slots)
for checks that compare passes; nothing is recorded outside it.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import SwiGLU, dense_init, frozen_param, swiglu

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


def _route(p: MoE, cfg, toks):
    """toks (G, Tg, d) -> probs (G, Tg, E), top_w / top_e (G, Tg, k), and
    in sorted order: the token of each assignment (G, Tg·k), group starts
    and counts (G, E); in token order: slot and keep (G, Tg·k)."""
    g, tg, _ = toks.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    cap = capacity_for(tg, cfg)
    dev = toks.device
    probs = torch.softmax(toks.to(torch.float32) @ p.router, dim=-1)
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
    keep_sorted = pos < cap
    slot_sorted = torch.where(keep_sorted, se * cap + pos, e * cap)
    # back to token order: inv[order[i]] = i (order is a permutation)
    inv = torch.empty_like(order).scatter_(1, order, ranks)
    slot = torch.gather(slot_sorted, 1, inv)
    return {"probs": probs, "top_w": top_w, "top_e": top_e, "cap": cap,
            "token_sorted": order // k, "start": start, "counts": counts,
            "slot": slot, "keep": slot < e * cap}


def _experts(p: MoE, buf):
    """buf (E, R, d) -> (E, R, d): per expert silu(x@gate)·(x@up) @ down.
    The weights are read in place as (E, d, f) / (E, f, d) strided views."""
    gate, up, down = (w.transpose(0, 1) for w in (p.gate, p.up, p.down))
    return torch.bmm(F.silu(torch.bmm(buf, gate)) * torch.bmm(buf, up), down)


def _moe_apply_grouped(p: MoE, cfg, x, groups: int, with_aux: bool):
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    n = b * s
    if n % groups:
        raise ValueError(f"{n} tokens do not split into {groups} moe_groups")
    tg = n // groups
    toks = x.reshape(groups, tg, d)
    r = _route(p, cfg, toks)
    cap = r["cap"]
    for rec in _RECORDERS:
        rec.append({"top_e": r["top_e"], "keep": r["keep"],
                    "slot": r["slot"], "cap": cap})
    dev = x.device
    gi = torch.arange(groups, device=dev)[:, None]

    # the buffer: slot (e, c) of group g holds the token at sorted index
    # start[g, e] + c while c < counts[g, e], else zeros
    c_idx = torch.arange(cap, device=dev)
    filled = c_idx < r["counts"][..., None]                  # (G, E, C)
    src = torch.where(filled, r["start"][..., None] + c_idx, 0)
    tok = torch.gather(r["token_sorted"], 1, src.reshape(groups, e * cap))
    buf = torch.where(filled.reshape(groups, e * cap, 1), toks[gi, tok], 0)
    buf = buf.reshape(groups, e, cap, d).transpose(0, 1) \
        .reshape(e, groups * cap, d)
    out_e = _experts(p, buf)                                 # (E, G·C, d)

    # the combine: each token's k outputs, weighted, summed over k
    slot, keep = r["slot"], r["keep"]
    safe = torch.where(keep, slot, 0)
    picked = out_e[safe // cap, gi * cap + safe % cap]        # (G, Tg·k, d)
    w = r["top_w"].reshape(groups, tg * k, 1).to(x.dtype)
    per_assign = torch.where(keep[..., None], picked * w, 0)
    out = per_assign.reshape(groups, tg, k, d).sum(dim=2)
    if p.shared is not None:
        out = out + swiglu(toks, p.shared.gate, p.shared.up, p.shared.down)
    out = out.reshape(b, s, d)
    if not with_aux:
        return out
    # Switch-style load balancing: e · Σ_e (share of assignments) · (mean p)
    frac = r["counts"].sum(0).to(torch.float32) / (n * k)
    aux = e * torch.sum(frac * r["probs"].mean(dim=(0, 1)))
    return out, aux


def moe_apply(p: MoE, cfg, x, with_aux: bool = False):
    """x: (B, S, d) -> (B, S, d)  [or (out, aux_loss) with with_aux].

    Grouped dispatch (G = ``cfg.moe_groups``) when ``moe_groups > 1`` or
    ``moe_impl == "grouped"``; global (G = 1) otherwise, ``"a2a"`` included
    (no mesh: the reference's fall-through)."""
    grouped = cfg.moe_groups > 1 or cfg.moe_impl == "grouped"
    return _moe_apply_grouped(p, cfg, x, cfg.moe_groups if grouped else 1,
                              with_aux)
