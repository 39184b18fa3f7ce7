"""Mamba-2 (SSD) block — scalar-per-head decay state space, chunked.

    h_t = a_t h_{t-1} + dt_t · x_t ⊗ B_t        a_t = exp(dt_t · A_h) ∈ (0,1)
    y_t = C_t · h_t + D_h x_t

Chunkwise-parallel evaluation (``mamba2_core_chunked``) and the
step-by-step recurrence (``mamba2_core_scan``, the oracle; decode runs it).
The intra-chunk term is a lower-triangular (t, s) block domain, diagonal
included.  Decode is O(1) per token on the (H, P, N) state plus a
width-(W-1) conv tail.  The reference computes all of it in plain jnp, not
in a Pallas kernel, and so does this port in plain torch; the cross-chunk
scan is a loop over chunks where the reference has ``lax.scan``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distribution import tensor_parallel as tp
from repro_torch.models.common import (
    EMBED, FFN, HEADS, dense_init, frozen_param, island_dtype, rms_norm,
)

MAMBA2_NAMES = ("in_proj", "conv_w", "conv_b", "a_log", "dt_bias", "d_skip",
                "norm", "out_proj")


class Mamba2(nn.Module):
    """in_proj (d, 2·d_inner + 2·N + H), conv_w (W, d_inner + 2·N), conv_b
    (d_inner + 2·N,), a_log / dt_bias / d_skip (H,) fp32, norm (d_inner,),
    out_proj (d_inner, d)."""

    def __init__(self, **weights):
        super().__init__()
        if set(weights) != set(MAMBA2_NAMES):
            raise ValueError(f"mamba2 weights {sorted(weights)}")
        for name in MAMBA2_NAMES:
            setattr(self, name, frozen_param(weights[name]))


def mamba2_init(generator: torch.Generator, cfg, dtype, device=None) -> Mamba2:
    d, di, n, h = cfg.d_model, cfg.mamba_d_inner, cfg.ssm_state, cfg.mamba_heads
    w = cfg.mamba_conv_width
    conv_dim = di + 2 * n
    in_proj = dense_init(generator, d, 2 * di + 2 * n + h, dtype, device=device)
    conv_w = torch.empty((w, conv_dim), dtype=torch.float32, device=device)
    conv_w.normal_(0.0, 1.0, generator=generator)
    out_proj = dense_init(generator, di, d, dtype, device=device)

    def f32(t):
        return t.to(device=device, dtype=torch.float32)

    return Mamba2(
        in_proj=in_proj, conv_w=(conv_w * (1.0 / w)).to(dtype),
        conv_b=torch.zeros(conv_dim, dtype=dtype, device=device),
        a_log=f32(torch.log(torch.linspace(1.0, 16.0, h))),
        dt_bias=f32(torch.zeros(h)), d_skip=f32(torch.ones(h)),
        norm=torch.ones(di, dtype=dtype, device=device), out_proj=out_proj)


def mamba2_specs(cfg):
    return {
        "in_proj": (EMBED, FFN),
        "conv_w": ("conv", FFN), "conv_b": (FFN,),
        "a_log": (HEADS,), "dt_bias": (HEADS,), "d_skip": (HEADS,),
        "norm": (FFN,),
        "out_proj": (FFN, EMBED),
    }


def _split_proj(cfg, zxbcdt, m: int = 1):
    """z, xBC and dt of ``in_proj``'s output; ``m``: the columns of one of
    ``m`` ranks over which the heads split (``_columns``)."""
    di, n, h = cfg.mamba_d_inner // m, cfg.ssm_state, cfg.mamba_heads // m
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * n]
    dt = zxbcdt[..., di + di + 2 * n:]
    if dt.shape[-1] != h:
        raise ValueError(f"in_proj gives {dt.shape[-1]} dt columns, want {h}")
    return z, xbc, dt


def _causal_conv(xbc, w, b, tail=None):
    """Depthwise causal conv along seq; tail: (B, W-1, C) from previous call.
    The W products are summed one at a time in xbc's dtype, as the
    reference's Python ``sum`` does."""
    width = w.shape[0]
    if tail is None:
        tail = torch.zeros((xbc.shape[0], width - 1, xbc.shape[-1]),
                           dtype=xbc.dtype, device=xbc.device)
    xp = torch.cat([tail.to(xbc.dtype), xbc], dim=1)
    out = sum(xp[:, i:i + xbc.shape[1], :] * w[i][None, None, :]
              for i in range(width))
    new_tail = xp[:, -(width - 1):, :] if width > 1 else tail
    return F.silu(out + b), new_tail


def _ssm_inputs(p: Mamba2, cfg, xbc_act, dt_raw):
    """x by head, B, C, dt and the log decay, for the heads of ``dt_raw``
    (every head, or this rank's under a split of the heads)."""
    n, h = cfg.ssm_state, dt_raw.shape[-1]
    di = xbc_act.shape[-1] - 2 * n
    ph = di // h
    fp = island_dtype(xbc_act.dtype)    # fp32, or float64 in a float64 model
    xh = xbc_act[..., :di]
    bmat = xbc_act[..., di:di + n].to(fp)
    cmat = xbc_act[..., di + n:].to(fp)
    bsz, s = xh.shape[:2]
    xh = xh.reshape(bsz, s, h, ph).to(fp)
    dt = F.softplus(dt_raw.to(fp) + p.dt_bias)
    a = -torch.exp(p.a_log)                       # negative per-head A
    loga = dt * a[None, None, :]                  # log decay (B,S,H) < 0
    return xh, bmat, cmat, dt, loga


def mamba2_core_chunked(p: Mamba2, cfg, xbc_act, dt_raw, state,
                        chunk: int = 64):
    """Chunked SSD. state: (B, H, P, N) fp32. Returns (y, new_state)."""
    xh, bmat, cmat, dt, loga = _ssm_inputs(p, cfg, xbc_act, dt_raw)
    bsz, s, h, ph = xh.shape
    n = bmat.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    nc = s // chunk

    xc = xh.reshape(bsz, nc, chunk, h, ph).permute(1, 0, 3, 2, 4)  # nc,B,h,C,P
    bc = bmat.reshape(bsz, nc, chunk, n).transpose(0, 1)           # nc,B,C,N
    cc = cmat.reshape(bsz, nc, chunk, n).transpose(0, 1)
    dtc = dt.reshape(bsz, nc, chunk, h).permute(1, 0, 3, 2)        # nc,B,h,C
    lac = loga.reshape(bsz, nc, chunk, h).permute(1, 0, 3, 2)      # nc,B,h,C

    ca = torch.cumsum(lac, dim=-1)                 # (nc,B,h,C)
    a_end = torch.exp(ca[..., -1:])                # (nc,B,h,1)

    # intra-chunk: P[t,s] = exp(ca_t - ca_s) (C_t·B_s) dt_s, s <= t
    rel = ca[..., :, None] - ca[..., None, :]      # (nc,B,h,C,C)
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xh.device))
    # mask BEFORE exp: upper-triangle rel > 0 overflows to inf
    gamma = torch.exp(torch.where(tril, rel, -1e30))
    cb = torch.einsum("nbtN,nbsN->nbts", cc, bc)   # (nc,B,C,C)
    pm = gamma * cb[:, :, None, :, :] * dtc[..., None, :]
    y_intra = torch.einsum("nbhts,nbhsp->nbhtp", pm, xc)

    # cross-chunk state scan
    # contribution into state: sum_s exp(ca_C - ca_s) dt_s x_s B_s^T
    w_in = torch.exp(ca[..., -1:] - ca) * dtc      # (nc,B,h,C)
    dstate = torch.einsum("nbhcp,nbcN->nbhpN", w_in[..., None] * xc, bc)

    hst = state.to(xh.dtype)
    y_cross = []
    for i in range(nc):
        # y_cross_t = exp(ca_t) C_t · h_in
        y_cross.append(torch.exp(ca[i])[..., None]
                       * torch.einsum("bhpN,bcN->bhcp", hst, cc[i]))
        hst = a_end[i][..., None] * hst + dstate[i]
    y = y_intra + torch.stack(y_cross)             # (nc,B,h,C,P)
    y = y.permute(1, 0, 3, 2, 4).reshape(bsz, s, h, ph)
    y = y + p.d_skip[None, None, :, None] * xh     # skip connection
    return y, hst


def mamba2_core_scan(p: Mamba2, cfg, xbc_act, dt_raw, state):
    """Oracle: step-by-step recurrence."""
    xh, bmat, cmat, dt, loga = _ssm_inputs(p, cfg, xbc_act, dt_raw)
    hst = state.to(xh.dtype)
    ys = []
    for t in range(xh.shape[1]):
        hst = torch.exp(loga[:, t])[..., None, None] * hst + \
            dt[:, t][..., None, None] * xh[:, t][..., :, None] \
            * bmat[:, t][:, None, None, :]
        ys.append(torch.einsum("bhpN,bN->bhp", hst, cmat[:, t]))
    y = torch.stack(ys, dim=1)
    y = y + p.d_skip[None, None, :, None] * xh
    return y, hst


def _columns(cfg, j: int, m: int, device):
    """The columns of ``in_proj`` and the channels of the conv that rank
    ``j`` of ``m`` computes under a split of the heads: z and x by its
    d_inner chunk, B and C whole (every head reads them), dt by its heads.
    ``in_proj``'s storage chunk does not line up with these parts."""
    di, n, h = cfg.mamba_d_inner, cfg.ssm_state, cfg.mamba_heads
    dl, hl = di // m, h // m

    def span(lo, size):
        return torch.arange(lo, lo + size, device=device)

    cols = torch.cat([span(j * dl, dl), span(di + j * dl, dl),
                      span(2 * di, 2 * n), span(2 * di + 2 * n + j * hl, hl)])
    chans = torch.cat([span(j * dl, dl), span(di, 2 * n)])
    return cols, chans


class _Local:
    """A Mamba2 block's weights as this rank computes with them: every
    head's outside a split of the heads over ``model``; under one
    (``tp.split``, the split step) its heads' (``in_proj`` and the conv
    gathered whole, their gradients summed over ``model``, then cut part
    by part by ``_columns``; ``norm`` and ``out_proj`` its d_inner
    chunk).  The cores take it in the block's place."""

    def __init__(self, p: Mamba2, cfg, device):
        self.split = tp.split(HEADS, cfg.mamba_heads)
        take = tp.take
        if not self.split:
            self.j, self.m = 0, 1
            for name in MAMBA2_NAMES:
                setattr(self, name, take(getattr(p, name)))
            return
        self.j, self.m = tp.model_rank()
        cols, self.chans = _columns(cfg, self.j, self.m, device)
        self.in_proj = take(p.in_proj, partial=True).index_select(1, cols)
        self.conv_w = take(p.conv_w, partial=True).index_select(
            1, self.chans)
        self.conv_b = take(p.conv_b, partial=True).index_select(
            0, self.chans)
        for name in ("a_log", "dt_bias", "d_skip", "norm", "out_proj"):
            setattr(self, name, take(getattr(p, name), 0))

    def state_in(self, state):
        """This rank's heads of a whole (B, H, P, N) state."""
        if state is None or not self.split:
            return state
        hl = state.shape[1] // self.m
        return state.narrow(1, self.j * hl, hl)

    def tail_in(self, tail):
        """This rank's channels of a whole (B, W-1, d_inner + 2N) tail."""
        if tail is None or not self.split:
            return tail
        return tail.index_select(-1, self.chans)

    def whole(self, state, tail, cfg):
        """Under a split, the new state and conv tail whole again (every
        rank holds B's and C's channels of the tail whole)."""
        dl = cfg.mamba_d_inner // self.m
        xs = tp.gather_model(tail[..., :dl], -1)
        return tp.gather_model(state, 1), torch.cat([xs, tail[..., dl:]],
                                                    dim=-1)


def _gated_norm(y, z, weight, d_inner: int, split: bool, eps: float = 1e-6):
    """``rms_norm(y * silu(z), weight)`` over the whole d_inner: under a
    split of the heads, y, z and weight hold this rank's chunk, and the sum
    of squares is summed over ``model`` and divided by the whole width."""
    g = y * F.silu(z)
    if not split:
        return rms_norm(g, weight, eps)
    gf = g.to(island_dtype(g.dtype))
    var = tp.sum_over((gf * gf).sum(dim=-1, keepdim=True)) / d_inner
    return (gf * torch.rsqrt(var + eps)).to(g.dtype) * weight


def mamba2_apply(p: Mamba2, cfg, x, state=None, conv_tail=None,
                 use_scan: bool = False, chunk: int = 64):
    """Full block. x: (B,S,d). Returns (out, new_state, new_conv_tail).
    The scan runs when asked or when S is not a multiple of ``chunk``
    (decode, unaligned prompts), the reference's rule.

    With the heads split over ``model`` (the split step) the rank computes
    its heads (``_Local``): the input enters once (``copy_in``), the cores
    run on H / model heads, the gated norm sums its squares over
    ``model`` and ``out_proj``'s row-parallel product ends in one
    all-reduce.  A given ``state`` and ``conv_tail`` are whole, and so are
    the new ones; without them the new ones are this rank's."""
    bsz, s, _ = x.shape
    di, n, h = cfg.mamba_d_inner, cfg.ssm_state, cfg.mamba_heads
    w = _Local(p, cfg, x.device)
    given = state is not None or conv_tail is not None
    state, conv_tail = w.state_in(state), w.tail_in(conv_tail)
    if state is None:
        state = torch.zeros((bsz, h // w.m, di // h, n), dtype=torch.float32,
                            device=x.device)
    if w.split:
        x = tp.copy_in(x)
    zxbcdt = x @ w.in_proj
    z, xbc, dt_raw = _split_proj(cfg, zxbcdt, w.m)
    xbc_act, new_tail = _causal_conv(xbc, w.conv_w, w.conv_b, conv_tail)
    if use_scan or s % chunk:
        y, state_f = mamba2_core_scan(w, cfg, xbc_act, dt_raw, state)
    else:
        y, state_f = mamba2_core_chunked(w, cfg, xbc_act, dt_raw, state,
                                         chunk)
    y = y.reshape(bsz, s, di // w.m).to(x.dtype)
    y = _gated_norm(y, z, w.norm, di, w.split)
    out = y @ w.out_proj
    if w.split:
        out = tp.reduce_out(out)
        if given:
            state_f, new_tail = w.whole(state_f, new_tail, cfg)
    return out, state_f, new_tail
