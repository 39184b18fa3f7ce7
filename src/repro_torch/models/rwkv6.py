"""RWKV-6 "Finch" — attention-free time mixing with data-dependent decay.

Recurrence (per head, state S in R^{dk x dv}):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    o_t = r_t^T S_{t-1} + (u ⊙ r_t)·k_t  v_t
with w_t = exp(-exp(decay_t)) data-dependent (LoRA on the shifted input).

Two equivalent evaluation paths:
  * ``rwkv_mix_scan``    — the recurrence step by step (the oracle; decode
    runs it, one step per token),
  * ``rwkv_mix_chunked`` — the chunkwise-parallel form through the ``wkv``
    kernel (``kernels/wkv``), where the reference computes the same chunked
    form in plain jnp.

The time mix and the channel mix are ``nn.Module``s holding the reference's
parameter names and layouts; ``models/convert.py`` loads a reference tree.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distribution import tensor_parallel as tp
from repro_torch.kernels.wkv import ops as wkv_ops
from repro_torch.models.common import (
    EMBED, FFN, HEADS, dense_init, frozen_param, island_dtype, rms_norm,
)

TMIX_NAMES = ("mix_r", "mix_k", "mix_v", "mix_g", "mix_w", "wr", "wk", "wv",
              "wg", "wd1", "wd2", "decay_base", "bonus_u", "wo", "ln_x")
CMIX_NAMES = ("mix_k", "mix_r", "wk", "wv", "wr")


class RWKVTimeMix(nn.Module):
    """mix_* (d,), wr/wk/wv/wg/wo (d, d), wd1 (d, lora), wd2 (lora, d),
    decay_base (d,) fp32, bonus_u (h, hd) fp32, ln_x (d,)."""

    def __init__(self, **weights):
        super().__init__()
        if set(weights) != set(TMIX_NAMES):
            raise ValueError(f"time mix weights {sorted(weights)}")
        for name in TMIX_NAMES:
            setattr(self, name, frozen_param(weights[name]))


class RWKVChannelMix(nn.Module):
    """mix_k, mix_r (d,), wk (d, d_ff), wv (d_ff, d), wr (d, d)."""

    def __init__(self, **weights):
        super().__init__()
        if set(weights) != set(CMIX_NAMES):
            raise ValueError(f"channel mix weights {sorted(weights)}")
        for name in CMIX_NAMES:
            setattr(self, name, frozen_param(weights[name]))


def rwkv_block_init(generator: torch.Generator, cfg, dtype,
                    device=None) -> RWKVTimeMix:
    d = cfg.d_model
    h = cfg.rwkv_heads
    hd = d // h
    lora = cfg.rwkv_decay_lora

    def full(shape, value, dt=dtype):
        return torch.full(shape, value, dtype=dt, device=device)

    def dense(i, o, **kw):
        return dense_init(generator, i, o, dtype, device=device, **kw)

    return RWKVTimeMix(
        # token-shift mix coefficients (static lerp per projection)
        mix_r=full((d,), 0.5), mix_k=full((d,), 0.5), mix_v=full((d,), 0.5),
        mix_g=full((d,), 0.5), mix_w=full((d,), 0.5),
        wr=dense(d, d), wk=dense(d, d), wv=dense(d, d), wg=dense(d, d),
        # data-dependent decay LoRA: d -> lora -> d
        wd1=dense(d, lora), wd2=dense(lora, d, scale=0.01),
        decay_base=full((d,), -6.0, torch.float32),
        bonus_u=full((h, hd), 0.5, torch.float32),
        wo=dense(d, d),
        ln_x=full((d,), 1.0),   # per-head group norm weight
    )


def rwkv_block_specs(cfg):
    return {
        "mix_r": (EMBED,), "mix_k": (EMBED,), "mix_v": (EMBED,),
        "mix_g": (EMBED,), "mix_w": (EMBED,),
        "wr": (EMBED, FFN), "wk": (EMBED, FFN), "wv": (EMBED, FFN),
        "wg": (EMBED, FFN),
        "wd1": (EMBED, None), "wd2": (None, FFN),
        "decay_base": (None,), "bonus_u": (HEADS, None),
        "wo": (FFN, EMBED), "ln_x": (EMBED,),
    }


def _token_shift(x, x_prev):
    """x_{t-1} with x_prev filling t=0.

    x_prev state is carried fp32 (decode caches); cast to the compute dtype
    so bf16 models stay bf16 through the mix projections."""
    return torch.cat([x_prev[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def _split_of(p: RWKVTimeMix) -> tuple[bool, bool]:
    """(columns, heads): whether the time mix splits ``wr``'s d columns and
    its heads over ``model`` (``tp.split``).  Heads split: each rank
    computes its own heads end to end.  Columns alone (heads that do not
    divide ``model``, rwkv6-3b's 40 on 16): the projections stay
    column-parallel, r, k, v and w are gathered to whole heads for the WKV
    and the group norm, and the rank keeps its columns after them."""
    cols = tp.split(FFN, tp.full_size(p.wr, 1))
    return cols, cols and tp.split(HEADS, tp.full_size(p.bonus_u, 0))


def _projections(p: RWKVTimeMix, cfg, x, x_prev):
    """r, k, v, g and w; with the columns split over ``model`` (the split
    step) this rank's columns of each: ``wr``/``wk``/``wv``/``wg`` and
    ``wd2`` column-parallel, the input entering once (``copy_in``) and
    the weights every rank uses whole (the mixes, ``wd1``) taken
    ``partial``."""
    cols, _ = _split_of(p)
    if cols:
        x, x_prev = tp.copy_in(x), tp.copy_in(x_prev)
    xs = _token_shift(x, x_prev)

    def cw(t, dim):
        return tp.take(t, dim if cols else None)

    def mix(m):
        m = tp.take(m, partial=cols)
        return x * m + xs * (1.0 - m)

    r = mix(p.mix_r) @ cw(p.wr, 1)
    k = mix(p.mix_k) @ cw(p.wk, 1)
    v = mix(p.mix_v) @ cw(p.wv, 1)
    g = mix(p.mix_g) @ cw(p.wg, 1)
    dec = cw(p.decay_base, 0) + (torch.tanh(mix(p.mix_w) @ tp.take(
        p.wd1, partial=cols)) @ cw(p.wd2, 1)).to(island_dtype(x.dtype))
    w = torch.exp(-torch.exp(dec))  # decay in (0, 1), fp32
    return r, k, v, g, w


def _split_heads(t, hd):
    b, s, d = t.shape
    return t.reshape(b, s, d // hd, hd)


def _heads(p: RWKVTimeMix, cfg, x, x_prev, cast: bool = True):
    """r, k, v (B, S, h, hd) fp32 (float64 in a float64 model; in the
    model's dtype with ``cast`` False), w (B, S, h, hd) fp32 and the gate g: every head, or this
    rank's where the heads split over ``model`` (g: its columns wherever
    the columns split)."""
    hd = cfg.d_model // cfg.rwkv_heads
    r, k, v, g, w = _projections(p, cfg, x, x_prev)
    cols, heads = _split_of(p)
    if cols and not heads:
        r, k, v, w = (tp.gather_model(t, -1) for t in (r, k, v, w))
    rh, kh, vh = (_split_heads(t, hd) for t in (r, k, v))
    if cast:
        rh, kh, vh = (t.to(island_dtype(t.dtype)) for t in (rh, kh, vh))
    return rh, kh, vh, _split_heads(w, hd), g


def _gate_out(p: RWKVTimeMix, x, o, g):
    """Per-head group norm, then the output gate and projection.  With the
    columns split over ``model``: on this rank's columns (its heads, or
    its columns of every head's normed output), ``wo`` row-parallel and
    one all-reduce."""
    b, s, _ = x.shape
    hd = o.shape[-1]
    cols, heads = _split_of(p)
    o = rms_norm(o, torch.ones((hd,), dtype=o.dtype, device=o.device)) \
        .reshape(b, s, -1).to(x.dtype)
    if cols and not heads:
        o = tp.split_in(o, -1)
    o = o * tp.take(p.ln_x, 0 if cols else None)
    o = o * F.silu(g)
    out = o @ tp.take(p.wo, 0 if cols else None)
    return tp.reduce_out(out) if cols else out


def _state_in(p: RWKVTimeMix, cfg, x, state):
    """The WKV state of the heads this rank computes: zeros for ``state``
    None, else its heads of the whole (B, h, dk, dv) ``state``."""
    heads = _split_of(p)[1]
    if state is None:
        h, hd = cfg.rwkv_heads, cfg.d_model // cfg.rwkv_heads
        if heads:
            h //= tp.model_rank()[1]
        return torch.zeros((x.shape[0], h, hd, hd), dtype=torch.float32,
                           device=x.device)
    if heads:
        j, m = tp.model_rank()
        hl = state.shape[1] // m
        state = state.narrow(1, j * hl, hl)
    return state


def _state_out(p: RWKVTimeMix, state, given: bool):
    """The new state, whole over the heads where a state was given (so a
    cache stays whole under a split step), else as this rank computed
    it."""
    if given and _split_of(p)[1]:
        return tp.gather_model(state, 1)
    return state


def _bonus(p: RWKVTimeMix):
    """``bonus_u`` of the heads this rank computes."""
    return tp.take(p.bonus_u, 0 if _split_of(p)[1] else None)


def rwkv_mix_chunked(p: RWKVTimeMix, cfg, x, x_prev, state, chunk: int = 64):
    """Chunkwise-parallel WKV through the kernel.  x: (B,S,d); state:
    (B,h,dk,dv) carried in, or None for zeros.  Returns (out, last_x,
    new_state); new_state is whole where a state was given.

    r, k, v go in uncast, in the model's dtype (the kernel reads bf16 in
    place, and its fp32 arithmetic sees the values the reference's cast
    gives); o comes back fp32, as the reference computes it, and is first
    rounded after the group norm.  Where the heads split over ``model``
    the kernel runs on this rank's heads."""
    rh, kh, vh, wh, g = _heads(p, cfg, x, x_prev, cast=False)
    s_in = _state_in(p, cfg, x, state)
    o, state_f = wkv_ops.wkv_chunked(rh, kh, vh, wh, _bonus(p), s_in,
                                     chunk=chunk,
                                     interpret=cfg.pallas_interpret,
                                     out_dtype=torch.float32)
    out = _gate_out(p, x, o, g)
    return out, x[:, -1, :].to(torch.float32), \
        _state_out(p, state_f.to(s_in.dtype), state is not None)


def rwkv_mix_scan(p: RWKVTimeMix, cfg, x, x_prev, state):
    """Oracle: the recurrence step by step (``state`` as
    ``rwkv_mix_chunked`` takes it)."""
    rh, kh, vh, wh, g = _heads(p, cfg, x, x_prev)
    u = _bonus(p)
    s_in = _state_in(p, cfg, x, state)
    S = s_in.to(rh.dtype)
    outs = []
    for t in range(x.shape[1]):
        r_t, k_t, v_t, w_t = rh[:, t], kh[:, t], vh[:, t], wh[:, t]
        o_t = torch.einsum("bhk,bhkv->bhv", r_t, S) + \
            (r_t * u[None] * k_t).sum(-1, keepdim=True) * v_t
        S = w_t[..., None] * S + k_t[..., None] * v_t[..., None, :]
        outs.append(o_t)
    o = torch.stack(outs, dim=1)
    out = _gate_out(p, x, o, g)
    return out, x[:, -1, :].to(torch.float32), \
        _state_out(p, S.to(s_in.dtype), state is not None)


# -- channel mix (RWKV FFN) --------------------------------------------------


def rwkv_cmix_init(generator: torch.Generator, cfg, dtype,
                   device=None) -> RWKVChannelMix:
    d, f = cfg.d_model, cfg.d_ff

    def half():
        return torch.full((d,), 0.5, dtype=dtype, device=device)

    return RWKVChannelMix(
        mix_k=half(), mix_r=half(),
        wk=dense_init(generator, d, f, dtype, device=device),
        wv=dense_init(generator, f, d, dtype, device=device),
        wr=dense_init(generator, d, d, dtype, device=device))


def rwkv_cmix_specs(cfg):
    return {
        "mix_k": (EMBED,), "mix_r": (EMBED,),
        "wk": (EMBED, FFN), "wv": (FFN, EMBED), "wr": (EMBED, None),
    }


def rwkv_cmix_apply(p: RWKVChannelMix, cfg, x, x_prev):
    """With ``ffn`` split over ``model`` (the split step): ``wk``
    column-parallel, ``wv`` row-parallel and one all-reduce; ``wr``
    (``(EMBED, None)``) whole on every rank."""
    xs = _token_shift(x, x_prev)
    xk = x * p.mix_k + xs * (1.0 - p.mix_k)
    xr = x * p.mix_r + xs * (1.0 - p.mix_r)
    if tp.split(FFN, tp.full_size(p.wk, 1)):
        kk = torch.square(torch.relu(tp.copy_in(xk) @ tp.take(p.wk, 1)))
        vv = tp.reduce_out(kk @ tp.take(p.wv, 0))
    else:
        kk = torch.square(torch.relu(xk @ tp.take(p.wk)))
        vv = kk @ tp.take(p.wv)
    rr = torch.sigmoid(xr @ tp.take(p.wr))
    return rr * vv, x[:, -1, :].to(torch.float32)
