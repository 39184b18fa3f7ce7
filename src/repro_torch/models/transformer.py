"""The decoder-only LM: the ``dense`` family (GQA + SwiGLU MLP) and the
``ssm`` family (the RWKV-6 stack: time mix + channel mix).

The public API mirrors the reference's: ``init_params`` / ``forward``
(teacher-forced logits) / ``init_cache`` / ``prefill`` / ``decode_step``.
Parameters are a ``DenseLM`` or an ``RWKVLM`` module whose layers are an
``nn.ModuleList`` walked by a loop (the reference scans stacked parameters);
the weights keep the reference's layouts (``models/convert.py`` loads a
reference tree).  An RWKV layer runs the chunked WKV, and so the ``wkv``
kernel, when the sequence is a multiple of 64, and the step-by-step scan
otherwise (decode), the reference's rule.  Passes that ask for no gradient
run under ``torch.inference_mode()``; there is no remat.  Other families
raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import rwkv6 as rwkv
from repro_torch.models.common import (
    dense_init, embed_init, frozen_param, rms_norm, swiglu,
)

PORTED_FAMILIES = ("dense", "ssm")
UNPORTED_FAMILIES = {
    "moe": "ROADMAP queue 1 item 8 (other model families): MoE with MLA",
    "hybrid": "ROADMAP queue 1 item 8 (other model families): Mamba2 / "
              "zamba2",
    "vlm": "ROADMAP queue 1 item 7 (LM engine, the rest)",
    "audio": "ROADMAP queue 1 item 7 (LM engine, the rest)",
}
#: an RWKV layer takes the chunked WKV when the sequence is a multiple of
#: this, and the scan otherwise (reference ``transformer.py:261``)
RWKV_CHUNK = 64


def require_ported(cfg) -> None:
    """Raise NotImplementedError for what this port does not run yet."""
    if cfg.family not in PORTED_FAMILIES:
        where = UNPORTED_FAMILIES.get(cfg.family, "no ROADMAP item")
        raise NotImplementedError(
            f"{cfg.arch_id}: the {cfg.family!r} family is not ported yet: "
            f"{where}")
    if cfg.family == "dense" and cfg.attention_type != "gqa":
        raise NotImplementedError(f"{cfg.arch_id}: {attn.UNPORTED_MLA}")


def _dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class SwiGLU(nn.Module):
    """gate / up (d, d_ff), down (d_ff, d)."""

    def __init__(self, gate, up, down):
        super().__init__()
        self.gate, self.up, self.down = (frozen_param(w)
                                         for w in (gate, up, down))


class DecoderLayer(nn.Module):
    def __init__(self, ln1, ln2, attn_p: attn.GQAAttention, mlp: SwiGLU):
        super().__init__()
        self.ln1, self.ln2 = frozen_param(ln1), frozen_param(ln2)
        self.attn = attn_p
        self.mlp = mlp


class DenseLM(nn.Module):
    """embed (V, d), final_norm (d,), lm_head (d, V) unless the embedding is
    tied, and the decoder layers."""

    def __init__(self, cfg, embed, final_norm, layers, lm_head=None):
        super().__init__()
        self.cfg = cfg
        self.embed = frozen_param(embed)
        self.final_norm = frozen_param(final_norm)
        self.lm_head = None if lm_head is None else frozen_param(lm_head)
        self.layers = nn.ModuleList(layers)

    def forward(self, tokens, positions=None):
        return forward(self, self.cfg, tokens, positions=positions)


def _no_grad_unless_asked(params) -> contextlib.AbstractContextManager:
    if torch.is_grad_enabled() and any(p.requires_grad
                                       for p in params.parameters()):
        return contextlib.nullcontext()
    return torch.inference_mode()


def _device(params) -> torch.device:
    return params.embed.device


def _layer_apply(p: DecoderLayer, cfg, x, *, positions=None, cache=None):
    h, new_cache = attn.gqa_apply(p.attn, cfg, rms_norm(x, p.ln1),
                                  positions=positions, cache=cache)
    x = x + h
    x = x + swiglu(rms_norm(x, p.ln2), p.mlp.gate, p.mlp.up, p.mlp.down)
    return x, new_cache


def _decoder_stack(params: DenseLM, cfg, x, *, positions=None, caches=None):
    """Loop over the layers; caches is a list of per-layer caches or None."""
    new_caches = None if caches is None else []
    for i, lp in enumerate(params.layers):
        x, c = _layer_apply(lp, cfg, x, positions=positions,
                            cache=None if caches is None else caches[i])
        if new_caches is not None:
            new_caches.append(c)
    return x, new_caches


def _logits(params, cfg, h):
    """fp32 logits, as the reference's fp32-accumulating product gives."""
    h = rms_norm(h, params.final_norm)
    w = params.embed.T if cfg.tie_embeddings else params.lm_head
    return h.to(torch.float32) @ w.to(torch.float32)


def _embed(params, cfg, tokens):
    return params.embed[tokens]


def _tokens(params, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, dtype=torch.int64, device=_device(params))


# ===========================================================================
# RWKV6 (ssm)
# ===========================================================================


class RWKVLayer(nn.Module):
    def __init__(self, ln1, ln2, tmix: rwkv.RWKVTimeMix,
                 cmix: rwkv.RWKVChannelMix):
        super().__init__()
        self.ln1, self.ln2 = frozen_param(ln1), frozen_param(ln2)
        self.tmix = tmix
        self.cmix = cmix


class RWKVLM(nn.Module):
    """embed (V, d), final_norm (d,), lm_head (d, V) and the RWKV layers."""

    def __init__(self, cfg, embed, final_norm, layers, lm_head):
        super().__init__()
        self.cfg = cfg
        self.embed = frozen_param(embed)
        self.final_norm = frozen_param(final_norm)
        self.lm_head = frozen_param(lm_head)
        self.layers = nn.ModuleList(layers)

    def forward(self, tokens, positions=None):
        return forward(self, self.cfg, tokens, positions=positions)


def _rwkv_layer_init(generator, cfg, dtype, device) -> RWKVLayer:
    def ones():
        return torch.ones(cfg.d_model, dtype=dtype, device=device)

    return RWKVLayer(ones(), ones(),
                     rwkv.rwkv_block_init(generator, cfg, dtype, device),
                     rwkv.rwkv_cmix_init(generator, cfg, dtype, device))


def _rwkv_layer_apply(p: RWKVLayer, cfg, x, state):
    """state: dict(tmix_x, cmix_x, wkv). Chunked when seq allows, else scan."""
    n1 = rms_norm(x, p.ln1)
    if x.shape[1] % RWKV_CHUNK:
        o, last_x, wkv = rwkv.rwkv_mix_scan(p.tmix, cfg, n1, state["tmix_x"],
                                            state["wkv"])
    else:
        o, last_x, wkv = rwkv.rwkv_mix_chunked(p.tmix, cfg, n1,
                                               state["tmix_x"], state["wkv"],
                                               chunk=RWKV_CHUNK)
    x = x + o
    o2, last_c = rwkv.rwkv_cmix_apply(p.cmix, cfg, rms_norm(x, p.ln2),
                                      state["cmix_x"])
    x = x + o2
    return x, {"tmix_x": last_x, "cmix_x": last_c, "wkv": wkv}


def _rwkv_zero_state(cfg, batch: int, device) -> dict:
    h = cfg.rwkv_heads
    hd = cfg.d_model // h

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {"tmix_x": zeros(batch, cfg.d_model),
            "cmix_x": zeros(batch, cfg.d_model),
            "wkv": zeros(batch, h, hd, hd)}


def _rwkv_stack(params: RWKVLM, cfg, x, caches=None):
    """Loop over the layers from ``caches`` (a list of per-layer states) or,
    without caches, from the zero state; returns (x, new states or None)."""
    zero = None if caches is not None else _rwkv_zero_state(
        cfg, x.shape[0], x.device)
    new_caches = None if caches is None else []
    for i, lp in enumerate(params.layers):
        x, st = _rwkv_layer_apply(lp, cfg, x,
                                  zero if caches is None else caches[i])
        if new_caches is not None:
            new_caches.append(st)
    return x, new_caches


def _stack(params, cfg, x, *, positions=None, caches=None):
    """The family's layer stack."""
    if cfg.family == "ssm":
        return _rwkv_stack(params, cfg, x, caches=caches)
    return _decoder_stack(params, cfg, x, positions=positions, caches=caches)


# ===========================================================================
# Public API
# ===========================================================================


def init_params(cfg, generator: torch.Generator | None = None,
                device="cuda") -> DenseLM | RWKVLM:
    """Random weights from ``generator`` (a fresh one seeded 0 if None),
    made on ``device``: the reference's distributions, not its numbers."""
    require_ported(cfg)
    dtype = _dtype(cfg)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    d = cfg.d_model

    def ones():
        return torch.ones(d, dtype=dtype, device=device)

    embed = embed_init(generator, cfg.padded_vocab, d, dtype, device=device)
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = dense_init(generator, d, cfg.padded_vocab, dtype,
                             device=device)
    if cfg.family == "ssm":
        layers = [_rwkv_layer_init(generator, cfg, dtype, device)
                  for _ in range(cfg.n_layers)]
        return RWKVLM(cfg, embed, ones(), layers, lm_head)
    layers = [
        DecoderLayer(
            ones(), ones(), attn.gqa_init(generator, cfg, dtype, device),
            SwiGLU(dense_init(generator, d, cfg.d_ff, dtype, device=device),
                   dense_init(generator, d, cfg.d_ff, dtype, device=device),
                   dense_init(generator, cfg.d_ff, d, dtype, device=device)))
        for _ in range(cfg.n_layers)]
    return DenseLM(cfg, embed, ones(), layers, lm_head)


def forward(params, cfg, tokens, extra=None, positions=None,
            with_aux: bool = False):
    """Teacher-forced logits (B, S, padded_vocab) fp32.

    with_aux=True returns (logits, moe_aux_loss) — aux is 0 for dense and
    ssm."""
    require_ported(cfg)
    with _no_grad_unless_asked(params):
        x = _embed(params, cfg, _tokens(params, tokens))
        x, _ = _stack(params, cfg, x, positions=positions)
        out = _logits(params, cfg, x)
    if with_aux:
        return out, torch.zeros((), dtype=torch.float32, device=out.device)
    return out


def init_cache(cfg, batch: int, max_seq: int, device="cuda"):
    """Per-layer caches: GQA k/v of ``max_seq`` rows (dense), or the RWKV
    state (ssm: tmix_x, cmix_x (B, d) and wkv (B, h, hd, hd), fp32, of no
    length)."""
    require_ported(cfg)
    if cfg.family == "ssm":
        return {"layers": [_rwkv_zero_state(cfg, batch, device)
                           for _ in range(cfg.n_layers)]}
    return {"layers": [attn.gqa_cache_init(cfg, batch, max_seq, _dtype(cfg),
                                           device)
                       for _ in range(cfg.n_layers)]}


def prefill(params, cfg, tokens, extra=None, cache=None):
    """Fill the cache with a teacher-forced pass; returns (logits, cache)."""
    require_ported(cfg)
    tokens = _tokens(params, tokens)
    b, s = tokens.shape
    if cache is None:
        cache = init_cache(cfg, b, cfg.max_seq, device=_device(params))
    with _no_grad_unless_asked(params):
        positions = torch.arange(s, device=tokens.device)[None, :]
        x = _embed(params, cfg, tokens)
        x, new_l = _stack(params, cfg, x, positions=positions,
                          caches=cache["layers"])
        return _logits(params, cfg, x), {"layers": new_l}


def decode_step(params, cfg, token, cache, extra=None):
    """token: (B, 1); one serving step against the cache."""
    require_ported(cfg)
    token = _tokens(params, token)
    b = token.shape[0]
    with _no_grad_unless_asked(params):
        positions = None
        if cfg.family != "ssm":
            idx = cache["layers"][0]["idx"]
            positions = torch.full((b, 1), idx, dtype=torch.int64,
                                   device=token.device)
        x = _embed(params, cfg, token)
        x, new_l = _stack(params, cfg, x, positions=positions,
                          caches=cache["layers"])
        return _logits(params, cfg, x), {"layers": new_l}
