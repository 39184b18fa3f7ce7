"""GQA attention (RoPE, optional qk-norm) for full-sequence passes and for
decode against a KV cache.

The plain path is *q-chunked*: query blocks of ``_Q_CHUNK`` rows, each with
a mask built from positions, so no (S, T) probability matrix is ever whole.
The causal score space is the paper's 2D lower-triangular domain;
``cfg.attn_impl`` selects:
  * "xla"           — the plain chunked torch attention (``_sdpa``),
  * "pallas_mapped" — the CUDA tri_attn kernel, mapped λ grid (paper),
  * "pallas_bb"     — the CUDA tri_attn kernel, bounding-box grid
                      (paper baseline).
The kernel is reached only by a cache-less causal pass (``forward``):
prefill, decode and cross-attention (``cross_kv``: k and v projected from
encoder or vision states, no RoPE, no mask, no cache) go through ``_sdpa``,
as in the reference.

Caches are updated in place (the reference returns new arrays); the cache
dict's ``idx`` is a Python int.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.common import dense_init, frozen_param, rms_norm, rope

NEG_INF = -1e30
_Q_CHUNK = 256

UNPORTED_MLA = ("MLA attention (deepseek-v2) is not ported yet: ROADMAP "
                "queue 1 item 8c (other model families: MLA)")
UNPORTED_XLA_MAPPED = ("attn_impl='xla_mapped' (the dry-run's mapped XLA "
                       "attention) is not ported yet: ROADMAP queue 1 item 10 "
                       "(launch and analysis tooling)")


def _sdpa(q, k, v, n_kv_heads: int, q_pos=None, chunk: int = _Q_CHUNK,
          logit_dim: int | None = None):
    """Grouped SDPA, fp32 softmax, q-chunked.

    q: (B, S, H, D); k, v: (B, T, Hk, D).
    q_pos: (B, S) absolute positions — causal mask "kv_index <= q_pos";
           None => no mask (cross / bidirectional attention).
    logit_dim: scale denominator (defaults to D).
    """
    b, s, h, d = q.shape
    t = k.shape[1]
    dv = v.shape[-1]
    g = h // n_kv_heads
    scale = (logit_dim or d) ** -0.5
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    kv_idx = torch.arange(t, device=q.device)

    def block(q_blk, pos_blk):
        qg = q_blk.reshape(b, -1, n_kv_heads, g, d).to(torch.float32)
        logits = torch.einsum("bskgd,btkd->bkgst", qg, kf) * scale
        if pos_blk is not None:
            mask = kv_idx[None, :] <= pos_blk[..., None]      # (B, C, T)
            logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bkgst,btkd->bskgd", probs, vf)
        return out.reshape(b, -1, h, dv).to(q.dtype)

    if s <= chunk or s % chunk != 0:
        return block(q, q_pos)
    return torch.cat([
        block(q[:, c:c + chunk], None if q_pos is None else q_pos[:, c:c + chunk])
        for c in range(0, s, chunk)], dim=1)


def _sdpa_mapped_causal(q, k, v, n_kv_heads, chunk: int = _Q_CHUNK):
    raise NotImplementedError(UNPORTED_XLA_MAPPED)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------


class GQAAttention(nn.Module):
    """wq (d, H, hd), wk / wv (d, Hk, hd), wo (H·hd, d); q_norm / k_norm
    (hd,) with qk-norm."""

    def __init__(self, wq, wk, wv, wo, q_norm=None, k_norm=None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = (frozen_param(w)
                                              for w in (wq, wk, wv, wo))
        self.q_norm = None if q_norm is None else frozen_param(q_norm)
        self.k_norm = None if k_norm is None else frozen_param(k_norm)


def gqa_init(generator: torch.Generator, cfg, dtype, device=None) -> GQAAttention:
    d, h, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    norms = {}
    if cfg.qk_norm:
        norms = {"q_norm": torch.ones(hd, dtype=dtype, device=device),
                 "k_norm": torch.ones(hd, dtype=dtype, device=device)}
    return GQAAttention(
        dense_init(generator, d, (h, hd), dtype, device=device),
        dense_init(generator, d, (hk, hd), dtype, device=device),
        dense_init(generator, d, (hk, hd), dtype, device=device),
        dense_init(generator, h * hd, d, dtype, device=device), **norms)


def heads(x, w, n_heads: int, head_dim: int):
    """(B, T, d) @ w (d, n_heads, head_dim) -> (B, T, n_heads, head_dim)."""
    b, t, d = x.shape
    return (x @ w.reshape(d, n_heads * head_dim)).view(b, t, n_heads,
                                                       head_dim)


def _pallas_causal(q, k, v, grid_mode: str, block: int, interpret: bool):
    from repro_torch.kernels.tri_attn.ops import causal_attention

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))   # -> (B, H, S, D)
    out = causal_attention(qt, kt, vt, block, block, grid_mode, interpret)
    return out.transpose(1, 2)


def gqa_apply(p: GQAAttention, cfg, x, *, positions=None, cache=None,
              cross_kv=None):
    """Returns (out, new_cache). x: (B, S, d); cross_kv: (B, T, d) states
    that k and v are projected from (cross-attention: no cache)."""
    b, s, _ = x.shape
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = heads(x, p.wq, h, hd)
    src = x if cross_kv is None else cross_kv
    k, v = heads(src, p.wk, hk, hd), heads(src, p.wv, hk, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm)
        k = rms_norm(k, p.k_norm)
    if cross_kv is not None:               # rectangular box domain, no mask
        out = _sdpa(q, k, v, hk, None)
        return out.reshape(b, s, h * hd) @ p.wo, None
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    positions = torch.as_tensor(positions, device=x.device).expand(b, s)
    if cfg.rope_theta:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:                  # decode/prefill against cache
        idx = cache["idx"]
        new_cache = {
            **_cache_put(cache, "k", k, idx),
            **_cache_put(cache, "v", v, idx),
            "idx": idx + s,
        }
        k = _cache_get(new_cache, "k", x.dtype)
        v = _cache_get(new_cache, "v", x.dtype)

    if (cache is None and cfg.attn_impl in ("pallas_mapped", "pallas_bb")
            and s % cfg.attn_block == 0 and s >= cfg.attn_block):
        grid_mode = ("mapped" if cfg.attn_impl == "pallas_mapped"
                     else "bounding_box")
        # the kernel reads each kv head in place: no repeat for GQA
        out = _pallas_causal(q, k, v, grid_mode, cfg.attn_block,
                             cfg.pallas_interpret)
    elif (cache is None and cfg.attn_impl == "xla_mapped"
            and s % _Q_CHUNK == 0 and s > _Q_CHUNK):
        out = _sdpa_mapped_causal(q, k, v, hk, _Q_CHUNK)
    else:
        out = _sdpa(q, k, v, hk, positions)
    y = out.reshape(b, s, h * hd) @ p.wo
    return y, new_cache


def _quantize_rows(t):
    """absmax int8 quantization over the last dim: (values, scales)."""
    tf = t.to(torch.float32)
    scale = tf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(scale, min=1e-8) / 127.0
    q = torch.round(tf / scale).to(torch.int8)
    return q, scale


def _cache_put(cache, key, val, idx: int):
    """Write ``val`` at position idx, in place, quantizing when the cache is
    int8; returns the written entries."""
    store = cache[key]
    s = val.shape[1]
    if store.dtype == torch.int8:
        q, scale = _quantize_rows(val)
        store[:, idx:idx + s] = q
        cache[key + "_scale"][:, idx:idx + s] = scale
        return {key: store, key + "_scale": cache[key + "_scale"]}
    store[:, idx:idx + s] = val.to(store.dtype)
    return {key: store}


def _cache_get(entries, key, dtype):
    """Read (dequantize if int8) a cache tensor."""
    t = entries[key]
    if t.dtype == torch.int8:
        return (t.to(torch.float32) * entries[key + "_scale"]).to(dtype)
    return t


def gqa_cache_init(cfg, batch: int, max_seq: int, dtype, device=None):
    hk, hd = cfg.n_kv_heads, cfg.head_dim
    shape = (batch, max_seq, hk, hd)
    if cfg.kv_cache_quant:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros((*shape[:3], 1), dtype=torch.float32,
                                   device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "v_scale": torch.zeros((*shape[:3], 1), dtype=torch.float32,
                                   device=device),
            "idx": 0,
        }
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "idx": 0,
    }


# ---------------------------------------------------------------------------
# MLA (deepseek-v2)
# ---------------------------------------------------------------------------


def mla_init(generator, cfg, dtype, device=None):
    raise NotImplementedError(UNPORTED_MLA)


def mla_apply(p, cfg, x, *, positions=None, cache=None, cross_kv=None):
    raise NotImplementedError(UNPORTED_MLA)


def mla_cache_init(cfg, batch: int, max_seq: int, dtype, device=None):
    raise NotImplementedError(UNPORTED_MLA)
