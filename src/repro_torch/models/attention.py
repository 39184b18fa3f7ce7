"""GQA attention (RoPE, optional qk-norm) and MLA (deepseek-v2: low-rank
q and kv, a compressed cache, one RoPE key shared by every head) for
full-sequence passes and for decode against a cache.

The plain path is *q-chunked*: query blocks of ``_Q_CHUNK`` rows, each with
a mask built from positions, so no (S, T) probability matrix is ever whole.
The causal score space is the paper's 2D lower-triangular domain;
``cfg.attn_impl`` selects:
  * "xla"           — the plain chunked torch attention (``_sdpa``),
  * "pallas_mapped" — the CUDA tri_attn kernel, mapped λ grid (paper),
  * "pallas_bb"     — the CUDA tri_attn kernel, bounding-box grid
                      (paper baseline),
  * "xla_mapped"    — the mapped block-pair batch in plain torch
                      (``_sdpa_mapped_causal``; the reference's is plain XLA).
The kernel is reached only by a cache-less causal GQA pass (``forward``):
MLA (q·k over dn + dr = 192, v 128 wide), prefill, decode and
cross-attention (``cross_kv``: k and v projected from
encoder or vision states, no RoPE, no mask, no cache) go through ``_sdpa``,
as in the reference.

Caches are updated in place (the reference returns new arrays); the cache
dict's ``idx`` is a Python int.  In a split decode step whose caches are
this rank's blocks along ``kv_seq`` (``tp.seq_block``) every head attends
the rank's block (``_sdpa_block``, ``_mla_block``: a partial softmax), the
partials of the ranks holding the sequence are combined
(``combine_partials``) and the rank keeps its own heads; only the block
holding a new position writes it.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from repro_torch.distribution import tensor_parallel as tp
from repro_torch.models.common import (
    EMBED, HEAD_DIM, HEADS, KV_HEADS, dense_init, frozen_param, island_dtype,
    rms_norm, rope,
)

NEG_INF = -1e30
_Q_CHUNK = 256

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
    kf = k.to(island_dtype(k.dtype))
    vf = v.to(kf.dtype)
    kv_idx = torch.arange(t, device=q.device)

    def block(q_blk, pos_blk):
        qg = q_blk.reshape(b, -1, n_kv_heads, g, d).to(kf.dtype)
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


def _block_softmax(logits, valid):
    """The partial softmax of ``logits`` (..., t) over the positions
    ``valid`` marks (broadcast to it): (row max, sum of exps, exps), the
    exps exactly 0 where not valid.  A row with no valid position gives
    max ``NEG_INF``, sum 0 and no exp, so it adds nothing to a combine."""
    logits = logits.masked_fill(~valid, NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None]).masked_fill(~valid, 0.0)
    return m, p.sum(dim=-1), p


def combine_partials(m, l, o):
    """The attention output from the partial softmaxes of the blocks of one
    cache, stacked along dim 0: max m and sum l (n, B, S, H), unnormalised
    output o (n, B, S, H, D) -> (B, S, H, D).  Each block is rescaled to the
    global max; a block with no valid position (m = ``NEG_INF``, l = 0)
    adds exactly 0."""
    top = m.amax(dim=0)
    w = torch.exp(m - top)
    den = (l * w).sum(dim=0)
    return (o * w[..., None]).sum(dim=0) / torch.clamp(den, min=1e-30)[
        ..., None]


def _sdpa_block(q, k, v, n_kv_heads: int, q_pos, offset: int,
                logit_dim: int | None = None):
    """``_sdpa``'s partial softmax of every head of q (B, S, H, D) against
    a block of k, v (B, t, Hk, D) at global positions [offset, offset + t),
    causal against q_pos (B, S): (m, l, o) for ``combine_partials``, in
    the island dtype, m and l (B, S, H), o (B, S, H, Dv)."""
    b, s, h, d = q.shape
    t = k.shape[1]
    g = h // n_kv_heads
    scale = (logit_dim or d) ** -0.5
    kf = k.to(island_dtype(k.dtype))
    vf = v.to(kf.dtype)
    qg = q.reshape(b, s, n_kv_heads, g, d).to(kf.dtype)
    logits = torch.einsum("bskgd,btkd->bskgt", qg, kf) * scale
    kv_pos = offset + torch.arange(t, device=q.device)
    valid = kv_pos <= q_pos[:, :, None, None, None]          # (B, S, 1, 1, t)
    m, l, p = _block_softmax(logits, valid)
    o = torch.einsum("bskgt,btkd->bskgd", p, vf)
    return m.reshape(b, s, h), l.reshape(b, s, h), o.reshape(b, s, h, -1)


def _mla_block(q_abs, q_rope, ckv_n, krope, start: int, offset: int,
               logit_dim: int):
    """The absorbed MLA decode's partial softmax of every head against a
    block of the normed latent (B, t, kv_lora) and RoPE key (B, t, dr) at
    global positions [offset, offset + t), for queries at start + [0, S):
    (m, l, o_lat) for ``combine_partials``, fp32, o_lat (B, S, H, kv_lora)."""
    s, t = q_abs.shape[1], ckv_n.shape[1]
    cf = ckv_n.to(torch.float32)
    logits = (torch.einsum("bshl,btl->bsht", q_abs.to(torch.float32), cf)
              + torch.einsum("bshr,btr->bsht", q_rope.to(torch.float32),
                             krope.to(torch.float32))) * logit_dim ** -0.5
    dev = cf.device
    valid = (offset + torch.arange(t, device=dev)
             <= start + torch.arange(s, device=dev)[:, None, None])
    m, l, p = _block_softmax(logits, valid)                 # valid (S, 1, t)
    return m, l, torch.einsum("bsht,btl->bshl", p, cf)


def _over_blocks(part, blk):
    """The attention output (B, S, H, D) from this rank's partials
    ``part`` = (m, l, o) and those of every rank holding a block of the
    same cache (``blk``'s groups): one all-gather of O(B·S·H·D) per group,
    never of the cache."""
    m, l, o = part
    packed = torch.cat([m[..., None], l[..., None], o], dim=-1)
    every = tp.seq_stack(packed, blk)
    return combine_partials(every[..., 0], every[..., 1], every[..., 2:])


@functools.lru_cache(maxsize=None)
def _pair_tables(nb: int, chunk: int):
    """The static λ -> (i, j) tables of the T(nb) block pairs, i >= j, from
    the paper's inverse-triangular map in int64 numpy, and the (L, C, C)
    pair mask (causal on the diagonal pairs, open below).  The pair axis is
    padded to a multiple of 16 with fully masked pairs (0, 0), which add
    exactly zero."""
    npairs = nb * (nb + 1) // 2
    lam = np.arange(npairs, dtype=np.int64)
    i_np = (np.sqrt(8 * lam + 1).astype(np.int64) - 1) // 2
    i_np += ((i_np + 2) * (i_np + 1) // 2 <= lam)   # exactness correction
    j_np = lam - i_np * (i_np + 1) // 2
    diag_mask = np.tril(np.ones((chunk, chunk), bool))
    pair_mask = np.where((i_np == j_np)[:, None, None], diag_mask[None], True)
    pad = (-npairs) % 16
    if pad:
        i_np = np.concatenate([i_np, np.zeros(pad, np.int64)])
        j_np = np.concatenate([j_np, np.zeros(pad, np.int64)])
        pair_mask = np.concatenate(
            [pair_mask, np.zeros((pad, chunk, chunk), bool)], axis=0)
    return i_np, j_np, pair_mask


def _sdpa_mapped_causal(q, k, v, n_kv_heads, chunk: int = _Q_CHUNK):
    """Causal SDPA over the *mapped triangular block grid*, in plain torch
    (the reference's is plain XLA, so this is its port and no kernel's).

    The (q block i, k block j) pairs are enumerated linearly with the
    paper's inverse-triangular map; nb is static, so λ -> (i, j) is computed
    on the host (``_pair_tables``) and the pair axis is a batch dim with
    static gather indices: exactly T(nb) = nb(nb+1)/2 block pairs (no BB
    waste), padded to a multiple of 16.  Rows combine by a segment softmax
    over the static row ids: a segment max (``scatter_reduce`` "amax"),
    exps, segment sums (``index_add``).  Exact in fp32 and differentiable
    through autograd (the max is a constant shift, taken without gradient).

    Memory: the fp32 logits are (B, L, Hk, H/Hk, C, C).  At yi-6b's S 4096
    with chunk 256, T(16) = 136 pairs padded to 144: about 1.2 GB a layer
    at batch 1, and as much again for the exps.
    """
    b, s, h, d = q.shape
    dv = v.shape[-1]
    g = h // n_kv_heads
    scale = d ** -0.5
    nb = s // chunk
    assert s % chunk == 0
    i_np, j_np, mask_np = _pair_tables(nb, chunk)
    dev = q.device
    i_t = torch.from_numpy(i_np).to(dev)
    j_t = torch.from_numpy(j_np).to(dev)
    pair_mask = torch.from_numpy(mask_np).to(dev)
    npairs = i_t.shape[0]

    qp = q.reshape(b, nb, chunk, n_kv_heads, g, d).index_select(1, i_t)
    kp = k.reshape(b, nb, chunk, n_kv_heads, d).index_select(1, j_t)
    vp = v.reshape(b, nb, chunk, n_kv_heads, dv).index_select(1, j_t)
    logits = torch.einsum("blskgd,bltkd->blkgst", qp.to(torch.float32),
                          kp.to(torch.float32)) * scale   # (B,L,kv,g,C,C)
    logits = logits.masked_fill(~pair_mask[None, :, None, None], NEG_INF)

    m_pair = logits.detach().amax(dim=-1)            # (B, L, kv, g, C)
    seg = i_t.view(1, npairs, 1, 1, 1).expand_as(m_pair)
    m_row = m_pair.new_full((b, nb, n_kv_heads, g, chunk), NEG_INF) \
        .scatter_reduce(1, seg, m_pair, "amax", include_self=True)
    p = torch.exp(logits - m_row.index_select(1, i_t)[..., None])
    l_row = p.new_zeros((b, nb, n_kv_heads, g, chunk)).index_add(
        1, i_t, p.sum(dim=-1))
    o_pair = torch.einsum("blkgst,bltkd->blkgsd", p, vp.to(torch.float32))
    o_row = o_pair.new_zeros((b, nb, n_kv_heads, g, chunk, dv)).index_add(
        1, i_t, o_pair)                              # (B, nb, kv, g, C, dv)
    out = o_row / torch.clamp(l_row, min=1e-30)[..., None]
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(b, s, h, dv)
    return out.to(q.dtype)


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


def gqa_specs(cfg):
    s = {
        "wq": (EMBED, HEADS, None),
        "wk": (EMBED, KV_HEADS, None),
        "wv": (EMBED, KV_HEADS, None),
        "wo": (HEADS, EMBED),  # fused (h*hd) input dim — sharded like heads
    }
    if cfg.qk_norm:
        s["q_norm"] = (HEAD_DIM,)
        s["k_norm"] = (HEAD_DIM,)
    return s


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


def _kv_heads(q0: int, hl: int, h: int, hk: int):
    """The kv heads [lo, hi) that q heads [q0, q0 + hl) read, and None when
    they read them as GQA groups of hl / (hi - lo) consecutive q heads, else
    the index in [0, hi - lo) of each q head's kv head: where this rank's q
    heads cover only part of a group at either end, k and v are expanded
    to one head per q head (MHA)."""
    g = h // hk
    lo, hi = q0 // g, (q0 + hl - 1) // g + 1
    if hl % g == 0 or g % hl == 0:
        return lo, hi, None
    return lo, hi, [(q0 + i) // g - lo for i in range(hl)]


class _Heads:
    """How one attention call splits its heads: this rank's q heads
    [q0, q0 + hl) and the kv heads they read (``_kv_heads``) under a split
    of ``heads`` over ``model`` (``tp.split``); every head otherwise."""

    def __init__(self, cfg):
        h, hk = cfg.n_heads, cfg.n_kv_heads
        self.split = tp.split(HEADS, h)
        if self.split:
            j, m = tp.model_rank()
            self.hl = h // m
            self.lo, self.hi, self.expand = _kv_heads(j * self.hl, self.hl, h,
                                                      hk or h)
        else:
            self.hl, self.lo, self.hi, self.expand = h, 0, hk, None

    @property
    def n_kv(self) -> int:
        """kv heads the attention reads (after ``select``)."""
        return self.hl if self.expand is not None else self.hi - self.lo

    def enter(self, x):
        return tp.copy_in(x) if self.split else x

    def leave(self, y):
        return tp.reduce_out(y) if self.split else y

    def q_weight(self, w):
        return tp.take(w, 1) if self.split else tp.take(w)

    def out_weight(self, w):
        return tp.take(w, 0) if self.split else tp.take(w)

    def shared(self, w):
        """A weight every local head uses (kv projections, norms): whole,
        its gradient summed over ``model`` under a split."""
        return None if w is None else tp.take(w, partial=self.split)

    def every_head(self, t):
        """(B, S, local heads, ...) -> every head (an all-gather over
        ``model`` under a split), for attention over a block of the
        cache."""
        return tp.gather_model(t, 2) if self.split else t

    def own_heads(self, t):
        """(B, S, every head, ...) -> this rank's heads."""
        return tp.split_in(t, 2) if self.split else t

    def select(self, t, whole: bool):
        """(B, T, kv heads, D) -> the kv heads this rank's q heads read;
        ``whole``: ``t`` holds every kv head (else [lo, hi) already)."""
        if whole and self.split:
            t = t[:, :, self.lo:self.hi]
        if self.expand is not None:
            t = t.index_select(2, torch.tensor(self.expand, device=t.device))
        return t


def gqa_apply(p: GQAAttention, cfg, x, *, positions=None, cache=None,
              cross_kv=None):
    """Returns (out, new_cache). x: (B, S, d); cross_kv: (B, T, d) states
    that k and v are projected from (cross-attention: no cache).

    With ``heads`` split over ``model`` (the sharded step) this rank
    computes its q heads (``wq``'s and ``wo``'s chunk) against the kv heads
    they read, projected from the whole (replicated) ``wk`` / ``wv``: only
    those heads without a cache, every head into a cache.  ``wo``'s
    row-parallel product ends in one all-reduce over ``model``; the kernel
    runs on the local heads at their local GQA ratio.  Against a cache
    handed as this rank's block along ``kv_seq``, q is gathered to every
    head, which attends the block; the partial softmaxes are combined
    across the ranks holding the sequence before ``wo``."""
    b, s, _ = x.shape
    hk, hd = cfg.n_kv_heads, cfg.head_dim
    hs = _Heads(cfg)
    x_in = hs.enter(x)
    src = (x_in if cross_kv is None or cross_kv is x
           else hs.enter(cross_kv))
    wk, wv = hs.shared(p.wk), hs.shared(p.wv)
    narrow = hs.split and cache is None
    if narrow:                              # only the kv heads read here
        wk, wv = wk[:, hs.lo:hs.hi], wv[:, hs.lo:hs.hi]
    nk = hs.hi - hs.lo if narrow else hk
    q = heads(x_in, hs.q_weight(p.wq), hs.hl, hd)
    k, v = heads(src, wk, nk, hd), heads(src, wv, nk, hd)
    if cfg.qk_norm:
        q = rms_norm(q, hs.shared(p.q_norm))
        k = rms_norm(k, hs.shared(p.k_norm))
    wo = hs.out_weight(p.wo)
    if cross_kv is not None:               # rectangular box domain, no mask
        k, v = hs.select(k, False), hs.select(v, False)
        out = _sdpa(q, k, v, hs.n_kv, None)
        return hs.leave(out.reshape(b, s, hs.hl * hd) @ wo), None
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    positions = torch.as_tensor(positions, device=x.device).expand(b, s)
    if cfg.rope_theta:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    new_cache = blk = None
    if cache is not None:                  # decode/prefill against cache
        idx = cache["idx"]
        blk = tp.seq_block(cache["k"].shape[1])
        new_cache = {
            **_cache_put(cache, "k", k, idx, blk),
            **_cache_put(cache, "v", v, idx, blk),
            "idx": idx + s,
        }
        k = _cache_get(new_cache, "k", x.dtype)
        v = _cache_get(new_cache, "v", x.dtype)
    if blk is not None:                    # every head over this block
        part = _sdpa_block(hs.every_head(q), k, v, hk, positions,
                           blk.offset)
        out = hs.own_heads(_over_blocks(part, blk).to(q.dtype))
        return hs.leave(out.reshape(b, s, hs.hl * hd) @ wo), new_cache
    k, v = hs.select(k, not narrow), hs.select(v, not narrow)
    n_kv = hs.n_kv

    if (cache is None and cfg.attn_impl in ("pallas_mapped", "pallas_bb")
            and s % cfg.attn_block == 0 and s >= cfg.attn_block):
        grid_mode = ("mapped" if cfg.attn_impl == "pallas_mapped"
                     else "bounding_box")
        # the kernel reads each kv head in place: no repeat for GQA
        out = _pallas_causal(q, k, v, grid_mode, cfg.attn_block,
                             cfg.pallas_interpret)
    elif (cache is None and cfg.attn_impl == "xla_mapped"
            and s % _Q_CHUNK == 0 and s > _Q_CHUNK):
        out = _sdpa_mapped_causal(q, k, v, n_kv, _Q_CHUNK)
    else:
        out = _sdpa(q, k, v, n_kv, positions)
    y = out.reshape(b, s, hs.hl * hd) @ wo
    return hs.leave(y), new_cache


def cached_cross(p: GQAAttention, cfg, x, xk, xv):
    """Cross-attention of x (B, S, d) against k, v (B, T, Hk, hd)
    projected once at prefill (no mask, no cache write), on this rank's
    heads under a split of ``heads``."""
    b, s, _ = x.shape
    hs = _Heads(cfg)
    q = heads(hs.enter(x), hs.q_weight(p.wq), hs.hl, cfg.head_dim)
    o = _sdpa(q, hs.select(xk, True), hs.select(xv, True), hs.n_kv,
              q_pos=None)
    return hs.leave(o.reshape(b, s, hs.hl * cfg.head_dim)
                    @ hs.out_weight(p.wo))


def _quantize_rows(t):
    """absmax int8 quantization over the last dim: (values, scales)."""
    tf = t.to(torch.float32)
    scale = tf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(scale, min=1e-8) / 127.0
    q = torch.round(tf / scale).to(torch.int8)
    return q, scale


def _cache_put(cache, key, val, idx: int, blk=None):
    """Write ``val`` at position idx, in place, quantizing when the cache is
    int8; returns the written entries.  ``blk`` (``tp.seq_block``): the
    cache is this rank's block, which takes the rows of [idx, idx + S)
    that fall in it, and none if none do."""
    store = cache[key]
    lo = idx
    if blk is not None:
        lo = max(idx, blk.offset)
        hi = min(idx + val.shape[1], blk.offset + blk.length)
        val = val[:, lo - idx:max(hi, lo) - idx]
        lo -= blk.offset
    rows = slice(lo, lo + val.shape[1])
    if store.dtype == torch.int8:
        if val.shape[1]:
            q, scale = _quantize_rows(val)
            store[:, rows] = q
            cache[key + "_scale"][:, rows] = scale
        return {key: store, key + "_scale": cache[key + "_scale"]}
    if val.shape[1]:
        store[:, rows] = val.to(store.dtype)
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
# MLA (deepseek-v2): a low-rank compressed kv cache and one RoPE key shared
# by every head
# ---------------------------------------------------------------------------


class MLAAttention(nn.Module):
    """wdq (d, q_lora), q_norm (q_lora,), wuq (q_lora, H, dn + dr), wdkv (d,
    kv_lora), kv_norm (kv_lora,), wuk (kv_lora, H, dn), wuv (kv_lora, H, dv),
    wkr (d, dr), wo (H·dv, d)."""

    def __init__(self, wdq, q_norm, wuq, wdkv, kv_norm, wuk, wuv, wkr, wo):
        super().__init__()
        self.wdq, self.q_norm, self.wuq = (frozen_param(w)
                                           for w in (wdq, q_norm, wuq))
        self.wdkv, self.kv_norm = frozen_param(wdkv), frozen_param(kv_norm)
        self.wuk, self.wuv, self.wkr, self.wo = (frozen_param(w)
                                                 for w in (wuk, wuv, wkr, wo))


#: the MLA weights in the order of ``MLAAttention``'s arguments
MLA_NAMES = ("wdq", "q_norm", "wuq", "wdkv", "kv_norm", "wuk", "wuv", "wkr",
             "wo")


def mla_init(generator, cfg, dtype, device=None) -> MLAAttention:
    d, h = cfg.d_model, cfg.n_heads
    ql, kl = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim

    def dense(i, o):
        return dense_init(generator, i, o, dtype, device=device)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    return MLAAttention(dense(d, ql), ones(ql), dense(ql, (h, dn + dr)),
                        dense(d, kl), ones(kl), dense(kl, (h, dn)),
                        dense(kl, (h, dv)), dense(d, dr), dense(h * dv, d))


def mla_specs(cfg):
    return {
        "wdq": (EMBED, "q_lora"),
        "q_norm": ("q_lora",),
        "wuq": ("q_lora", HEADS, None),
        "wdkv": (EMBED, "kv_lora"),
        "kv_norm": ("kv_lora",),
        "wuk": ("kv_lora", HEADS, None),
        "wuv": ("kv_lora", HEADS, None),
        "wkr": (EMBED, None),
        "wo": (HEADS, EMBED),
    }


def mla_apply(p: MLAAttention, cfg, x, *, positions=None, cache=None,
              cross_kv=None):
    """Returns (out, new_cache).  The full path up-projects k and v from
    the normed latent and runs ``_sdpa`` with q·k over dn + dr; with a cache
    and at most 32 new tokens (decode) the absorbed path moves ``wuk`` onto
    the query and ``wuv`` after the probabilities, so attention stays in the
    kv_lora space (reference ``attention.py:373-393``).

    With ``heads`` split over ``model`` the low-rank projections, the
    latent, its cache and the RoPE key are computed whole on every rank;
    the latents enter the split region, ``wuq`` / ``wuk`` / ``wuv`` and
    ``wo`` give this rank's heads, and ``wo``'s product ends in one
    all-reduce over ``model`` (both paths).  Against a cache handed as this
    rank's block along ``kv_seq`` every head attends the block: the
    absorbed queries gathered over ``model``, or ``wuk`` / ``wuv`` taken
    whole to up-project the block for every head."""
    if cross_kv is not None:
        raise ValueError("MLA has no cross-attention")
    b, s, _ = x.shape
    hs = _Heads(cfg)
    hl = hs.hl
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    positions = torch.as_tensor(positions, device=x.device).expand(b, s)
    wdq, q_norm, wdkv, kv_norm, wkr = (tp.take(w) for w in (
        p.wdq, p.q_norm, p.wdkv, p.kv_norm, p.wkr))
    wuq, wuk, wuv = (hs.q_weight(w) for w in (p.wuq, p.wuk, p.wuv))
    wo = hs.out_weight(p.wo)

    q = heads(hs.enter(rms_norm(x @ wdq, q_norm)), wuq, hl, dn + dr)
    q_nope = q[..., :dn]
    q_rope = rope(q[..., dn:], positions, cfg.rope_theta)
    ckv = x @ wdkv                                      # compressed kv
    krope = rope((x @ wkr)[:, :, None, :], positions,
                 cfg.rope_theta)[:, :, 0, :]            # shared rope key

    new_cache = blk = None
    if cache is not None:
        idx = cache["idx"]
        blk = tp.seq_block(cache["ckv"].shape[1])
        new_cache = {**_cache_put(cache, "ckv", ckv, idx, blk),
                     **_cache_put(cache, "krope", krope, idx, blk),
                     "idx": idx + s}
        ckv, krope = new_cache["ckv"], new_cache["krope"]
    ckv_n = hs.enter(rms_norm(ckv, kv_norm))
    krope = hs.enter(krope)
    t = ckv_n.shape[1]

    if cfg.mla_absorb != "never" and cache is not None and s <= 32:
        #   q·k = (W_uk q_nope)·c_kv ;  probs·v = (probs·c_kv)·W_uv
        q_abs = torch.einsum("bshe,lhe->bshl", q_nope, wuk)
        start = new_cache["idx"] - s
        if blk is not None:               # every head over this block
            part = _mla_block(hs.every_head(q_abs), hs.every_head(q_rope),
                              ckv_n, krope, start, blk.offset, dn + dr)
            o_lat = hs.own_heads(_over_blocks(part, blk))
            out = torch.einsum("bshl,lhe->bshe", o_lat.to(x.dtype), wuv)
            return hs.leave(out.reshape(b, s, hl * dv) @ wo), new_cache
        cf = ckv_n.to(torch.float32)
        logits = (torch.einsum("bshl,btl->bhst", q_abs.to(torch.float32), cf)
                  + torch.einsum("bshr,btr->bhst", q_rope.to(torch.float32),
                                 krope.to(torch.float32))) * (dn + dr) ** -0.5
        mask = (torch.arange(t, device=x.device)[None, :]
                <= start + torch.arange(s, device=x.device)[:, None])
        probs = torch.softmax(logits.masked_fill(~mask, NEG_INF), dim=-1)
        o_lat = torch.einsum("bhst,btl->bshl", probs, cf)
        out = torch.einsum("bshl,lhe->bshe", o_lat.to(x.dtype), wuv)
        return hs.leave(out.reshape(b, s, hl * dv) @ wo), new_cache

    if blk is not None:      # every head's k, v up-projected from the block
        h = cfg.n_heads
        k_nope = heads(ckv_n, tp.take(p.wuk), h, dn)
        v = heads(ckv_n, tp.take(p.wuv), h, dv)
        k = torch.cat([k_nope, krope[:, :, None, :].expand(b, t, h, dr)],
                      dim=-1)
        q = hs.every_head(torch.cat([q_nope, q_rope], dim=-1))
        part = _sdpa_block(q, k, v, h, positions, blk.offset,
                           logit_dim=dn + dr)
        out = hs.own_heads(_over_blocks(part, blk).to(x.dtype))
        return hs.leave(out.reshape(b, s, hl * dv) @ wo), new_cache

    k_nope = heads(ckv_n, wuk, hl, dn)                  # (B, T, H, dn)
    v = heads(ckv_n, wuv, hl, dv)                       # (B, T, H, dv)
    k = torch.cat([k_nope, krope[:, :, None, :].expand(b, t, hl, dr)],
                  dim=-1)
    out = _sdpa(torch.cat([q_nope, q_rope], dim=-1), k, v, hl, positions,
                logit_dim=dn + dr)
    return hs.leave(out.reshape(b, s, hl * dv) @ wo), new_cache


def mla_cache_init(cfg, batch: int, max_seq: int, dtype, device=None):
    """The compressed latent and the shared RoPE key; never int8 (the
    reference offers no int8 MLA cache: ``kv_cache_quant`` applies to GQA
    caches only)."""
    return {
        "ckv": torch.zeros((batch, max_seq, cfg.kv_lora_rank), dtype=dtype,
                           device=device),
        "krope": torch.zeros((batch, max_seq, cfg.qk_rope_dim), dtype=dtype,
                             device=device),
        "idx": 0,
    }
