"""The model families: ``dense`` (GQA + SwiGLU MLP), ``moe`` (GQA + a
sort-dispatch mixture of experts in place of the MLP, ``models/moe.py``),
``vlm`` (llama-3.2-vision: groups of ``cross_attn_every - 1`` self layers
and one gated cross-attention layer over stub patch embeddings), ``ssm``
(the RWKV-6 stack: time mix + channel mix), ``hybrid`` (zamba2: a Mamba2
backbone, ``models/mamba2.py``, and ONE shared attention + MLP block fired
every ``hybrid_attn_every`` layers, with a KV cache per invocation) and
``audio`` (whisper: a bidirectional encoder over stub frame embeddings, a
causal decoder with cross-attention).

The public API mirrors the reference's: ``init_params`` / ``param_specs`` /
``forward``
(teacher-forced logits; ``with_aux`` adds the MoE load-balancing loss) /
``init_cache`` / ``prefill`` / ``decode_step``.  Parameters are a
``DenseLM`` (dense, moe), ``VisionLM``, ``RWKVLM``, ``HybridLM`` or
``WhisperLM`` module whose layers are an ``nn.ModuleList`` walked by a loop
(the reference scans stacked parameters); the weights keep the reference's
layouts (``models/convert.py`` loads a reference tree).  Causal
self-attention in a cache-less ``forward`` (the hybrid family's shared block
included) runs the tri_attn kernel under ``attn_impl`` ``pallas_*``;
cross-attention, the whisper encoder's bidirectional attention and MLA
(deepseek-v2: q·k over 192, v 128 wide) are the plain ``_sdpa``, as in the
reference.  ``extra`` (vision states or frames)
is cast to the weights' dtype: torch's products do not promote a bf16 weight
against fp32 states as jnp's do.  An RWKV layer runs the chunked WKV, and so
the ``wkv`` kernel, when the sequence is a multiple of 64, and the
step-by-step scan otherwise (decode), the reference's rule; a Mamba2 layer
takes its chunked SSD or its scan by the same rule.  Passes that ask for no
gradient run under ``torch.inference_mode()``.  A pass that asks for one
recomputes each layer in the backward by ``cfg.remat_policy`` (``_remat``:
``"full"`` keeps only the layer boundaries, ``"dots"`` also the weight
products' outputs, ``"none"`` everything), as the reference's
``jax.checkpoint`` does.  ``param_specs`` is the reference's logical-axis
tree, stacked axes included; ``param_axes`` gives each port parameter its
own axes (the tree's leaf at ``jax_path(name)`` without the stacked ones).
While a torch profiler records, each layer function opens the ranges
``repro_torch.mixer`` and ``repro_torch.ffn`` around its two halves and
``_logits`` opens ``repro_torch.head`` (``obs/trace.py``'s ``region``).

In a split step (the sharded train step, the dry run's steps;
``distribution/tensor_parallel.py``) each layer function gathers its layer's
weights over the data axes inside the function remat checkpoints, so the
recompute gathers them again; the model's own weights (the embedding, the
head, the final norms) are gathered for the pass.  The lookup and the logits
split the vocab over ``model`` (``forward`` then returns this rank's vocab
chunk), attention its heads, the MLPs their ffn and the MoE its experts;
rwkv6's time mix its heads (or, where they do not divide ``model``, its
projections' columns around a WKV run whole), its channel mix its ffn, and
mamba2 its heads.  Caches given to such a layer (prefill, decode) stay
whole: the layer computes on its heads of the state and gathers the new
state over ``model``.
"""
from __future__ import annotations

import contextlib
import functools

import torch
from torch import nn

from repro_torch.distribution import sharding as shd
from repro_torch.distribution import tensor_parallel as tp
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rwkv
from repro_torch.models.common import (
    EMBED, FFN, VOCAB, SwiGLU, dense_init, embed_init, frozen_param, gelu_mlp,
    island_dtype, jax_path, layer_norm, mlp_specs, prepend_layers_axis,
    rms_norm, swiglu,
)
from repro_torch.obs.trace import region

PORTED_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")
#: an RWKV layer takes the chunked WKV when the sequence is a multiple of
#: this, and the scan otherwise (reference ``transformer.py:261``)
RWKV_CHUNK = 64


def require_ported(cfg) -> None:
    """Raise ValueError for a family this package does not know."""
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"{cfg.arch_id}: unknown family {cfg.family!r}")


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat_policy="dots"``: keep the
    outputs of products without batch dims (``x @ w``: aten mm / addmm),
    recompute the rest — ``dots_with_no_batch_dims_saveable``'s rule."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _gathered(fn):
    """``fn(layer, ...)`` with the layer's parameters gathered over the
    data axes for the call in a split step
    (``distribution/tensor_parallel.py``); ``fn`` itself otherwise."""

    def run(lp, *args, **kwargs):
        with tp.gather_params(lp):
            return fn(lp, *args, **kwargs)

    return run


def _remat(fn, cfg):
    """``fn`` recomputed in the backward by ``cfg.remat_policy`` (``"none"``
    when ``cfg.remat`` is off) when the pass records a gradient; as it is
    otherwise (scoring and serving run under inference mode).  The
    recompute runs with the sharding and split-step contexts the call saw
    (autograd runs a CUDA backward in its own thread), so a layer wrapped
    by ``_gathered`` gathers its weights again."""
    policy = cfg.remat_policy if cfg.remat else "none"
    if policy == "none" or not torch.is_grad_enabled():
        return fn
    if policy not in ("full", "dots"):
        raise ValueError(f"remat_policy {policy!r}")
    from torch.utils.checkpoint import (
        checkpoint, create_selective_checkpoint_contexts,
    )

    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)

    def run(*args, **kwargs):
        split, sharding = tp.current(), shd.current_ctx()

        def body(*a, **k):
            with tp.restored(split), (
                    contextlib.nullcontext() if sharding is None
                    else shd.use_sharding(sharding.mesh, sharding.param_rules,
                                          sharding.act_rules)):
                return fn(*a, **k)

        return checkpoint(body, *args, use_reentrant=False, **kw, **kwargs)

    return run


def _dtype(cfg) -> torch.dtype:
    return {"bfloat16": torch.bfloat16,
            "float64": torch.float64}.get(cfg.dtype, torch.float32)


class DecoderLayer(nn.Module):
    """ln1, ln2 (d,), attention (GQA, or MLA where ``cfg.attention_type``
    says so), and an MLP (``mlp``) or, in the moe family, a mixture of
    experts (``moe``) in its place."""

    def __init__(self, ln1, ln2, attn_p: attn.GQAAttention | attn.MLAAttention,
                 mlp: SwiGLU | None = None, moe: moe_mod.MoE | None = None):
        super().__init__()
        if (mlp is None) == (moe is None):
            raise ValueError("a decoder layer takes an mlp or a moe")
        self.ln1, self.ln2 = frozen_param(ln1), frozen_param(ln2)
        self.attn = attn_p
        self.mlp = mlp
        self.moe = moe


class CrossLayer(DecoderLayer):
    """A vlm group's gated cross-attention layer: its output is scaled by
    tanh(xattn_gate), an fp32 scalar (0 at init, as in the reference)."""

    def __init__(self, ln1, ln2, attn_p: attn.GQAAttention, mlp: SwiGLU,
                 xattn_gate):
        super().__init__(ln1, ln2, attn_p, mlp)
        self.xattn_gate = frozen_param(xattn_gate)


class VisionGroup(nn.Module):
    """``cross_attn_every - 1`` self layers, then one cross layer."""

    def __init__(self, self_layers, cross: CrossLayer):
        super().__init__()
        self.self_layers = nn.ModuleList(self_layers)
        self.cross = cross


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


class VisionLM(nn.Module):
    """embed (V, d), final_norm (d,), lm_head (d, V) unless the embedding is
    tied, and the groups of self layers + one cross layer."""

    def __init__(self, cfg, embed, final_norm, groups, lm_head=None):
        super().__init__()
        self.cfg = cfg
        self.embed = frozen_param(embed)
        self.final_norm = frozen_param(final_norm)
        self.lm_head = None if lm_head is None else frozen_param(lm_head)
        self.groups = nn.ModuleList(groups)

    def forward(self, tokens, extra=None, positions=None):
        return forward(self, self.cfg, tokens, extra, positions=positions)


def _no_grad_unless_asked(params) -> contextlib.AbstractContextManager:
    if torch.is_grad_enabled() and any(p.requires_grad
                                       for p in params.parameters()):
        return contextlib.nullcontext()
    return torch.inference_mode()


def _device(params) -> torch.device:
    return params.embed.device


def _layer_apply(p: DecoderLayer, cfg, x, *, positions=None, cache=None,
                 cross_kv=None, with_aux: bool = False):
    """Returns (x, new_cache), or (x, new_cache, moe aux) with with_aux."""
    apply = (attn.mla_apply if isinstance(p.attn, attn.MLAAttention)
             else attn.gqa_apply)
    with region("mixer"):
        h, new_cache = apply(p.attn, cfg, rms_norm(x, p.ln1),
                             positions=positions, cache=cache,
                             cross_kv=cross_kv)
        if cross_kv is not None:
            h = h * torch.tanh(p.xattn_gate).to(h.dtype)
        x = x + h
    aux = None
    with region("ffn"):
        inner = rms_norm(x, p.ln2)
        if p.moe is not None:
            out = moe_mod.moe_apply(p.moe, cfg, inner, with_aux=with_aux)
            if with_aux:
                out, aux = out
            x = x + out
        else:
            x = x + swiglu(inner, p.mlp.gate, p.mlp.up, p.mlp.down)
    if not with_aux:
        return x, new_cache
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, new_cache, aux


def _decoder_stack(params: DenseLM, cfg, x, *, positions=None, caches=None,
                   with_aux: bool = False):
    """Loop over the layers; caches is a list of per-layer caches or None.
    with_aux also returns the summed MoE load-balancing loss."""
    new_caches = None if caches is None else []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    body = _remat(_gathered(_layer_apply), cfg)
    for i, lp in enumerate(params.layers):
        out = body(lp, cfg, x, positions=positions,
                   cache=None if caches is None else caches[i],
                   with_aux=with_aux)
        x, c = out[0], out[1]
        if with_aux:
            aux = aux + out[2]
        if new_caches is not None:
            new_caches.append(c)
    return (x, new_caches, aux) if with_aux else (x, new_caches)


def _vlm_stack(params: VisionLM, cfg, x, *, positions=None, caches=None,
               cross_states=None):
    """Loop over the groups; caches is a list of ``{"self": [per-layer
    caches]}`` per group, or None.  The cross layer takes no cache: it
    projects k and v from ``cross_states`` at every call, decode steps
    included, as the reference does."""
    new_caches = None if caches is None else []
    body = _remat(_gathered(_layer_apply), cfg)
    for g, gp in enumerate(params.groups):
        self_caches = None if caches is None else caches[g]["self"]
        new_self = None if caches is None else []
        for i, lp in enumerate(gp.self_layers):
            x, c = body(
                lp, cfg, x, positions=positions,
                cache=None if self_caches is None else self_caches[i])
            if new_self is not None:
                new_self.append(c)
        x, _ = body(gp.cross, cfg, x, positions=positions,
                    cross_kv=cross_states)
        if new_caches is not None:
            new_caches.append({"self": new_self})
    return x, new_caches


def _vocab_product(h, w, vocab_dim: int):
    """fp32 ``h @ w`` (``w.T`` where its vocab is dim 0), as the
    reference's fp32-accumulating product gives; with ``vocab`` split over
    ``model``, this rank's chunk of the vocab (``train_step.lm_loss`` takes
    it so)."""
    if tp.split(VOCAB, tp.full_size(w, vocab_dim)):
        h, w = tp.copy_in(h), tp.take(w, vocab_dim)
    else:
        w = tp.take(w)
    if vocab_dim == 0:
        w = w.T
    dt = island_dtype(h.dtype)
    return h.to(dt) @ w.to(dt)


def _logits(params, cfg, h):
    """fp32 logits (this rank's vocab chunk in a split step)."""
    with region("head"):
        h = rms_norm(h, params.final_norm)
        if cfg.tie_embeddings:
            return _vocab_product(h, params.embed, 0)
        return _vocab_product(h, params.lm_head, 1)


class _Lookup(torch.autograd.Function):
    """``table[tokens]`` whose backward sums the rows of each token in fp32
    and rounds once to the table's dtype.  In bf16 the plain lookup's
    backward adds a token's rows one by one in bf16 (the reference's
    ``jnp.take`` does too on the CPU), so a token repeated a thousand times,
    as SyntheticLM's most frequent ones are in a 4096-token row, gets a
    gradient off by about a tenth of the table's max.  ``keep`` (a mask of
    the tokens' shape) zeroes the rows of the tokens it leaves out, and
    their gradients."""

    @staticmethod
    def forward(ctx, table, tokens, keep=None):
        ctx.save_for_backward(tokens, keep)
        ctx.rows = table.shape[0]
        rows = table[tokens]
        return rows if keep is None else torch.where(keep[..., None], rows, 0)

    @staticmethod
    def backward(ctx, g):
        tokens, keep = ctx.saved_tensors
        gf = g.to(island_dtype(g.dtype))
        if keep is not None:
            gf = torch.where(keep[..., None], gf, 0)
        grad = torch.ops.aten.embedding_dense_backward(
            gf, tokens, ctx.rows, -1, False)
        return grad.to(g.dtype), None, None


def _embed(params, cfg, tokens):
    """The lookup.  With ``vocab`` split over ``model`` each rank looks up
    the tokens in its rows of the table (zeros for the others) and one
    all-reduce over ``model`` sums them."""
    table = params.embed
    vocab = tp.full_size(table, 0)
    if not tp.split(VOCAB, vocab):
        return _Lookup.apply(tp.take(table), tokens)
    j, m = tp.model_rank()
    rows = vocab // m
    local = tokens - j * rows
    keep = (local >= 0) & (local < rows)
    out = _Lookup.apply(tp.take(table, 0), torch.where(keep, local, 0), keep)
    return tp.reduce_out(out)


def _tokens(params, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, dtype=torch.int64, device=_device(params))


def _extra(params, extra):
    """Vision states or frames (B, T, d) on the weights' device and dtype."""
    if extra is None:
        return None
    return torch.as_tensor(extra, device=_device(params)).to(
        params.embed.dtype)


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
    """state: dict(tmix_x, cmix_x, wkv), ``wkv`` None for zeros (a
    cache-less pass: the new ``wkv`` is then this rank's heads under a
    split step, else whole). Chunked when seq allows, else scan."""
    with region("mixer"):
        n1 = rms_norm(x, p.ln1)
        if x.shape[1] % RWKV_CHUNK:
            o, last_x, wkv = rwkv.rwkv_mix_scan(p.tmix, cfg, n1,
                                                state["tmix_x"], state["wkv"])
        else:
            o, last_x, wkv = rwkv.rwkv_mix_chunked(p.tmix, cfg, n1,
                                                   state["tmix_x"],
                                                   state["wkv"],
                                                   chunk=RWKV_CHUNK)
        x = x + o
    with region("ffn"):
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
    zero = None if caches is not None else dict(
        _rwkv_zero_state(cfg, x.shape[0], x.device), wkv=None)
    new_caches = None if caches is None else []
    body = _remat(_gathered(_rwkv_layer_apply), cfg)
    for i, lp in enumerate(params.layers):
        x, st = body(lp, cfg, x, zero if caches is None else caches[i])
        if new_caches is not None:
            new_caches.append(st)
    return x, new_caches


# ===========================================================================
# Zamba2 hybrid
# ===========================================================================


class MambaLayer(nn.Module):
    """ln (d,) and a Mamba2 block."""

    def __init__(self, ln, mamba: m2.Mamba2):
        super().__init__()
        self.ln = frozen_param(ln)
        self.mamba = mamba


class HybridLM(nn.Module):
    """embed (V, d), final_norm (d,), lm_head (d, V), the Mamba2 layers and
    ONE shared attention + MLP block (a ``DecoderLayer``: ln1, ln2, attn,
    mlp) fired after every ``hybrid_attn_every``-th layer."""

    def __init__(self, cfg, embed, final_norm, layers, shared: DecoderLayer,
                 lm_head):
        super().__init__()
        self.cfg = cfg
        self.embed = frozen_param(embed)
        self.final_norm = frozen_param(final_norm)
        self.lm_head = frozen_param(lm_head)
        self.layers = nn.ModuleList(layers)
        self.shared = shared

    def forward(self, tokens, positions=None):
        return forward(self, self.cfg, tokens, positions=positions)


def _mamba_layer_apply(lp: MambaLayer, cfg, x, state, conv_tail):
    with region("mixer"):
        return m2.mamba2_apply(lp.mamba, cfg, rms_norm(x, lp.ln), state=state,
                               conv_tail=conv_tail)


def _hybrid_stack(params: HybridLM, cfg, x, *, positions=None, cache=None):
    """Loop over the Mamba2 layers; after layer i with i % period == period
    - 1 the shared block fires (invocation i // period).  ``cache``:
    ``{"layers": [{"state", "conv_tail"}], "shared": [one GQA cache per
    invocation], "idx"}`` or None; returns (x, new cache or None)."""
    period = cfg.hybrid_attn_every
    new = None if cache is None else {
        "layers": [], "shared": list(cache["shared"]),
        "idx": cache["idx"] + x.shape[1]}
    mamba_body = _remat(_gathered(_mamba_layer_apply), cfg)
    shared_body = _remat(_gathered(_layer_apply), cfg)
    for i, lp in enumerate(params.layers):
        lc = None if cache is None else cache["layers"][i]
        h, state, tail = mamba_body(
            lp, cfg, x, None if lc is None else lc["state"],
            None if lc is None else lc["conv_tail"])
        x = x + h
        if new is not None:
            new["layers"].append({"state": state, "conv_tail": tail})
        if i % period == period - 1:
            inv = i // period
            x, c = shared_body(params.shared, cfg, x, positions=positions,
                               cache=None if new is None
                               else new["shared"][inv])
            if new is not None:
                new["shared"][inv] = c
    return x, new


def _hybrid_cache(cfg, batch: int, max_seq: int, dtype, device) -> dict:
    """fp32 Mamba states (B, H, P, N) and conv tails (B, W-1, d_inner + 2N)
    per layer; one GQA cache per shared-block invocation, never int8 (the
    reference keeps it unquantised under kv_cache_quant too)."""
    h, n = cfg.mamba_heads, cfg.ssm_state
    layers = [{"state": torch.zeros((batch, h, cfg.mamba_d_inner // h, n),
                                    dtype=torch.float32, device=device),
               "conv_tail": torch.zeros(
                   (batch, cfg.mamba_conv_width - 1,
                    cfg.mamba_d_inner + 2 * n), dtype=dtype, device=device)}
              for _ in range(cfg.n_layers)]
    shared_cfg = cfg.replace(kv_cache_quant=False)
    shared = [attn.gqa_cache_init(shared_cfg, batch, max_seq, dtype, device)
              for _ in range(cfg.n_layers // cfg.hybrid_attn_every)]
    return {"layers": layers, "shared": shared, "idx": 0}


# ===========================================================================
# Whisper (audio)
# ===========================================================================


class GeluMLP(nn.Module):
    """up (d, d_ff), down (d_ff, d)."""

    def __init__(self, up, down):
        super().__init__()
        self.up, self.down = frozen_param(up), frozen_param(down)


class WhisperEncLayer(nn.Module):
    def __init__(self, ln1_w, ln1_b, ln2_w, ln2_b, attn_p: attn.GQAAttention,
                 mlp: GeluMLP):
        super().__init__()
        self.ln1_w, self.ln1_b = frozen_param(ln1_w), frozen_param(ln1_b)
        self.ln2_w, self.ln2_b = frozen_param(ln2_w), frozen_param(ln2_b)
        self.attn = attn_p
        self.mlp = mlp


class WhisperDecLayer(nn.Module):
    def __init__(self, ln1_w, ln1_b, lnx_w, lnx_b, ln2_w, ln2_b,
                 attn_p: attn.GQAAttention, xattn: attn.GQAAttention,
                 mlp: GeluMLP):
        super().__init__()
        self.ln1_w, self.ln1_b = frozen_param(ln1_w), frozen_param(ln1_b)
        self.lnx_w, self.lnx_b = frozen_param(lnx_w), frozen_param(lnx_b)
        self.ln2_w, self.ln2_b = frozen_param(ln2_w), frozen_param(ln2_b)
        self.attn = attn_p
        self.xattn = xattn
        self.mlp = mlp


class WhisperLM(nn.Module):
    """embed (V, d), enc_pos (encoder_seq, d), dec_pos (max_seq, d), the
    encoder and decoder layers, their final layer norms (weight and bias)
    and lm_head (d, V)."""

    def __init__(self, cfg, embed, enc_pos, dec_pos, enc_layers, dec_layers,
                 enc_norm_w, enc_norm_b, final_norm, final_norm_b, lm_head):
        super().__init__()
        self.cfg = cfg
        self.embed = frozen_param(embed)
        self.enc_pos, self.dec_pos = frozen_param(enc_pos), \
            frozen_param(dec_pos)
        self.enc_layers = nn.ModuleList(enc_layers)
        self.dec_layers = nn.ModuleList(dec_layers)
        self.enc_norm_w = frozen_param(enc_norm_w)
        self.enc_norm_b = frozen_param(enc_norm_b)
        self.final_norm = frozen_param(final_norm)
        self.final_norm_b = frozen_param(final_norm_b)
        self.lm_head = frozen_param(lm_head)

    def forward(self, tokens, extra=None, positions=None):
        return forward(self, self.cfg, tokens, extra, positions=positions)


def _bidir_attn(p: attn.GQAAttention, cfg, x):
    """Bidirectional self-attention (the whisper encoder: a box domain):
    the cross path of ``gqa_apply`` with k and v projected from x."""
    return attn.gqa_apply(p, cfg, x, cross_kv=x)[0]


def _whisper_encode(params: WhisperLM, cfg, frames):
    """frames: (B, T_enc, d) stub embeddings -> encoder states."""
    x = frames + params.enc_pos[None, :frames.shape[1]]
    body = _remat(_gathered(_whisper_enc_layer), cfg)
    for lp in params.enc_layers:
        x = body(lp, cfg, x)
    return layer_norm(x, params.enc_norm_w, params.enc_norm_b)


def _whisper_enc_layer(lp: WhisperEncLayer, cfg, x):
    with region("mixer"):
        x = x + _bidir_attn(lp.attn, cfg, layer_norm(x, lp.ln1_w, lp.ln1_b))
    with region("ffn"):
        return x + gelu_mlp(layer_norm(x, lp.ln2_w, lp.ln2_b), lp.mlp.up,
                            lp.mlp.down)


def _whisper_dec_stack(params: WhisperLM, cfg, x, enc_states, *,
                       positions=None, caches=None, cross=None):
    """``enc_states`` for a cache-less forward; ``cross`` ({k, v}, each
    (L, B, T_enc, Hk, hd), projected at prefill) against a cache."""
    new_caches = None if caches is None else []
    body = _remat(_gathered(_whisper_dec_layer), cfg)
    for i, lp in enumerate(params.dec_layers):
        x, c = body(lp, cfg, x, enc_states, positions,
                    None if caches is None else caches[i],
                    None if cross is None else (cross["k"][i],
                                                cross["v"][i]))
        if new_caches is not None:
            new_caches.append(c)
    return x, new_caches


def _whisper_dec_layer(lp: WhisperDecLayer, cfg, x, enc_states, positions,
                       cache, cross_kv):
    """One decoder layer; ``cross_kv``: this layer's (k, v) projected at
    prefill, or None to attend over ``enc_states``."""
    with region("mixer"):
        h, c = attn.gqa_apply(lp.attn, cfg,
                              layer_norm(x, lp.ln1_w, lp.ln1_b),
                              positions=positions, cache=cache)
        x = x + h
        nx = layer_norm(x, lp.lnx_w, lp.lnx_b)
        if cross_kv is not None:
            x = x + attn.cached_cross(lp.xattn, cfg, nx, *cross_kv)
        else:
            x = x + attn.gqa_apply(lp.xattn, cfg, nx, cross_kv=enc_states)[0]
    with region("ffn"):
        x = x + gelu_mlp(layer_norm(x, lp.ln2_w, lp.ln2_b), lp.mlp.up,
                         lp.mlp.down)
    return x, c


def _whisper_cross(params: WhisperLM, cfg, enc_states, cross):
    """Every decoder layer's cross k, v from the encoder states, written
    into ``cross`` (``init_cache``'s, sized by its ``extra_len``) in
    place."""
    hk, hd = cfg.n_kv_heads, cfg.head_dim
    for i, lp in enumerate(params.dec_layers):
        with tp.gather_params(lp.xattn, whole=True):
            cross["k"][i] = attn.heads(enc_states, lp.xattn.wk, hk, hd)
            cross["v"][i] = attn.heads(enc_states, lp.xattn.wv, hk, hd)
    return cross


def _whisper_logits(params: WhisperLM, cfg, x):
    with region("head"):
        h = layer_norm(x, params.final_norm, params.final_norm_b)
        return _vocab_product(h, params.lm_head, 1)


def _stack(params, cfg, x, *, positions=None, caches=None, extra=None):
    """The decoder-only families' layer stack."""
    if cfg.family == "ssm":
        return _rwkv_stack(params, cfg, x, caches=caches)
    if cfg.family == "hybrid":
        return _hybrid_stack(params, cfg, x, positions=positions,
                             cache=caches)
    if cfg.family == "vlm":
        return _vlm_stack(params, cfg, x, positions=positions, caches=caches,
                          cross_states=extra)
    return _decoder_stack(params, cfg, x, positions=positions, caches=caches)


# ===========================================================================
# Logical-axis specs (the reference's ``param_specs`` and its helpers)
# ===========================================================================


def _gelu_mlp_specs():
    return {"up": (EMBED, FFN), "down": (FFN, EMBED)}


def _attn_specs(cfg):
    return (attn.mla_specs(cfg) if cfg.attention_type == "mla"
            else attn.gqa_specs(cfg))


def _layer_specs(cfg, cross: bool = False):
    s = {
        "ln1": (EMBED,), "ln2": (EMBED,),
        "attn": attn.gqa_specs(cfg) if cross else _attn_specs(cfg),
    }
    if cfg.family == "moe" and not cross:
        s["moe"] = moe_mod.moe_specs(cfg)
    else:
        s["mlp"] = mlp_specs()
    if cross:
        s["xattn_gate"] = ()
    return s


def _rwkv_layer_specs(cfg):
    return {
        "ln1": (EMBED,), "ln2": (EMBED,),
        "tmix": rwkv.rwkv_block_specs(cfg),
        "cmix": rwkv.rwkv_cmix_specs(cfg),
    }


def _zamba_shared_specs(cfg):
    return {
        "ln1": (EMBED,), "ln2": (EMBED,),
        "attn": attn.gqa_specs(cfg),
        "mlp": mlp_specs(),
    }


def _whisper_enc_layer_specs(cfg):
    return {
        "ln1_w": (EMBED,), "ln1_b": (EMBED,),
        "ln2_w": (EMBED,), "ln2_b": (EMBED,),
        "attn": attn.gqa_specs(cfg),
        "mlp": _gelu_mlp_specs(),
    }


def _whisper_dec_layer_specs(cfg):
    return {
        "ln1_w": (EMBED,), "ln1_b": (EMBED,),
        "lnx_w": (EMBED,), "lnx_b": (EMBED,),
        "ln2_w": (EMBED,), "ln2_b": (EMBED,),
        "attn": attn.gqa_specs(cfg),
        "xattn": attn.gqa_specs(cfg),
        "mlp": _gelu_mlp_specs(),
    }


def param_specs(cfg) -> dict:
    """The reference's logical-axis tree: one tuple of axis names per leaf
    of its (stacked) parameter tree."""
    require_ported(cfg)
    if cfg.family in ("dense", "moe", "vlm"):
        specs = {"embed": (VOCAB, EMBED), "final_norm": (EMBED,)}
        if not cfg.tie_embeddings:
            specs["lm_head"] = (EMBED, VOCAB)
        if cfg.family == "vlm":
            specs["groups"] = prepend_layers_axis({
                "self": prepend_layers_axis(_layer_specs(cfg)),
                "cross": _layer_specs(cfg, cross=True),
            })
        else:
            specs["layers"] = prepend_layers_axis(_layer_specs(cfg))
        return specs
    if cfg.family == "ssm":
        return {
            "embed": (VOCAB, EMBED), "final_norm": (EMBED,),
            "lm_head": (EMBED, VOCAB),
            "layers": prepend_layers_axis(_rwkv_layer_specs(cfg)),
        }
    if cfg.family == "hybrid":
        return {
            "embed": (VOCAB, EMBED), "final_norm": (EMBED,),
            "lm_head": (EMBED, VOCAB),
            "layers": prepend_layers_axis(
                {"ln": (EMBED,), "mamba": m2.mamba2_specs(cfg)}),
            "shared": _zamba_shared_specs(cfg),
        }
    return {   # audio
        "embed": (VOCAB, EMBED),
        "enc_pos": ("frames", EMBED), "dec_pos": (None, EMBED),
        "enc_layers": prepend_layers_axis(_whisper_enc_layer_specs(cfg)),
        "dec_layers": prepend_layers_axis(_whisper_dec_layer_specs(cfg)),
        "enc_norm_w": (EMBED,), "enc_norm_b": (EMBED,),
        "final_norm": (EMBED,), "final_norm_b": (EMBED,),
        "lm_head": (EMBED, VOCAB),
    }


def param_axes(params, cfg) -> dict:
    """{parameter name: its logical axes} for a model (or an iterable of
    its parameter names): ``param_specs``'s leaf at ``jax_path(name)``
    without the stacked leading axes (one per layer index in the name; two
    in vlm's ``groups.self``)."""
    names = (dict(params.named_parameters()) if hasattr(
        params, "named_parameters") else params)
    specs = param_specs(cfg)
    out = {}
    for name in names:
        keys, ix = jax_path(name)
        node = specs
        for k in keys:
            node = node[k]
        out[name] = node[len(ix):]
    return out


# ===========================================================================
# Public API
# ===========================================================================


def _dense_layer(generator, cfg, dtype, device, cross: bool = False):
    """A decoder layer: its MLP is a MoE in the moe family (not in a cross
    layer), as in the reference."""
    d = cfg.d_model

    def ones():
        return torch.ones(d, dtype=dtype, device=device)

    ln1, ln2 = ones(), ones()
    if cfg.attention_type == "mla" and not cross:
        attn_p = attn.mla_init(generator, cfg, dtype, device)
    else:
        attn_p = attn.gqa_init(generator, cfg, dtype, device)
    if cfg.family == "moe" and not cross:
        return DecoderLayer(ln1, ln2, attn_p,
                            moe=moe_mod.moe_init(generator, cfg, dtype,
                                                 device))
    mlp = SwiGLU(dense_init(generator, d, cfg.d_ff, dtype, device=device),
                 dense_init(generator, d, cfg.d_ff, dtype, device=device),
                 dense_init(generator, cfg.d_ff, d, dtype, device=device))
    if cross:
        return CrossLayer(ln1, ln2, attn_p, mlp,
                          torch.zeros((), dtype=torch.float32, device=device))
    return DecoderLayer(ln1, ln2, attn_p, mlp)


def _whisper_init(generator, cfg, dtype, device) -> WhisperLM:
    d = cfg.d_model

    def ones():
        return torch.ones(d, dtype=dtype, device=device)

    def zeros():
        return torch.zeros(d, dtype=dtype, device=device)

    def mlp():
        return GeluMLP(
            dense_init(generator, d, cfg.d_ff, dtype, device=device),
            dense_init(generator, cfg.d_ff, d, dtype, device=device))

    def gqa():
        return attn.gqa_init(generator, cfg, dtype, device)

    enc = [WhisperEncLayer(ones(), zeros(), ones(), zeros(), gqa(), mlp())
           for _ in range(cfg.encoder_layers)]
    dec = [WhisperDecLayer(ones(), zeros(), ones(), zeros(), ones(), zeros(),
                           gqa(), gqa(), mlp())
           for _ in range(cfg.decoder_layers)]
    return WhisperLM(
        cfg, embed_init(generator, cfg.padded_vocab, d, dtype, device=device),
        embed_init(generator, cfg.encoder_seq, d, dtype, device=device),
        embed_init(generator, cfg.max_seq, d, dtype, device=device),
        enc, dec, ones(), zeros(), ones(), zeros(),
        dense_init(generator, d, cfg.padded_vocab, dtype, device=device))


def init_params(cfg, generator: torch.Generator | None = None,
                device="cuda"
                ) -> DenseLM | VisionLM | RWKVLM | HybridLM | WhisperLM:
    """Random weights from ``generator`` (a fresh one seeded 0 if None),
    made on ``device``: the reference's distributions, not its numbers.
    A vlm cross layer's ``xattn_gate`` is 0, as in the reference.  On
    ``meta`` nothing is allocated and the generator is never drawn from
    (a generator has no meta device, so a fresh one lives on the CPU): the
    abstract path that sizes a model without its weights."""
    require_ported(cfg)
    dtype = _dtype(cfg)
    if generator is None:
        gen_device = "cpu" if torch.device(device).type == "meta" else device
        generator = torch.Generator(device=gen_device).manual_seed(0)
    if cfg.family == "audio":
        return _whisper_init(generator, cfg, dtype, device)
    d = cfg.d_model
    embed = embed_init(generator, cfg.padded_vocab, d, dtype, device=device)
    final_norm = torch.ones(d, dtype=dtype, device=device)
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = dense_init(generator, d, cfg.padded_vocab, dtype,
                             device=device)
    if cfg.family == "ssm":
        layers = [_rwkv_layer_init(generator, cfg, dtype, device)
                  for _ in range(cfg.n_layers)]
        return RWKVLM(cfg, embed, final_norm, layers, lm_head)
    if cfg.family == "hybrid":
        layers = [MambaLayer(torch.ones(d, dtype=dtype, device=device),
                             m2.mamba2_init(generator, cfg, dtype, device))
                  for _ in range(cfg.n_layers)]
        shared = _dense_layer(generator, cfg, dtype, device)
        return HybridLM(cfg, embed, final_norm, layers, shared, lm_head)
    if cfg.family == "vlm":
        groups = [
            VisionGroup([_dense_layer(generator, cfg, dtype, device)
                         for _ in range(cfg.cross_attn_every - 1)],
                        _dense_layer(generator, cfg, dtype, device,
                                     cross=True))
            for _ in range(cfg.n_layers // cfg.cross_attn_every)]
        return VisionLM(cfg, embed, final_norm, groups, lm_head)
    layers = [_dense_layer(generator, cfg, dtype, device)
              for _ in range(cfg.n_layers)]
    return DenseLM(cfg, embed, final_norm, layers, lm_head)


def forward(params, cfg, tokens, extra=None, positions=None,
            with_aux: bool = False):
    """Teacher-forced logits (B, S, padded_vocab) fp32 (in a split step
    with ``vocab`` split over ``model``, this rank's chunk of the vocab).
    ``extra``: the vlm family's vision states or the audio family's frames,
    (B, T, d).

    with_aux=True returns (logits, moe_aux_loss): the MoE layers' summed
    load-balancing loss in the moe family, 0 for the others."""
    require_ported(cfg)
    aux = None
    with _no_grad_unless_asked(params), \
            tp.gather_params(params, recurse=False):
        tokens = _tokens(params, tokens)
        extra = _extra(params, extra)
        x = _embed(params, cfg, tokens)
        if cfg.family == "audio":
            enc_states = _whisper_encode(params, cfg, extra)
            x = x + params.dec_pos[None, :tokens.shape[1]]
            x, _ = _whisper_dec_stack(params, cfg, x, enc_states,
                                      positions=positions)
            out = _whisper_logits(params, cfg, x)
        else:
            if with_aux and cfg.family == "moe":
                x, _, aux = _decoder_stack(params, cfg, x,
                                           positions=positions,
                                           with_aux=True)
            else:
                x, _ = _stack(params, cfg, x, positions=positions,
                              extra=extra)
            out = _logits(params, cfg, x)
    if not with_aux:
        return out
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=out.device)
    return out, aux


def init_cache(cfg, batch: int, max_seq: int, extra_len: int = 0,
               device="cuda"):
    """Per-layer caches: GQA k/v of ``max_seq`` rows (dense, moe; MLA: the
    latent ``ckv`` and the shared ``krope``; vlm: the
    self layers of each group, ``{"self": [...]}``; audio: the decoder
    layers, plus ``cross`` k/v (L, B, extra_len, Hk, hd) that prefill
    fills), or the RWKV state (ssm: tmix_x, cmix_x (B, d) and wkv (B, h, hd,
    hd), fp32, of no length); hybrid: ``_hybrid_cache``'s Mamba states and
    conv tails, one GQA cache per shared-block invocation and ``idx``."""
    require_ported(cfg)
    dtype = _dtype(cfg)
    if cfg.family == "hybrid":
        return _hybrid_cache(cfg, batch, max_seq, dtype, device)

    def gqa(n):
        one = (attn.mla_cache_init if cfg.attention_type == "mla"
               else attn.gqa_cache_init)
        return [one(cfg, batch, max_seq, dtype, device) for _ in range(n)]

    if cfg.family == "ssm":
        return {"layers": [_rwkv_zero_state(cfg, batch, device)
                           for _ in range(cfg.n_layers)]}
    if cfg.family == "vlm":
        return {"layers": [{"self": gqa(cfg.cross_attn_every - 1)}
                           for _ in range(cfg.n_layers
                                          // cfg.cross_attn_every)]}
    if cfg.family == "audio":
        shape = (cfg.decoder_layers, batch, extra_len, cfg.n_kv_heads,
                 cfg.head_dim)
        return {"layers": gqa(cfg.decoder_layers),
                "cross": {n: torch.zeros(shape, dtype=dtype, device=device)
                          for n in "kv"}}
    return {"layers": gqa(cfg.n_layers)}


def prefill(params, cfg, tokens, extra=None, cache=None):
    """Fill the cache with a teacher-forced pass; returns (logits, cache).
    The audio family also projects every decoder layer's cross k/v from the
    encoder states into ``cache["cross"]`` once, for the decode steps."""
    require_ported(cfg)
    tokens = _tokens(params, tokens)
    b, s = tokens.shape
    extra = _extra(params, extra)
    if cache is None:
        cache = init_cache(cfg, b, cfg.max_seq,
                           0 if extra is None else extra.shape[1],
                           device=_device(params))
    with _no_grad_unless_asked(params), \
            tp.gather_params(params, recurse=False):
        positions = torch.arange(s, device=tokens.device)[None, :]
        x = _embed(params, cfg, tokens)
        if cfg.family == "audio":
            enc_states = _whisper_encode(params, cfg, extra)
            cross = _whisper_cross(params, cfg, enc_states, cache["cross"])
            x = x + params.dec_pos[None, :s]
            x, new_l = _whisper_dec_stack(params, cfg, x, None,
                                          positions=positions,
                                          caches=cache["layers"], cross=cross)
            return _whisper_logits(params, cfg, x), {"layers": new_l,
                                                     "cross": cross}
        if cfg.family == "hybrid":
            x, new_c = _hybrid_stack(params, cfg, x, positions=positions,
                                     cache=cache)
            return _logits(params, cfg, x), new_c
        x, new_l = _stack(params, cfg, x, positions=positions,
                          caches=cache["layers"], extra=extra)
        return _logits(params, cfg, x), {"layers": new_l}


def _cache_idx(cfg, cache) -> int:
    if cfg.family == "hybrid":
        return cache["idx"]
    if cfg.family == "vlm":
        return cache["layers"][0]["self"][0]["idx"]
    return cache["layers"][0]["idx"]


def decode_step(params, cfg, token, cache, extra=None):
    """token: (B, 1); one serving step against the cache.  A vlm step
    projects the cross k/v from ``extra`` again in each cross layer; an
    audio step reads them from ``cache["cross"]``."""
    require_ported(cfg)
    token = _tokens(params, token)
    b = token.shape[0]
    with _no_grad_unless_asked(params), \
            tp.gather_params(params, recurse=False):
        positions = None
        if cfg.family != "ssm":
            positions = torch.full((b, 1), _cache_idx(cfg, cache),
                                   dtype=torch.int64, device=token.device)
        x = _embed(params, cfg, token)
        if cfg.family == "audio":
            x = x + params.dec_pos[positions]
            x, new_l = _whisper_dec_stack(params, cfg, x, None,
                                          positions=positions,
                                          caches=cache["layers"],
                                          cross=cache["cross"])
            return _whisper_logits(params, cfg, x), {
                "layers": new_l, "cross": cache["cross"]}
        if cfg.family == "hybrid":
            x, new_c = _hybrid_stack(params, cfg, x, positions=positions,
                                     cache=cache)
            return _logits(params, cfg, x), new_c
        x, new_l = _stack(params, cfg, x, positions=positions,
                          caches=cache["layers"],
                          extra=_extra(params, extra))
        return _logits(params, cfg, x), {"layers": new_l}
