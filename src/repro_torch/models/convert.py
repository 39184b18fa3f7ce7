"""Load the reference's parameter tree into the port's model.

``params_from_jax(tree, cfg, device)`` takes the reference's
``init_params`` tree with numpy leaves (``jax.tree.map(np.asarray, p)``;
bfloat16 leaves may be ``ml_dtypes`` arrays) and returns a ``DenseLM``
(families ``dense`` and ``moe``), a ``VisionLM`` (``vlm``), an ``RWKVLM``
(``ssm``), a ``HybridLM`` (``hybrid``) or a ``WhisperLM`` (``audio``).  The
reference stacks every layer's weight on a leading ``layers`` axis (``wq``
(L, d, H, hd), ``moe.gate`` (L, d, E, f), ``mamba.in_proj`` (L, d, ...),
``tmix.wr`` (L, d, d), ...); vlm's on ``groups.self.*`` (G, cross_attn_every
- 1, ...) and ``groups.cross.*`` (G, ...); whisper's on ``enc_layers.*`` and
``dec_layers.*`` (L, ...); the hybrid family's ``shared`` block is not
stacked.  Each slice becomes one layer module.  Layouts are kept as they
are, so the two packages compute the same products on the same numbers.

``params_to_jax(model, cfg)`` is the inverse: the reference's stacked tree,
numpy leaves (a bfloat16 leaf as raw 2-byte words, ``np.dtype("V2")``: this
package does not need ``ml_dtypes``).  ``to_jax_tree`` maps any dict keyed
by the model's parameter names (the optimizer's moments) the same way, and
``jax_path`` names the reference leaf and the slice of it that one port
parameter is; ``from_numpy`` reads a leaf back.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rwkv
from repro_torch.models.common import SwiGLU, jax_path
from repro_torch.models import transformer as T


def from_numpy(a, device) -> torch.Tensor:
    """A numpy leaf as a tensor on ``device``; a bfloat16 leaf
    (``ml_dtypes`` or raw 2-byte words, ``V2``) by reinterpreting its
    bits."""
    a = np.array(a)          # a writable, contiguous copy
    if a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2"):
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def to_jax_tree(named: dict) -> dict:
    """{port parameter name: tensor or numpy array} -> the reference's
    nested dict, each layer's slices stacked on the leading axes; numpy
    leaves."""
    slices: dict = {}
    for name, t in named.items():
        keys, ix = jax_path(name)
        a = t if isinstance(t, np.ndarray) else to_numpy(t)
        slices.setdefault(keys, []).append((ix, a))
    tree: dict = {}
    for keys, parts in slices.items():
        if parts[0][0] == ():
            leaf = parts[0][1]
        else:
            shape = tuple(max(ix[a] for ix, _ in parts) + 1
                          for a in range(len(parts[0][0])))
            leaf = np.empty(shape + parts[0][1].shape, parts[0][1].dtype)
            for ix, a in parts:
                leaf[ix] = a
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return tree


def params_to_jax(model, cfg) -> dict:
    """The reference's ``init_params`` tree for ``model``, numpy leaves."""
    T.require_ported(cfg)
    return to_jax_tree(dict(model.named_parameters()))


def params_from_jax(tree, cfg, device="cuda"):
    T.require_ported(cfg)

    def t(a):
        return from_numpy(a, device)

    if cfg.family == "ssm":
        return _rwkv_from_jax(tree, cfg, t)
    if cfg.family == "audio":
        return _whisper_from_jax(tree, cfg, t)
    if cfg.family == "hybrid":
        return _hybrid_from_jax(tree, cfg, t)
    lm_head = None if cfg.tie_embeddings else t(tree["lm_head"])
    if cfg.family == "vlm":
        G = tree["groups"]
        groups = [
            T.VisionGroup(
                [_decoder_layer(G["self"], (g, i), t)
                 for i in range(cfg.cross_attn_every - 1)],
                _decoder_layer(G["cross"], (g,), t, cross=True))
            for g in range(cfg.n_layers // cfg.cross_attn_every)]
        return T.VisionLM(cfg, t(tree["embed"]), t(tree["final_norm"]),
                          groups, lm_head)
    layers = [_decoder_layer(tree["layers"], (i,), t)
              for i in range(cfg.n_layers)]
    return T.DenseLM(cfg, t(tree["embed"]), t(tree["final_norm"]), layers,
                     lm_head)


def _gqa(la, ix, t) -> attn.GQAAttention | attn.MLAAttention:
    if "wkr" in la:                        # MLA (deepseek-v2)
        return attn.MLAAttention(*(t(la[n][ix]) for n in attn.MLA_NAMES))
    norms = {n: t(la[n][ix]) for n in ("q_norm", "k_norm") if n in la}
    return attn.GQAAttention(*(t(la[n][ix]) for n in ("wq", "wk", "wv", "wo")),
                             **norms)


def _swiglu(m, ix, t) -> SwiGLU:
    return SwiGLU(t(m["gate"][ix]), t(m["up"][ix]), t(m["down"][ix]))


def _decoder_layer(L, ix, t, cross: bool = False):
    """The layer at index ``ix`` of the stacked tree ``L`` (``ix = ()``: an
    unstacked one, the hybrid family's shared block)."""
    ln1, ln2, a = t(L["ln1"][ix]), t(L["ln2"][ix]), _gqa(L["attn"], ix, t)
    if "moe" in L:
        m = L["moe"]
        shared = _swiglu(m["shared"], ix, t) if "shared" in m else None
        return T.DecoderLayer(ln1, ln2, a, moe=moe_mod.MoE(
            *(t(m[n][ix]) for n in ("router", "gate", "up", "down")),
            shared))
    if cross:
        return T.CrossLayer(ln1, ln2, a, _swiglu(L["mlp"], ix, t),
                            t(L["xattn_gate"][ix]))
    return T.DecoderLayer(ln1, ln2, a, _swiglu(L["mlp"], ix, t))


def _hybrid_from_jax(tree, cfg, t) -> T.HybridLM:
    L = tree["layers"]
    layers = [T.MambaLayer(t(L["ln"][i]), m2.Mamba2(
        **{n: t(L["mamba"][n][i]) for n in m2.MAMBA2_NAMES}))
        for i in range(cfg.n_layers)]
    return T.HybridLM(cfg, t(tree["embed"]), t(tree["final_norm"]), layers,
                      _decoder_layer(tree["shared"], (), t),
                      t(tree["lm_head"]))


def _whisper_from_jax(tree, cfg, t) -> T.WhisperLM:
    E, D = tree["enc_layers"], tree["dec_layers"]

    def mlp(L, i):
        return T.GeluMLP(t(L["mlp"]["up"][i]), t(L["mlp"]["down"][i]))

    def ln(L, name, i):
        return t(L[name + "_w"][i]), t(L[name + "_b"][i])

    enc = [T.WhisperEncLayer(*ln(E, "ln1", i), *ln(E, "ln2", i),
                             _gqa(E["attn"], i, t), mlp(E, i))
           for i in range(cfg.encoder_layers)]
    dec = [T.WhisperDecLayer(*ln(D, "ln1", i), *ln(D, "lnx", i),
                             *ln(D, "ln2", i), _gqa(D["attn"], i, t),
                             _gqa(D["xattn"], i, t), mlp(D, i))
           for i in range(cfg.decoder_layers)]
    return T.WhisperLM(
        cfg, t(tree["embed"]), t(tree["enc_pos"]), t(tree["dec_pos"]), enc,
        dec, t(tree["enc_norm_w"]), t(tree["enc_norm_b"]),
        t(tree["final_norm"]), t(tree["final_norm_b"]), t(tree["lm_head"]))


def _rwkv_from_jax(tree, cfg, t) -> T.RWKVLM:
    L = tree["layers"]
    tm, cm = L["tmix"], L["cmix"]
    layers = [
        T.RWKVLayer(
            t(L["ln1"][i]), t(L["ln2"][i]),
            rwkv.RWKVTimeMix(**{n: t(tm[n][i]) for n in rwkv.TMIX_NAMES}),
            rwkv.RWKVChannelMix(**{n: t(cm[n][i]) for n in rwkv.CMIX_NAMES}))
        for i in range(cfg.n_layers)]
    return T.RWKVLM(cfg, t(tree["embed"]), t(tree["final_norm"]), layers,
                    t(tree["lm_head"]))
