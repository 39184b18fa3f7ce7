"""Load the reference's parameter tree into the port's model.

``params_from_jax(tree, cfg, device)`` takes the reference's
``init_params`` tree with numpy leaves (``jax.tree.map(np.asarray, p)``;
bfloat16 leaves may be ``ml_dtypes`` arrays) and returns a ``DenseLM``
(family ``dense``) or an ``RWKVLM`` (family ``ssm``).  The reference stacks
every layer's weight on a leading ``layers`` axis (``wq`` (L, d, H, hd),
``tmix.wr`` (L, d, d), ...); each slice becomes one ``DecoderLayer`` or
``RWKVLayer``.  Layouts are kept as they are, so the two packages compute
the same products on the same numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import attention as attn
from repro_torch.models import rwkv6 as rwkv
from repro_torch.models import transformer as T


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)          # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree, cfg, device="cuda") -> T.DenseLM | T.RWKVLM:
    T.require_ported(cfg)
    L = tree["layers"]

    def t(a):
        return _tensor(a, device)

    if cfg.family == "ssm":
        return _rwkv_from_jax(tree, cfg, t)
    la, lm = L["attn"], L["mlp"]
    layers = []
    for i in range(cfg.n_layers):
        norms = {}
        if cfg.qk_norm:
            norms = {"q_norm": t(la["q_norm"][i]),
                     "k_norm": t(la["k_norm"][i])}
        layers.append(T.DecoderLayer(
            t(L["ln1"][i]), t(L["ln2"][i]),
            attn.GQAAttention(t(la["wq"][i]), t(la["wk"][i]), t(la["wv"][i]),
                              t(la["wo"][i]), **norms),
            T.SwiGLU(t(lm["gate"][i]), t(lm["up"][i]), t(lm["down"][i]))))
    lm_head = None if cfg.tie_embeddings else t(tree["lm_head"])
    return T.DenseLM(cfg, t(tree["embed"]), t(tree["final_norm"]), layers,
                     lm_head)


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
