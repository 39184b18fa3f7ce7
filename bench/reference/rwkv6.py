"""Plain reference of the RWKV-6 ("Finch") model the program serves, in fp32.

The weights are the bench's (``leaves`` names and shapes them).  Per layer,
with x̄ = x shifted one position (zeros at the first) and n = rms(x)·ln1:

    time mix:    mix(μ) = n·μ + n̄·(1-μ)
                 r, k, v, g = mix(μ_r) W_r, mix(μ_k) W_k, mix(μ_v) W_v,
                              mix(μ_g) W_g
                 w = exp(-exp(decay_base + tanh(mix(μ_w) W_d1) W_d2))
                 per head: S_t = diag(w_t) S_{t-1} + k_t v_tᵀ,
                           o_t = r_tᵀ S_{t-1} + (u ⊙ r_t)·k_t v_t
                 x += (rms_head(o)·ln_x · silu(g)) W_o
    channel mix: over m = rms(x)·ln2 and its shift, k = relu(mix(μ_k) W_k)²,
                 x += sigmoid(mix(μ_r) W_r) · (k W_v)
    logits = rms(x)·final_norm @ lm_head;  loss = CE + z · mean(lse²)

The WKV is evaluated chunk by chunk (``CHUNK`` positions): inside a chunk
every decay factor is the exp of a non-positive sum of log decays, between
chunks the (D, D) state is carried in order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference.common import Precision, exact_fp32, lm_loss, rms_norm

#: positions per chunk of the reference's WKV
CHUNK = 32
#: the group norm's epsilon (per head, over its D channels)
HEAD_NORM_EPS = 1e-6

TMIX = ("mix_r", "mix_k", "mix_v", "mix_g", "mix_w", "wr", "wk", "wv", "wg",
        "wd1", "wd2", "decay_base", "bonus_u", "wo", "ln_x")


def leaves(m: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, dtype) of every weight, in the order they are drawn."""
    d, f, v, lora = m["d_model"], m["d_ff"], m["vocab_size"], \
        m["rwkv_decay_lora"]
    h = m["rwkv_heads"]
    dt = m["dtype"]
    shapes = {"wd1": (d, lora), "wd2": (lora, d), "bonus_u": (h, d // h)}
    out = [("embed", (v, d), dt), ("final_norm", (d,), dt),
           ("lm_head", (d, v), dt)]
    for i in range(m["n_layers"]):
        p = f"layers.{i}."
        out += [(p + "ln1", (d,), dt), (p + "ln2", (d,), dt)]
        for n in TMIX:
            shape = shapes.get(n, (d, d) if n.startswith("w") else (d,))
            fp32 = n in ("decay_base", "bonus_u")
            out.append((p + "tmix." + n, shape, "float32" if fp32 else dt))
        out += [(p + "cmix.mix_k", (d,), dt), (p + "cmix.mix_r", (d,), dt),
                (p + "cmix.wk", (d, f), dt), (p + "cmix.wv", (f, d), dt),
                (p + "cmix.wr", (d, d), dt)]
    return out


def _shift(x):
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def wkv(r, k, v, w, u, prec: Precision, chunk: int = CHUNK):
    """o (B, S, H, D) of the recurrence over r, k, v, w (B, S, H, D) from a
    zero state, u (H, D)."""
    b, s, h, d = r.shape
    n = s // chunk
    if n * chunk != s:
        raise ValueError(f"sequence {s} is not a multiple of {chunk}")

    def chunks(t):          # (B, S, H, D) -> (B·H, N, C, D)
        return t.permute(0, 2, 1, 3).reshape(b * h, n, chunk, d)

    r, k, v, lw = chunks(r), chunks(k), chunks(v), chunks(torch.log(w))
    cl = torch.cumsum(lw, dim=2)              # log A_t, inclusive
    cl_prev = cl - lw                         # log A_{t-1}
    qr, qk, qv = prec.q(r), prec.q(k), prec.q(v)
    later = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                  device=r.device), diagonal=-1)
    diff = cl_prev[:, :, :, None, :] - cl[:, :, None, :, :]   # (t, s)
    decay = torch.exp(diff.masked_fill(~later[..., None], float("-inf")))
    scores = torch.einsum("bntd,bnsd,bntsd->bnts", qr, qk, decay)
    o = prec.mm(scores, qv)
    uu = u.repeat(b, 1)[:, None, None, :]
    o = o + (r * uu * k).sum(-1, keepdim=True) * v
    state = torch.zeros(b * h, d, d, dtype=r.dtype, device=r.device)
    inter = []
    for c in range(n):
        inter.append(prec.mm(r[:, c] * torch.exp(cl_prev[:, c]), state))
        end = cl[:, c, -1]                                     # (BH, D)
        kd = k[:, c] * torch.exp(end[:, None, :] - cl[:, c])
        state = torch.exp(end)[:, :, None] * state \
            + prec.mm(kd.transpose(1, 2), v[:, c])
    o = o + torch.stack(inter, dim=1)
    return o.reshape(b, h, s, d).permute(0, 2, 1, 3)


def _layer(x, w: dict, p: str, m: dict, prec: Precision):
    b, s, dm = x.shape
    h = m["rwkv_heads"]
    hd = dm // h
    eps = m["norm_eps"]

    def W(name):
        return w[p + name].float()

    n = rms_norm(x, W("ln1"), eps)
    ns = _shift(n)

    def mix(mu):
        return n * mu + ns * (1.0 - mu)

    r = prec.mm(mix(W("tmix.mix_r")), W("tmix.wr"))
    k = prec.mm(mix(W("tmix.mix_k")), W("tmix.wk"))
    v = prec.mm(mix(W("tmix.mix_v")), W("tmix.wv"))
    g = prec.mm(mix(W("tmix.mix_g")), W("tmix.wg"))
    dec = W("tmix.decay_base") + prec.mm(
        torch.tanh(prec.mm(mix(W("tmix.mix_w")), W("tmix.wd1"))),
        W("tmix.wd2"))
    decay = torch.exp(-torch.exp(dec))
    heads = (t.view(b, s, h, hd) for t in (r, k, v, decay))
    o = wkv(*heads, W("tmix.bonus_u"), prec)
    o = rms_norm(o, 1.0, HEAD_NORM_EPS).reshape(b, s, dm)
    x = x + prec.mm(o * W("tmix.ln_x") * F.silu(g), W("tmix.wo"))
    n = rms_norm(x, W("ln2"), eps)
    ns = _shift(n)
    xk = n * W("cmix.mix_k") + ns * (1.0 - W("cmix.mix_k"))
    xr = n * W("cmix.mix_r") + ns * (1.0 - W("cmix.mix_r"))
    kk = torch.square(torch.relu(prec.mm(xk, W("cmix.wk"))))
    return x + torch.sigmoid(prec.mm(xr, W("cmix.wr"))) \
        * prec.mm(kk, W("cmix.wv"))


def loss(w: dict, m: dict, tokens, labels, z_loss_coef: float,
         prec: Precision) -> torch.Tensor:
    x = w["embed"][tokens].float()
    for i in range(m["n_layers"]):
        x = _layer(x, w, f"layers.{i}.", m, prec)
    h = rms_norm(x, w["final_norm"].float(), m["norm_eps"])
    return lm_loss(prec.mm(h, w["lm_head"].float()), labels, z_loss_coef)


def score(w: dict, m: dict, batch: dict, z_loss_coef: float,
          prec: Precision) -> float:
    with exact_fp32(), torch.no_grad():
        return float(loss(w, m, batch["tokens"], batch["labels"],
                          z_loss_coef, prec))
