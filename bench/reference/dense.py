"""Plain reference of a dense decoder (GQA attention with RoPE, SwiGLU MLP,
pre-RMS-norm, untied head) and of its AdamW training, in fp32.

The weights are the bench's (``leaves`` names and shapes them; the harness
hands the same tensors to the program): a projection is (in, *out), applied
as ``x @ w``.  Everything is recomputed from those weights and the tokens:

    x = embed[tokens]
    per layer:  x += wo( attn( rope(q), rope(k), v ) )   over rms(x)·ln1
                x += down( silu(gate(h)) · up(h) )        h = rms(x)·ln2
    logits = rms(x)·final_norm @ lm_head;  loss = CE + z · mean(lse²)

Query head i reads key/value head i // (heads / kv_heads).  Attention runs
in blocks of query rows against the keys up to the block's last row, so no
whole (S, S) matrix is held; training recomputes each layer in its backward
(``torch.utils.checkpoint``), which changes no value.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference.common import (
    Precision, adamw_step, exact_fp32, lm_loss, rms_norm, rope,
)

#: query rows per attention block
Q_BLOCK = 512


def leaves(m: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, dtype) of every weight, in the order they are drawn."""
    d, h, hk, hd, f, v = (m["d_model"], m["n_heads"], m["n_kv_heads"],
                          m["head_dim"], m["d_ff"], m["vocab_size"])
    dt = m["dtype"]
    out = [("embed", (v, d), dt), ("final_norm", (d,), dt),
           ("lm_head", (d, v), dt)]
    for i in range(m["n_layers"]):
        p = f"layers.{i}."
        out += [(p + "ln1", (d,), dt), (p + "ln2", (d,), dt),
                (p + "attn.wq", (d, h, hd), dt),
                (p + "attn.wk", (d, hk, hd), dt),
                (p + "attn.wv", (d, hk, hd), dt),
                (p + "attn.wo", (h * hd, d), dt),
                (p + "mlp.gate", (d, f), dt), (p + "mlp.up", (d, f), dt),
                (p + "mlp.down", (f, d), dt)]
    return out


def _attention(q, k, v, prec: Precision):
    """Causal attention of q (B, S, H, D) against k, v (B, S, Hk, D)."""
    b, s, h, d = q.shape
    hk = k.shape[2]
    g = h // hk
    qg = q.reshape(b, s, hk, g, d).permute(0, 2, 3, 1, 4)   # B Hk G S D
    kt = k.permute(0, 2, 1, 3)                               # B Hk S D
    vt = v.permute(0, 2, 1, 3)
    outs = []
    for a in range(0, s, Q_BLOCK):
        e = min(a + Q_BLOCK, s)
        kk, vv = kt[:, :, None, :e], vt[:, :, None, :e]
        logits = prec.mm(qg[:, :, :, a:e], kk.transpose(-1, -2)) * d ** -0.5
        rows = torch.arange(a, e, device=q.device)[:, None]
        cols = torch.arange(e, device=q.device)[None, :]
        logits = logits.masked_fill(cols > rows, float("-inf"))
        outs.append(prec.mm(torch.softmax(logits, dim=-1), vv))
    o = torch.cat(outs, dim=3)                               # B Hk G S D
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, h * d)


def _layer(x, w: dict, p: str, m: dict, prec: Precision):
    b, s, dm = x.shape
    h, hk, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    eps = m["norm_eps"]
    n = rms_norm(x, w[p + "ln1"].float(), eps)
    q = prec.mm(n, w[p + "attn.wq"].float().reshape(dm, h * hd))
    k = prec.mm(n, w[p + "attn.wk"].float().reshape(dm, hk * hd))
    v = prec.mm(n, w[p + "attn.wv"].float().reshape(dm, hk * hd))
    q = rope(q.view(b, s, h, hd), m["rope_theta"])
    k = rope(k.view(b, s, hk, hd), m["rope_theta"])
    x = x + prec.mm(_attention(q, k, v.view(b, s, hk, hd), prec),
                    w[p + "attn.wo"].float())
    n = rms_norm(x, w[p + "ln2"].float(), eps)
    mlp = F.silu(prec.mm(n, w[p + "mlp.gate"].float())) \
        * prec.mm(n, w[p + "mlp.up"].float())
    return x + prec.mm(mlp, w[p + "mlp.down"].float())


def loss(w: dict, m: dict, tokens, labels, z_loss_coef: float,
         prec: Precision, remat: bool = False) -> torch.Tensor:
    """The loss of (B, S) ``tokens`` against ``labels``, in fp32."""
    x = w["embed"][tokens].float()
    for i in range(m["n_layers"]):
        p = f"layers.{i}."
        if remat:
            x = checkpoint(_layer, x, w, p, m, prec, use_reentrant=False)
        else:
            x = _layer(x, w, p, m, prec)
    h = rms_norm(x, w["final_norm"].float(), m["norm_eps"])
    return lm_loss(prec.mm(h, w["lm_head"].float()), labels, z_loss_coef)


def score(w: dict, m: dict, batch: dict, z_loss_coef: float,
          prec: Precision) -> float:
    with exact_fp32(), torch.no_grad():
        return float(loss(w, m, batch["tokens"], batch["labels"],
                          z_loss_coef, prec))


def train(initial, m: dict, batches: list, microbatches: int, opt: dict,
          z_loss_coef: float, prec: Precision) -> dict:
    """AdamW steps from ``initial()`` (a fresh dict of the starting
    weights) over ``batches``, one step each, in fp32; the parameters keep
    the configuration's stored dtype between steps.  Returns each step's
    loss, each leaf's first clipped gradient norm and each leaf's change
    norm after the last step."""
    store = getattr(torch, m["dtype"])
    with exact_fp32():
        params = {n: t.float().requires_grad_() for n, t in initial().items()}
        mom = {n: torch.zeros_like(p) for n, p in params.items()}
        vel = {n: torch.zeros_like(p) for n, p in params.items()}
        losses, first = [], None
        for step, batch in enumerate(batches):
            rows = batch["tokens"].shape[0] // microbatches
            total = 0.0
            for j in range(microbatches):
                sl = slice(j * rows, (j + 1) * rows)
                lo = loss(params, m, batch["tokens"][sl], batch["labels"][sl],
                          z_loss_coef, prec, remat=True) / microbatches
                lo.backward()
                total += float(lo.detach())
            losses.append(total)
            grads = {n: p.grad for n, p in params.items()}
            norms = adamw_step({n: p.data for n, p in params.items()}, grads,
                               mom, vel, opt, step, store)
            for p in params.values():
                p.grad = None
            del grads
            if first is None:
                first = norms
        del mom, vel
        start = initial()
        change = {n: float(torch.linalg.vector_norm(
            p.detach() - start[n].float())) for n, p in params.items()}
    return {"losses": losses, "grad_norms": first, "change_norms": change}
