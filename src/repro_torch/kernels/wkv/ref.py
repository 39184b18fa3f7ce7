"""Plain torch oracle for the WKV recurrence (RWKV6 core).

    o_t = r_t^T S_{t-1} + (u ⊙ r_t)·k_t v_t
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
"""
from __future__ import annotations

import torch


def wkv_ref(r, k, v, w, u, state):
    """r,k,v,w: (BH, S, D) fp32; u: (BH, D); state: (BH, D, D).

    A loop over t, in fp32.  Returns (o: (BH, S, D), final state)."""
    S = state.to(torch.float32)
    r, k, v, w = (t.to(torch.float32) for t in (r, k, v, w))
    u = u.to(torch.float32)
    outs = []
    for t in range(r.shape[1]):
        r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], w[:, t]
        o_t = torch.einsum("bk,bkv->bv", r_t, S) + \
            ((r_t * u * k_t).sum(-1, keepdim=True)) * v_t
        S = w_t[..., None] * S + k_t[..., None] * v_t[:, None, :]
        outs.append(o_t)
    return torch.stack(outs, dim=1), S
