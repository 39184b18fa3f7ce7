#!/usr/bin/env python3
"""Device times of the port's attention entry point against SDPA on one GPU.

    PYTHONPATH=src python3 attn_times.py
    PYTHONPATH=<other tree>/src python3 attn_times.py   # time that tree

At yi-6b's heads, (B, H, Hk, S, D) = (1, 32, 4, 4096, 128), it times
``repro_torch.kernels.tri_attn.ops.causal_attention`` on the simt route's
cases at that size (bf16 at block 64, fp32 at blocks 128, 64 and 32) in both
grid modes, and ``scaled_dot_product_attention`` on the same inputs: device
ms of one call, from CUDA events around calls issued back to back while the
card is held busy.  Then the backward at that shape on the sm90 route (bf16,
block 128, the training call): the entry's autograd node alone (its graph
kept, ``torch.autograd.grad`` again and again) in both modes, beside its
least time (``tri_attn_backward``: 275 GFLOP at 989 TFLOP/s, 0.278 ms), the
oracle's fp32 vjp that the node ran before it had a kernel (``plain_ms``)
and SDPA's backward (``library_ms``, a yardstick only).  It uses only the
entry point that every tree of the port has, so the same script times a
parent commit unpacked with ``git archive``.  Prints the card and one JSON
line a case; exits 2 without a card.
"""
import json
import subprocess
import sys

SHAPE = (1, 32, 4, 4096, 128)
CASES = (("bfloat16", 64), ("float32", 128), ("float32", 64),
         ("float32", 32))
REPS = 5
#: the backward's counted work at SHAPE (dV, dP, dQ, dK over the causal
#: pairs, twice the forward's 137.5 GFLOP) at 989 TFLOP/s, in ms
BACKWARD_BOUND_MS = 2 * 2 * 2 * 128 * (4096 * 4097 // 2) * 32 / 989e12 * 1e3


def device_ms(torch, fn, n: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def backward_row(torch, causal_attention, causal_attention_ref, AK) -> dict:
    """The sm90 route's backward at SHAPE: device ms of the autograd node's
    backward in both modes, the oracle's vjp and SDPA's backward."""
    b, h, hk, s, d = SHAPE
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v, g = (torch.randn((b, n, s, d), generator=gen, device="cuda")
                  .to(torch.bfloat16).requires_grad_() for n in (h, hk, hk, h))
    g = g.detach()

    def node(out):
        return lambda: torch.autograd.grad(out, (q, k, v), g,
                                           retain_graph=True)

    ref = causal_attention_ref(q.float(), k.float().repeat_interleave(
        h // hk, 1), v.float().repeat_interleave(h // hk, 1))
    want = torch.autograd.grad(ref, (q, k, v), g.float(), retain_graph=True)
    row = {"backward": True, "dtype": "bfloat16", "block": 128,
           "shape": [b, h, hk, s, d],
           "route": AK.attention_route(torch.bfloat16, 128, d),
           "bound_ms": BACKWARD_BOUND_MS}
    for mode in ("mapped", "bounding_box"):
        out = causal_attention(q, k, v, 128, 128, mode)
        n0 = getattr(AK, "ATTN_BWD_LAUNCHES", 0)
        got = node(out)()
        row[mode] = {
            "backward_launches_a_call": getattr(AK, "ATTN_BWD_LAUNCHES", 0)
            - n0,
            "max_rel_err": [float((a.float() - w.float()).abs().max()
                                  / w.float().abs().max())
                            for a, w in zip(got, want)],
            "device_ms": [device_ms(torch, node(out), n=5)
                          for _ in range(REPS)]}
        del out, got
    row["plain_ms"] = [device_ms(torch, node(ref), n=2) for _ in range(2)]
    del ref, want
    out = sdpa(q, k, v, is_causal=True, enable_gqa=True)
    row["library_ms"] = [device_ms(torch, node(out)) for _ in range(REPS)]
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("attn_times: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels.tri_attn import kernel as AK
    from repro_torch.kernels.tri_attn.ops import causal_attention
    from repro_torch.kernels.tri_attn.ref import causal_attention_ref

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    b, h, hk, s, d = SHAPE
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(3)
    for dname, blk in CASES:
        dtype = getattr(torch, dname)
        q, k, v = (torch.randn((b, n, s, d), generator=gen, device="cuda")
                   .to(dtype) for n in (h, hk, hk))
        want = causal_attention_ref(q, k.repeat_interleave(h // hk, 1),
                                    v.repeat_interleave(h // hk, 1)).float()
        row = {"dtype": dname, "block": blk, "shape": [b, h, hk, s, d],
               "route": AK.attention_route(dtype, blk, d)}
        for mode in ("mapped", "bounding_box"):
            n0 = AK.ATTN_LAUNCHES
            err = float((causal_attention(q, k, v, blk, blk, mode).float()
                         - want).abs().max())
            row[mode] = {
                "launches_a_call": AK.ATTN_LAUNCHES - n0,
                "max_abs_err": err,
                "device_ms": [device_ms(torch, lambda m=mode: causal_attention(
                    q, k, v, blk, blk, m)) for _ in range(REPS)]}
        row["sdpa_device_ms"] = [device_ms(torch, lambda: sdpa(
            q, k, v, is_causal=True, enable_gqa=True)) for _ in range(REPS)]
        print(json.dumps(row), flush=True)
        del q, k, v, want
    print(json.dumps(backward_row(torch, causal_attention,
                                  causal_attention_ref, AK)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
