#!/usr/bin/env python3
"""Device times of the port's attention entry point against SDPA on one GPU.

    PYTHONPATH=src python3 attn_times.py
    PYTHONPATH=<other tree>/src python3 attn_times.py   # time that tree

At yi-6b's heads, (B, H, Hk, S, D) = (1, 32, 4, 4096, 128), it times
``repro_torch.kernels.tri_attn.ops.causal_attention`` on the simt route's
cases at that size (bf16 at block 64, fp32 at blocks 128, 64 and 32) in both
grid modes, and ``scaled_dot_product_attention`` on the same inputs: device
ms of one call, from CUDA events around calls issued back to back while the
card is held busy.  It uses only the entry point that every tree of the port has,
so the same script times a parent commit unpacked with ``git archive``.
Prints the card and one JSON line a case; exits 2 without a card.
"""
import json
import subprocess
import sys

SHAPE = (1, 32, 4, 4096, 128)
CASES = (("bfloat16", 64), ("float32", 128), ("float32", 64),
         ("float32", 32))
REPS = 5


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
    return 0


if __name__ == "__main__":
    sys.exit(main())
