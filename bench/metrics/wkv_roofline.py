"""``wkv_roofline``: least time over measured device time of
``kernels/wkv/ops.py``'s ``wkv_chunked`` (which ``models/rwkv6.py`` looks up
at call time), in %.  Least time: the larger of the chunked WKV's work at
the peak of r's dtype and r, k, v, w, u and the state read, o and the state
written once at 3.35 TB/s."""
from bench import arith, readers

SPANS = {"wkv": "repro_torch.kernels.wkv.ops:wkv_chunked"}


def cost(call, backward: bool):
    if backward:
        raise ValueError("no backward is counted for wkv_chunked")
    shape, dtype = call["tensors"][0]
    if len(shape) == 4:                 # (B, S, H, D)
        b, s, h, d = shape
        bh = b * h
    else:                               # (B·H, S, D)
        bh, s, d = shape
    args = call["args"]
    chunk = call["kwargs"].get("chunk", args[0] if args else 64)
    out = call["kwargs"].get("out_dtype") or dtype
    return (*arith.wkv_chunked(bh, s, d, chunk, dtype, out), dtype)


def read(ctx):
    return readers.roofline(ctx, "wkv", cost)
