"""Where a step's time goes on the card, from a ``torch.profiler`` trace.

The JAX package's ``launch/hlo_analysis.py`` parses the compiled XLA HLO
text of a step and scales each while body by its trip count.  The port has
no HLO: its steps are eager PyTorch, and what it can read is a profiler
trace of a run.  A trace already holds every launch, so nothing is scaled;
and it holds what HLO cannot: device time and the host's gaps.

``analyze(trace)`` takes a finished ``torch.profiler.profile`` or the
Chrome-trace JSON it exports (a path or the loaded dict) and returns:
  * ``time_by_category_us`` — device time of the port's own kernels
    (``OWN_KERNELS``, each by name in ``own_kernels_us``), library products
    (cuBLAS / CUTLASS gemm and gemv), other kernels (elementwise,
    reductions, copies run as kernels), NCCL, and memcpy / memset;
  * ``launches`` — device events per kernel name;
  * ``busy_share`` / ``idle_share`` — the union of device events over the
    traced window, and ``idle_gaps``, the longest gaps in that union with
    the host op (``cpu_op``) that overlapped each most;
  * ``flops_by_op`` — FLOPs per aten op where the profiler recorded them
    (``with_flops=True``; from the events of a profile, or from ``flops``
    in a JSON event's args);
  * ``collectives`` — count and bytes by type from ``record_param_comms``
    events, under the reference's collective names.
HBM bytes are not in a trace, so they are left out rather than estimated.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from collections import defaultdict

#: the port's hand-written CUDA kernels, by function name
OWN_KERNELS = (
    "ta_sm90_kernel", "ta_sm90_combine_kernel", "ta_strip_mapped_kernel",
    "ta_strip_bb_kernel", "ta_strip_combine_kernel", "ta_lam_to_ig_kernel",
    "wkv_states_kernel", "wkv_scan_kernel", "wkv_outputs_kernel",
    "dm_map_peel_kernel", "dm_map_digits_kernel",
    "dm_membership_chain_kernel", "dm_membership_digits_kernel",
)
CATEGORIES = ("own_kernels", "library", "other_kernels", "nccl",
              "memcpy_memset")
_LIBRARY = re.compile(r"gemm|gemv|cutlass|cublas|xmma|nvjet|splitKreduce",
                      re.IGNORECASE)
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: ``record_param_comms``' collective names -> the reference's
COLLECTIVE_NAMES = {
    "allreduce": "all-reduce", "all_reduce": "all-reduce",
    "allreduce_coalesced": "all-reduce",
    "allgather": "all-gather", "all_gather": "all-gather",
    "_allgather_base": "all-gather", "allgather_into_tensor_coalesced":
    "all-gather", "all_gather_into_tensor": "all-gather",
    "reduce_scatter": "reduce-scatter", "_reduce_scatter_base":
    "reduce-scatter", "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all": "all-to-all", "all_to_allv": "all-to-all",
    "alltoall": "all-to-all", "alltoall_base": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv": "collective-permute",
}
_DTYPE_BYTES = {
    "Float": 4, "float": 4, "Double": 8, "double": 8, "Half": 2,
    "BFloat16": 2, "c10::BFloat16": 2, "c10::Half": 2, "Long": 8,
    "Int": 4, "Short": 2, "Char": 1, "Byte": 1, "Bool": 1,
    "Float8_e4m3fn": 1, "Float8_e5m2": 1,
}


def kernel_name(name: str) -> str:
    """A demangled kernel event's function name: ``void ta_sm90_kernel<128,
    ...>(...)`` -> ``ta_sm90_kernel``."""
    n = name.strip().replace("(anonymous namespace)::", "")
    if n.startswith("void "):
        n = n[5:]
    n = re.split(r"[<(]", n, maxsplit=1)[0].strip()
    return n.rsplit("::", 1)[-1]


def category(event: dict) -> str:
    """The device event's category (one of ``CATEGORIES``)."""
    cat = event.get("cat", "")
    name = event.get("name", "")
    if cat in ("gpu_memcpy", "gpu_memset") or name.startswith(
            ("Memcpy", "Memset")):
        return "memcpy_memset"
    if "nccl" in name.lower():
        return "nccl"
    if kernel_name(name) in OWN_KERNELS:
        return "own_kernels"
    if _LIBRARY.search(name):
        return "library"
    return "other_kernels"


def _load(trace) -> tuple[dict, dict]:
    """(Chrome-trace dict, FLOPs by op from a profile's events)."""
    if isinstance(trace, dict):
        return trace, {}
    if isinstance(trace, (str, os.PathLike)):
        with open(trace) as f:
            return json.load(f), {}
    flops: dict[str, float] = defaultdict(float)
    for e in trace.events():
        if getattr(e, "flops", 0):
            flops[e.name] += e.flops
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        trace.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f), dict(flops)
    finally:
        os.remove(path)


def _union(intervals: list[tuple[float, float]]) -> list[list[float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _comm_bytes(args: dict) -> float:
    n = args.get("Out msg nelems", args.get("In msg nelems", 0)) or 0
    return float(n) * _DTYPE_BYTES.get(str(args.get("dtype", "")), 0)


def analyze(trace, top_gaps: int = 3) -> dict:
    data, flops = _load(trace)
    events = [e for e in data.get("traceEvents", []) if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in _DEVICE_CATS]
    host = [e for e in events if e.get("cat") == "cpu_op"]
    window = [e for e in events if e.get("cat") == "Trace"]
    if window:
        t0 = min(float(e["ts"]) for e in window)
        t1 = max(float(e["ts"]) + float(e["dur"]) for e in window)
    elif events:
        t0 = min(float(e["ts"]) for e in events)
        t1 = max(float(e["ts"]) + float(e.get("dur", 0)) for e in events)
    else:
        t0 = t1 = 0.0

    by_cat = {c: 0.0 for c in CATEGORIES}
    own: dict[str, float] = defaultdict(float)
    launches: dict[str, int] = defaultdict(int)
    for e in device:
        dur = float(e.get("dur", 0))
        c = category(e)
        by_cat[c] += dur
        name = (e.get("name", "") if c == "memcpy_memset"
                else kernel_name(e.get("name", "")))
        launches[name] += 1
        if c == "own_kernels":
            own[name] += dur

    busy = _union([(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in device])
    busy_us = sum(e - s for s, e in busy)
    span = t1 - t0
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])

    def host_op(s: float, e: float) -> str | None:
        best, key = None, None
        for h in host:
            hs = float(h["ts"])
            he = hs + float(h.get("dur", 0))
            ov = min(e, he) - max(s, hs)
            if ov > 0 and (key is None or (ov, -(he - hs)) > key):
                best, key = h["name"], (ov, -(he - hs))
        return best

    if not flops:
        for h in host:
            f = (h.get("args") or {}).get("flops")
            if f:
                flops[h["name"]] = flops.get(h["name"], 0.0) + float(f)

    coll = {t: {"count": 0, "bytes": 0.0} for t in
            ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
             "collective-permute")}
    for h in host:
        if h["name"] != "record_param_comms":
            continue
        args = h.get("args") or {}
        kind = COLLECTIVE_NAMES.get(str(args.get("Collective name", "")))
        if kind is None:
            continue
        coll[kind]["count"] += 1
        coll[kind]["bytes"] += _comm_bytes(args)
    coll_total = {"total_bytes": sum(v["bytes"] for v in coll.values()),
                  "total_count": sum(v["count"] for v in coll.values())}

    return {
        "window_us": span,
        "device_busy_us": busy_us,
        "busy_share": busy_us / span if span > 0 else 0.0,
        "idle_share": 1.0 - busy_us / span if span > 0 else 0.0,
        "time_by_category_us": by_cat,
        "own_kernels_us": dict(own),
        "launches": dict(launches),
        "idle_gaps": [{"start_us": s - t0, "dur_us": e - s,
                       "host_op": host_op(s, e)}
                      for s, e in gaps[:top_gaps]],
        "flops_by_op": dict(flops),
        "collectives": {**coll, **coll_total},
    }
