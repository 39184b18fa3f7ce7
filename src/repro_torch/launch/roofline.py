"""Roofline terms of the dry-run records (``launch/dryrun.py --arch``) on
an H100 mesh: the JAX package's ``launch/roofline.py`` with the H100's
data-sheet rates (``core/energy.py``) in place of the TPU constants.

Per (arch x shape) single-pod cell, per device:
    compute term    = step FLOPs per device / peak bf16 FLOP/s      [s]
    memory term     = unfused bytes per device / HBM B/s            [s]
                      (pessimistic: every aten op's operands and result,
                      as if nothing were fused)
    memory term*    = analytic_bytes / (chips x HBM B/s)            [s]
                      (idealized)
    collective term = collective bytes per device / link B/s        [s]

Step numbers are rank 0's of the port's step under fake tensors, each
launch counted (there are no loops to scale).  MODEL_FLOPS = 6·N_active·D
(train) or 2·N_active·D (inference) + the mapped attention FLOPs; the
useful-compute ratio is MODEL_FLOPS / (chips x step FLOPs per device),
which shows the port's replication along ``model`` (ROADMAP queue 1 item
9c).  The roofline fraction is MODEL_FLOPS / (chips · peak · max(term)).
A term whose input a record lacks is absent (``None``), not zero.

    PYTHONPATH=src python -m repro_torch.launch.roofline --dir results/dryrun
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.core.energy import (
    H100_BF16_FLOPS, H100_HBM_BW, H100_IB_NDR_BW,
)

PEAK_FLOPS = H100_BF16_FLOPS     # dense bf16 FLOP/s per card
HBM_BW = H100_HBM_BW             # B/s per card
LINK_BW = H100_IB_NDR_BW         # B/s per card across nodes
CHIPS = 256                      # single-pod roofline


def bottleneck_hint(row: dict) -> str:
    dom = row["dominant"]
    if dom == "collective":
        if "moe" in row.get("family", "") or (row.get("all_to_all") or 0) > 0:
            return ("shrink EP all-to-all payloads (bf16 dispatch, "
                    "capacity-factor cut) or overlap with expert compute")
        return ("FSDP all-gathers dominate — raise per-step arithmetic "
                "intensity (bigger microbatch) or switch embed to 1D TP")
    if dom == "memory":
        if row["kind"] == "decode":
            return ("decode is cache-bandwidth-bound by nature — fuse cache "
                    "read+attend (flash-decode kernel), quantize KV to int8")
        return ("materialized attention logits dominate memory traffic — "
                "the mapped-grid tri_attn kernel keeps them on chip")
    if row["kind"] == "train":
        return ("compute-bound — recover the causal-waste half with the "
                "mapped triangular grid, cut remat recompute and split the "
                "replicated compute over `model` (item 9c)")
    return "compute-bound — batch decode further or widen TP"


def _div(num, den):
    return None if num is None else num / den


def load_rows(dry_dir: str, multi_pod: bool = False,
              profile: str = "") -> list[dict]:
    rows = []
    suffix = ("mp" if multi_pod else "sp") + (f"__{profile}" if profile
                                              else "")
    for path in sorted(glob.glob(os.path.join(dry_dir, f"*__{suffix}.json"))):
        if not profile and "__optimized" in path:
            continue
        with open(path) as f:
            r = json.load(f)
        if r.get("status") != "ok":
            if r.get("status") == "skipped":
                rows.append({"arch": r["arch"], "shape": r["shape"],
                             "status": "skipped", "reason": r["reason"]})
            continue
        st = r.get("step", {})
        a = r.get("analytic", {})
        coll = st.get("collectives", {})
        flops_dev = st.get("flops_per_device")
        t_c = _div(flops_dev, PEAK_FLOPS)
        t_m = _div(st.get("unfused_bytes_per_device"), HBM_BW)
        t_m_ideal = _div(a.get("analytic_bytes"), CHIPS * HBM_BW)
        t_n = _div(coll.get("total_bytes"), LINK_BW)
        terms = {k: v for k, v in (("compute", t_c), ("memory", t_m),
                                   ("collective", t_n)) if v is not None}
        dominant = max(terms, key=terms.get) if terms else None
        model_flops = a.get("model_flops", 0.0) + a.get("attn_flops_mapped",
                                                        0.0)
        step_global = None if flops_dev is None else flops_dev * CHIPS
        useful = model_flops / step_global if step_global else None
        step_time = max(terms.values()) if terms else 0.0
        frac = (model_flops / (CHIPS * PEAK_FLOPS * step_time)
                if step_time else None)
        peak = r.get("memory", {}).get("peak_bytes")
        rows.append({
            "arch": r["arch"], "shape": r["shape"], "kind": r["kind"],
            "family": r.get("family", ""), "status": "ok",
            "t_compute": t_c, "t_memory": t_m, "t_memory_ideal": t_m_ideal,
            "t_collective": t_n, "dominant": dominant,
            "model_flops": model_flops, "step_flops_global": step_global,
            "useful_ratio": useful, "roofline_fraction": frac,
            "all_to_all": coll.get("all-to-all", {}).get("bytes"),
            "mem_gb": None if peak is None else peak / 1e9,
        })
    return rows


def fmt(v) -> str:
    if v is None:
        return "—"
    if v == 0:
        return "0"
    if v < 1e-3:
        return f"{v * 1e6:.0f}µs"
    if v < 1:
        return f"{v * 1e3:.1f}ms"
    return f"{v:.2f}s"


def _num(v, spec: str) -> str:
    return "—" if v is None else format(v, spec)


def render_markdown(rows: list[dict]) -> str:
    lines = [
        "| arch | shape | compute | memory (unfused) | memory (ideal) | "
        "collective | dominant | MODEL_FLOPS | useful | roofline frac | "
        "peak GB/dev |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r["status"] == "skipped":
            lines.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | — | *skipped* "
                f"| — | — | — | — |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {fmt(r['t_compute'])} | "
            f"{fmt(r['t_memory'])} | {fmt(r['t_memory_ideal'])} | "
            f"{fmt(r['t_collective'])} | **{r['dominant']}** | "
            f"{r['model_flops']:.2e} | {_num(r['useful_ratio'], '.2f')} | "
            f"{_num(r['roofline_fraction'], '.3f')} | "
            f"{_num(r['mem_gb'], '.1f')} |")
    return "\n".join(lines)


def render_hints(rows: list[dict]) -> str:
    out = []
    for r in rows:
        if r["status"] != "ok" or r["dominant"] is None:
            continue
        out.append(f"- **{r['arch']} × {r['shape']}** ({r['dominant']}-bound):"
                   f" {bottleneck_hint(r)}")
    return "\n".join(out)


def _max_term(r: dict) -> float:
    return max(v for v in (r["t_compute"], r["t_memory"], r["t_collective"])
               if v is not None)


def render_comparison(base: list[dict], opt: list[dict]) -> str:
    """Baseline vs optimized per cell (paper-faithful vs beyond-paper)."""
    by_key = {(r["arch"], r["shape"]): r for r in opt if r["status"] == "ok"}
    lines = [
        "| arch | shape | max-term base→opt | compute | memory | collective "
        "| roofline frac base→opt |",
        "|---|---|---|---|---|---|---|",
    ]

    def ratio(a, b):
        return f"{a / b:.1f}×" if a is not None and b else "—"

    for r in base:
        if r["status"] != "ok":
            continue
        o = by_key.get((r["arch"], r["shape"]))
        if o is None:
            continue
        mt_b, mt_o = _max_term(r), _max_term(o)
        lines.append(
            f"| {r['arch']} | {r['shape']} | {fmt(mt_b)}→{fmt(mt_o)} "
            f"({ratio(mt_b, mt_o)}) | {ratio(r['t_compute'], o['t_compute'])} "
            f"| {ratio(r['t_memory'], o['t_memory'])} "
            f"| {ratio(r['t_collective'], o['t_collective'])} "
            f"| {_num(r['roofline_fraction'], '.3f')}→"
            f"{_num(o['roofline_fraction'], '.3f')} |")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--dir", default="results/dryrun")
    p.add_argument("--out", default="results/roofline.md")
    args = p.parse_args(argv)
    rows = load_rows(args.dir)
    md = render_markdown(rows)
    hints = render_hints(rows)
    opt_rows = load_rows(args.dir, profile="optimized")
    cmp_md = render_comparison(rows, opt_rows) if opt_rows else ""
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write("# Roofline (single-pod 16x16 H100, per-device terms)\n\n")
        f.write("## Baseline (paper-faithful deployment)\n\n")
        f.write(md + "\n\n## What would move the dominant term\n\n"
                + hints + "\n")
        if cmp_md:
            f.write("\n## Baseline vs optimized profile (beyond-paper)\n\n"
                    + cmp_md + "\n")
    print(md)
    if cmp_md:
        print("\n" + cmp_md)
    print(f"\nwritten to {args.out}")


if __name__ == "__main__":
    main()
