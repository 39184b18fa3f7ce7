"""One run of one cell: set-up, the measured window, the check against the
plain reference, and, with ``trace``, the per-layer metrics of a traced
slice of the window.  ``bench/run.py`` is the command; tests call ``run``
on the CPU with smaller sizes.
"""
from __future__ import annotations

import math
import statistics
import subprocess
import sys
import time
import types

import torch

from bench import drive, faults, program, spec, weights
from bench.reference.common import Precision
from bench.tracing import Tracer

#: top-level module names no run may load (JAX, and the JAX package whose
#: name the port's begins with)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def apply_overrides(cell: spec.Cell, overrides: dict | None) -> spec.Cell:
    """``cell`` with ``overrides`` ({"model": {...}, "traffic": {...}})
    merged into its configuration's model and its traffic (tests)."""
    if overrides:
        cell.config = dict(cell.config, model=dict(
            cell.config["model"], **overrides.get("model", {})))
        cell.traffic = dict(cell.traffic, **overrides.get("traffic", {}))
    return cell


def power_limit_w() -> str:
    """The card's power limit as ``nvidia-smi`` reads it ("unknown" where
    it cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout.split()
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out[0] if out else "unknown"


def prepare(name: str, seed: int, device="cuda",
            overrides: dict | None = None):
    """(cell, its reference module, ``initial()`` -- a fresh dict of the
    seed's weights --, the program's model configuration)."""
    cell = apply_overrides(spec.load(name), overrides)
    ref = spec.reference(cell.config)
    leaves = ref.leaves(cell.model)

    def initial():
        return weights.make(leaves, cell.config["init"], seed, device)

    return cell, ref, initial, program.model_config(
        cell.config, interpret=torch.device(device).type == "cpu")


def item_times(items: list, view) -> str:
    """The items' host ms, untraced (mean) and traced (mean), beside the
    device's busy ms a traced item."""
    untraced = [1e3 * (i["t1"] - i["t0"]) for i in items if not i["traced"]]
    traced = [1e3 * (i["t1"] - i["t0"]) for i in items if i["traced"]]
    mean = statistics.fmean(untraced) if untraced else math.nan
    return (f"item ms: untraced {mean:.2f}, traced "
            f"{statistics.fmean(traced):.2f}, device busy a traced item "
            f"{1e3 * view.busy_s / view.steps:.2f}")


def run(name: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, device="cuda", overrides: dict | None = None,
        fault: str | None = None, marks: list | None = None) -> dict:
    """The result of one run: the keys of the result line, ``checks`` last,
    and ``stderr``, the lines to print before it.  ``marks`` ((what, host
    seconds) pairs) time the set-up before the call."""
    marks = list(marks or [])
    cell, ref, initial, mcfg = prepare(name, seed, device, overrides)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.init()
        torch.ones(1, device=device).item()
        marks.append(("cuda context", time.perf_counter()))
    readers = {m["name"]: spec.metric_reader(m["name"])
               for m in (cell.per_layer if trace else [])}
    kind = spec.kind_module(cell.traffic["kind"])
    tracer = None
    if trace:
        spans = {}
        for r in readers.values():
            spans.update(r.SPANS)
        tr = cell.traffic["trace"]
        tracer = Tracer(spans, device, tr["first"], tr["count"])
        tracer.warm_up()
    with faults.planted(fault):
        driver = kind.Driver(cell, mcfg, initial, seed, device, fault)
        setup_s = time.perf_counter() - t_start
        items = drive.window(driver.item, seconds, driver.tokens, tracer)
    marks += driver.marks[1:]
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    answers = [i["answer"] for i in items]
    failed = sum(not math.isfinite(a) for a in answers)
    driver.free()
    drive.free_memory(device)
    readings = driver.readings(answers, ref, cell.model, initial,
                               Precision("float32"),
                               cell.workload.get("check_requests", 0))
    limits = cell.workload["limits"]
    checks = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics, dev = {}, {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name() if on_card else "cpu",
        "count": 1, "memory_peak_bytes": peak}
    lines, result = [], {}
    if not trace:
        values = {"setup_s": setup_s, **kind.end_to_end(items, cell.traffic)}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        view = tracer.view()
        ctx = types.SimpleNamespace(
            trace=view, calls=view.calls, items=items,
            config=cell.config, model=cell.model, traffic=cell.traffic,
            kind=kind, flops=spec.flops_module(cell.config))
        for mname, reader in readers.items():
            value = reader.read(ctx)
            if value is not None:
                metrics[mname] = {"value": value, "unit": units[mname]}
        dev["busy_s"], dev["window_s"] = view.busy_s, view.window_s
        result["breakdown"] = {
            "device_ops": [[n, us * 1e-6]
                           for n, us in view.analysis["top_kernels"]],
            "idle_gaps": [[n, us * 1e-6]
                          for n, us in view.analysis["idle_gaps"]]}
        lines.append(item_times(items, view))
    if on_card:
        dev["power_limit_w"] = power_limit_w()
    for k, m in metrics.items():
        lines.append(f"{k} {m['value']!r} {m['unit']}"
                     + (f" (power limit {dev.get('power_limit_w')} W)"
                        if m["unit"] == "%" else ""))
    prev, split = t_start, []
    for what, t in marks:
        split.append(f"{what} {t - prev:.2f}")
        prev = t
    lines.append("set-up s: " + ", ".join(split))
    lines.append(f"items {len(items)} failed {failed} correct {correct}")
    lines += [f"check {k} {c['value']!r} limit {c['limit']!r}"
              for k, c in checks.items()]
    return {"correct": correct, "attempted": len(items), "failed": failed,
            "metrics": metrics, "device": dev, **result, "checks": checks,
            "stderr": lines}
