"""The traced slice of a run: a ``torch.profiler`` trace of a few steady
items, the program's entry points wrapped in ranges, and what the per-layer
readers take from them.

``analyze`` is a frozen copy of ``repro_torch/launch/hlo_analysis.py``'s
``analyze`` (device time by kernel, the union of device events, the longest
idle gaps with the host op that overlapped each most), cut to what the
bench reads and given the window explicitly: from the start of the first
traced item to the end of the last.  ``TraceView.device_s`` adds what that
module does not have: the device time of the kernels launched inside named
host ranges, matched launch to kernel by the profiler's correlation ids.

The profiler's host recording costs time on every op, so the traced items
run slower than the others and the slice's idle gaps are wider than the
window's; the time the device is busy in an item is not changed by it.
"""
from __future__ import annotations

import bisect
import contextlib
import importlib
import json
import os
import re
import tempfile
from collections import defaultdict

import torch

STEP_RANGE = "bench.step"
#: the profiler's name for the host range of an autograd node's backward
BACKWARD_RANGE = "autograd::engine::evaluate_function: {}"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_RANGE_CATS = ("cpu_op", "user_annotation")


def kernel_name(name: str) -> str:
    """A demangled kernel event's function name: ``void ta_sm90_kernel<128,
    ...>(...)`` -> ``ta_sm90_kernel``."""
    n = name.strip().replace("(anonymous namespace)::", "")
    if n.startswith("void "):
        n = n[5:]
    n = re.split(r"[<(]", n, maxsplit=1)[0].strip()
    return n.rsplit("::", 1)[-1]


def _union(intervals):
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _end(e: dict) -> float:
    return float(e["ts"]) + float(e.get("dur", 0))


def analyze(data: dict, window: tuple[float, float], top: int = 10) -> dict:
    """Device busy time, time by kernel and the longest idle gaps inside
    ``window`` (trace µs), from a Chrome-trace dict."""
    t0, t1 = window
    events = [e for e in data.get("traceEvents", []) if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in _DEVICE_CATS
              and _end(e) > t0 and float(e["ts"]) < t1]
    host = [e for e in events if e.get("cat") == "cpu_op"]
    by_kernel: dict[str, float] = defaultdict(float)
    for e in device:
        name = e.get("name", "")
        if e.get("cat") == "kernel":
            name = kernel_name(name)
        by_kernel[name] += min(_end(e), t1) - max(float(e["ts"]), t0)
    busy = _union([(max(float(e["ts"]), t0), min(_end(e), t1))
                   for e in device])
    busy_us = sum(e - s for s, e in busy)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])

    def host_op(s: float, e: float) -> str:
        best, key = "none", None
        for h in host:
            hs, he = float(h["ts"]), _end(h)
            ov = min(e, he) - max(s, hs)
            if ov > 0 and (key is None or (ov, hs - he) > key):
                best, key = h["name"], (ov, hs - he)
        return best

    return {
        "window_us": t1 - t0,
        "device_busy_us": busy_us,
        "device_us_by_kernel": dict(by_kernel),
        "top_kernels": sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top],
        "idle_gaps": [(host_op(s, e), e - s) for s, e in gaps[:top]],
    }


class TraceView:
    """What a reader may ask of the traced slice."""

    def __init__(self, data: dict, calls: dict):
        self.calls = calls
        events = [e for e in data.get("traceEvents", []) if e.get("ph") == "X"]
        self._ranges = defaultdict(list)
        for e in events:
            if e.get("cat") in _RANGE_CATS:
                self._ranges[e["name"]].append(e)
        steps = self._ranges.get(STEP_RANGE, [])
        if not steps:
            raise ValueError("the trace holds no traced item")
        self.window = (min(float(e["ts"]) for e in steps),
                       max(_end(e) for e in steps))
        self.analysis = analyze(data, self.window)
        self.window_s = self.analysis["window_us"] * 1e-6
        self.busy_s = self.analysis["device_busy_us"] * 1e-6
        self.steps = len(steps)
        self._launches = defaultdict(list)
        for e in events:
            if e.get("cat") in _LAUNCH_CATS and "correlation" in e.get(
                    "args", {}):
                self._launches[(e["pid"], e["tid"])].append(
                    (float(e["ts"]), e["args"]["correlation"]))
        for v in self._launches.values():
            v.sort()
        self._device = {}
        for e in events:
            corr = e.get("args", {}).get("correlation")
            if e.get("cat") in _DEVICE_CATS and corr is not None:
                self._device[corr] = self._device.get(corr, 0.0) + float(
                    e.get("dur", 0))

    def count(self, name: str) -> int:
        """Host ranges named ``name``."""
        return len(self._ranges.get(name, []))

    def device_s(self, names) -> float:
        """Device seconds of every kernel, copy or set launched inside a
        host range of one of ``names`` (each launch counted once)."""
        corrs = set()
        for name in names:
            for r in self._ranges.get(name, []):
                launches = self._launches.get((r["pid"], r["tid"]), [])
                lo = bisect.bisect_left(launches, (float(r["ts"]), -1))
                hi = bisect.bisect_right(launches, (_end(r), float("inf")))
                corrs.update(c for _, c in launches[lo:hi])
        return sum(self._device.get(c, 0.0) for c in corrs) * 1e-6


def _describe(args, kwargs, out) -> dict:
    """A call's tensor shapes and dtypes, its other arguments and the name
    of the autograd node its first output hangs on (None without one)."""
    first = out[0] if isinstance(out, (tuple, list)) else out
    node = getattr(first, "grad_fn", None)
    return {
        "tensors": [(tuple(a.shape), str(a.dtype).replace("torch.", ""))
                    for a in args if isinstance(a, torch.Tensor)],
        "args": [a for a in args if isinstance(a, (int, float, str, bool))],
        "kwargs": {k: (str(v).replace("torch.", "")
                       if isinstance(v, torch.dtype) else v)
                   for k, v in kwargs.items()
                   if not isinstance(v, torch.Tensor)},
        "grad_fn": None if node is None else node.name(),
    }


class Tracer:
    """Profiles the window's items ``first`` .. ``first + count - 1``.
    While it runs, each entry of ``spans`` (name -> ``"module:attribute"``,
    a function the program looks up at call time) is wrapped in a host
    range ``bench.<name>`` and its calls described in ``calls[name]``."""

    def __init__(self, spans: dict, device="cuda", first: int = 1,
                 count: int = 2):
        self.spans = spans
        self.on_card = torch.device(device).type == "cuda"
        self.first, self.count = first, count
        self.calls: dict[str, list] = defaultdict(list)
        self.prof = None
        self._saved = []

    def _activities(self) -> list:
        from torch.profiler import ProfilerActivity

        return [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.on_card else [])

    def _sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize()

    def warm_up(self) -> None:
        """Start the profiler's device tracing once, outside the window."""
        from torch.profiler import profile

        with profile(activities=self._activities()):
            torch.ones(8, device="cuda" if self.on_card else "cpu").sum() \
                .item()

    def _wrap(self, name: str, fn):
        label, log = "bench." + name, self.calls[name]

        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(label):
                out = fn(*args, **kwargs)
            log.append(_describe(args, kwargs, out))
            return out

        return wrapped

    def _start(self) -> None:
        from torch.profiler import profile

        for name, where in self.spans.items():
            mod_name, attr = where.split(":")
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(name, fn))
        self._sync()
        self.prof = profile(activities=self._activities())
        self.prof.start()

    def _stop(self) -> None:
        self._sync()
        self.prof.stop()
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()

    @contextlib.contextmanager
    def item(self, i: int):
        """Around item ``i`` of the window; yields whether it is traced."""
        k = i - self.first
        if not 0 <= k < self.count:
            yield False
            return
        if k == 0:
            self._start()
        with torch.profiler.record_function(STEP_RANGE):
            yield True
        if k == self.count - 1:
            self._stop()

    def done(self, i: int) -> bool:
        return i >= self.first + self.count - 1

    def view(self) -> TraceView:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.remove(path)
        self.prof = None
        return TraceView(data, dict(self.calls))
