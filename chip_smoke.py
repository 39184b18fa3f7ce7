#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  device       the card's name and power limit (nvidia-smi), torch's name
  build        nvcc-builds both domain-map kernels from csrc/, in parallel
  kernels      every domain: the map kernel against its plain torch version
               at λ in [0, 2^22), near 2^31 and near 5e8, and the membership
               kernel on a box of about 2^22 cells — exact equality
  paper_scale  the paper's N = 5e8 (benchmarks/block_dense.py) through the
               mapped launcher for all 12 domains, checked against the
               plain version in chunks of 2^26 λ; BB membership for tri2d,
               pyramid3d (3.0e9 cells) and four full fractal levels,
               checked against the plain version and by member count; the
               kernels' median times (CUDA events) beside their bounds
  evaluate     a heterogeneous EvaluationService batch on the card, held
               against the port's own CPU path and its binary frame

then a ``{"kernels": [...]}`` line and, last, ``{"ok": true, ...}``.  Any
failed check raises and the script exits non-zero; without a CUDA device it
exits 2 and prints no result.  Nothing here imports JAX or ``repro``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM device-memory rate (NVIDIA data sheet) — the kernels' bound is
#: their output bytes written once at this rate
HBM_BYTES_PER_S = 3.35e12
N_PAPER = 500_000_000          # benchmarks/block_dense.py:23
CHUNK = 1 << 26                # λ per plain-version chunk (int64 temps fit)
REPS = 10                      # timed runs per kernel (median reported)
#: the largest full fractal level whose box is <= 2^31 cells
FRACTAL_LEVELS = {"gasket2d": 15, "carpet2d": 9, "sierpinski3d": 10,
                  "menger3d": 6}
#: about 2^22 cells per box, by dimension
SMALL_BOX = {2: (2048, 2048), 3: (161, 161, 161), 4: (45,) * 4, 5: (21,) * 5}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


class Smoke:
    def __init__(self):
        import torch

        from repro_torch.core.domains import DOMAINS
        from repro_torch.kernels.domain_map import kernel, ops

        self.torch, self.K, self.ops, self.DOMAINS = torch, kernel, ops, DOMAINS
        self.max_err = {"map_kernel": 0, "membership_kernel": 0}
        self.launches = {}
        self.totals = {k: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0}
                       for k in self.max_err}

    # -- helpers -------------------------------------------------------------
    def sync(self):
        self.torch.cuda.synchronize()

    def time_ms(self, fn, reps: int = REPS) -> float:
        """Median device time of ``fn()`` over ``reps`` runs (CUDA events),
        after one warm-up run."""
        torch = self.torch
        fn()
        self.sync()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def compare(self, kernel_name: str, got, want, what: str) -> None:
        torch = self.torch
        check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} "
              f"!= {tuple(want.shape)}")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
            if got.numel() else 0
        self.max_err[kernel_name] = max(self.max_err[kernel_name], err)
        check(err == 0, f"{what}: kernel differs from its plain version "
              f"(max abs err {err})")

    def counts(self) -> dict:
        return {"map_kernel": self.K.MAP_LAUNCHES,
                "membership_kernel": self.K.MEMBERSHIP_LAUNCHES}

    # -- phase 1 -------------------------------------------------------------
    def device(self) -> str:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        self.card = smi.stdout.strip().splitlines()[0]
        print(self.card, flush=True)
        name = self.torch.cuda.get_device_name(0)
        emit({"phase": "device", "nvidia_smi": self.card,
              "torch_device": name,
              "count": self.torch.cuda.device_count(),
              "torch": self.torch.__version__,
              "cuda": self.torch.version.cuda})
        return name

    # -- phase 2 -------------------------------------------------------------
    def build(self) -> None:
        t0 = time.perf_counter()
        paths = self.K.build_kernels()
        dt = time.perf_counter() - t0
        ptxas = {name: [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln]
                 for name, log in self.K.BUILD_LOG.items()}
        emit({"phase": "build", "seconds": dt,
              "libraries": {k: str(p.relative_to(ROOT))
                            for k, p in paths.items()},
              "ptxas": ptxas})

    # -- phase 3 -------------------------------------------------------------
    def kernels(self) -> None:
        K, ops = self.K, self.ops
        n = 1 << 22
        starts = (0, (1 << 31) - 1000, N_PAPER - (1 << 20))
        K.reset_launch_counts()
        for name, d in self.DOMAINS.items():
            for start in starts:
                _, padded, ndigits = ops.map_plan(name, n, 1024, start)
                got = K.launch_map(name, padded, ndigits, start)
                want = K.map_plain(name, padded, ndigits, start,
                                   device="cuda")
                self.compare("map_kernel", got, want,
                             f"{name} map at start={start}")
            ext = SMALL_BOX[d.dim]
            _, padded, ndigits = ops.membership_plan(name, ext, 1024)
            got = K.launch_membership(name, ext, padded, ndigits)
            want = K.membership_plain(name, ext, ndigits, padded,
                                      device="cuda")
            self.compare("membership_kernel", got, want,
                         f"{name} membership on {ext}")
        self.sync()
        emit({"phase": "kernels", "domains": len(self.DOMAINS),
              "map_starts": list(starts), "map_n": n,
              "launches": self.counts(), "max_abs_err": self.max_err,
              "equal": True})

    # -- phase 4 -------------------------------------------------------------
    def _check_map_chunks(self, name, out, n, ndigits) -> float:
        """Exact chunked check of a mapped output; returns the plain
        version's device time for the whole range (ms, one run)."""
        torch, K = self.torch, self.K
        plain_ms = 0.0
        for lo in range(0, n, CHUNK):
            c = min(CHUNK, n - lo)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            want = K.map_plain(name, c, ndigits, lo, device="cuda")
            b.record()
            b.synchronize()
            plain_ms += a.elapsed_time(b)
            self.compare("map_kernel", out[:, lo:lo + c], want,
                         f"{name} paper-scale map chunk at {lo}")
            del want
        return plain_ms

    def _check_mask_chunks(self, name, mask, extent, ndigits) -> float:
        torch, K = self.torch, self.K
        total = mask.shape[1]
        plain_ms = 0.0
        for lo in range(0, total, CHUNK):
            c = min(CHUNK, total - lo)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            want = K.membership_plain(name, extent, ndigits, c, lo,
                                      device="cuda")
            b.record()
            b.synchronize()
            plain_ms += a.elapsed_time(b)
            self.compare("membership_kernel", mask[:, lo:lo + c], want,
                         f"{name} paper-scale mask chunk at {lo}")
            del want
        return plain_ms

    def _members_of_mapped(self, name, coords, extent, mask) -> None:
        """Every mapped point lies in the box and is a member there."""
        torch = self.torch
        strides = [1] * len(extent)
        for k in range(len(extent) - 2, -1, -1):
            strides[k] = strides[k + 1] * extent[k + 1]
        n = coords.shape[1]
        for lo in range(0, n, CHUNK):
            c = coords[:, lo:lo + CHUNK].to(torch.int64)
            for k, e in enumerate(extent):
                check(bool(((c[k] >= 0) & (c[k] < e)).all()),
                      f"{name}: mapped axis {k} leaves the box")
            idx = sum(c[k] * s for k, s in enumerate(strides))
            check(bool((mask[0, idx] == 1).all()),
                  f"{name}: a mapped point fails the BB membership test")

    def paper_scale(self) -> None:
        torch, K, ops = self.torch, self.K, self.ops
        from repro_torch.core.compile_cache import CompileCache

        cache = CompileCache(max_entries=64)
        rows = {}
        K.reset_launch_counts()
        # the main-path calls: one mapped launch per domain at N = 5e8
        for name, d in self.DOMAINS.items():
            _, padded, ndigits = ops.map_plan(name, N_PAPER, 1024)
            call = ops.mapped_executable(name, padded, 1024, ndigits, False,
                                         compile_cache=cache)
            out = call()
            self.sync()
            plain_ms = self._check_map_chunks(name, out, N_PAPER, ndigits)
            del out
            rows[name] = {"n": N_PAPER, "padded": padded, "ndigits": ndigits,
                          "bytes": d.dim * padded * 4, "call": call,
                          "plain_ms": plain_ms}
        # BB membership: dense boxes at N = 5e8, full fractal levels
        bb = {}
        for name in ("tri2d", "pyramid3d", *FRACTAL_LEVELS):
            d = self.DOMAINS[name]
            if name in FRACTAL_LEVELS:
                level = FRACTAL_LEVELS[name]
                extent = (d.scale ** level,) * d.dim
                n_map = d.size(level)
            else:
                extent = d.bounding_box_extent(N_PAPER)
                level = extent[0]
                n_map = N_PAPER
            total = math.prod(extent)
            _, padded, ndigits = ops.membership_plan(name, extent, 1024)
            call = ops.membership_executable(name, extent, padded, 1024,
                                             ndigits, False,
                                             compile_cache=cache)
            mask = call()
            self.sync()
            members = int(mask[0, :total].sum(dtype=torch.int64))
            check(members == d.size(level),
                  f"{name}: {members} members in box {extent}, "
                  f"size({level}) = {d.size(level)}")
            plain_ms = self._check_mask_chunks(name, mask, extent, ndigits)
            # the mapped launch over the same points
            _, mpad, mdig = ops.map_plan(name, n_map, 1024)
            mcall = ops.mapped_executable(name, mpad, 1024, mdig, False,
                                          compile_cache=cache)
            coords = mcall()[:, :n_map]
            self._members_of_mapped(name, coords, extent, mask)
            del mask, coords
            bb[name] = {"extent": list(extent), "cells": total,
                        "padded": padded, "members": members,
                        "level": level, "bytes": padded * 4, "call": call,
                        "plain_ms": plain_ms, "mapped_n": n_map,
                        "mapped_call": mcall, "mapped_bytes": d.dim * mpad * 4}
        self.sync()
        main = self.counts()
        # timing (not part of the main-path launch count)
        for name, r in rows.items():
            r["ms"] = self.time_ms(r.pop("call"))
            r["bound_ms"] = r["bytes"] / HBM_BYTES_PER_S * 1e3
            emit({"phase": "paper_scale", "kernel": "map_kernel",
                  "domain": name, "card": self.card, **r})
            t = self.totals["map_kernel"]
            t["ms"] += r["ms"]
            t["plain_ms"] += r["plain_ms"]
            t["bytes"] += r["bytes"]
        for name, r in bb.items():
            r["ms"] = self.time_ms(r.pop("call"))
            r["bound_ms"] = r["bytes"] / HBM_BYTES_PER_S * 1e3
            r["mapped_ms"] = self.time_ms(r.pop("mapped_call"))
            r["mapped_bound_ms"] = r["mapped_bytes"] / HBM_BYTES_PER_S * 1e3
            r["bb_over_mapped"] = r["ms"] / r["mapped_ms"]
            emit({"phase": "paper_scale", "kernel": "membership_kernel",
                  "domain": name, "card": self.card, **r})
            t = self.totals["membership_kernel"]
            t["ms"] += r["ms"]
            t["plain_ms"] += r["plain_ms"]
            t["bytes"] += r["bytes"]
        emit({"phase": "paper_scale", "card": self.card,
              "main_path_launches": main,
              "map_ms_12_domains": self.totals["map_kernel"]["ms"],
              "bb_ms_6_boxes": self.totals["membership_kernel"]["ms"]})

    # -- phase 5 -------------------------------------------------------------
    def evaluate(self) -> None:
        import numpy as np

        from repro_torch.core.compile_cache import CompileCache
        from repro_torch.core.maps import np_map
        from repro_torch.serving import wire
        from repro_torch.serving.evaluate import (
            MAX_POINTS, EvaluationService, encoded_batch_response,
        )

        far = (1 << 31) + 12345
        queries = [{"domain": name, "n_points": MAX_POINTS}
                   for name in self.DOMAINS]
        queries += [
            {"domain": "tri2d", "n_points": 1000},
            {"domain": "tri2d", "n_points": 5000},
            {"domain": "tri2d", "n_points": 1 << 20, "start": far},
            {"domain": "tri2d", "tier": "membership", "extent": [1448, 1448]},
            {"domain": "gasket2d", "tier": "membership",
             "extent": [1448, 1448]},
            {"domain": "menger3d", "tier": "membership",
             "extent": [128, 128, 128]},
        ]
        ev = EvaluationService(compile_cache=CompileCache(max_entries=64))
        self.K.reset_launch_counts()
        t0 = time.perf_counter()
        cold, meta = ev.evaluate_batch(queries)
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        warm, meta2 = ev.evaluate_batch(queries)
        warm_s = time.perf_counter() - t0
        frame = encoded_batch_response(ev, None, queries, single=False,
                                       binary=True)
        self.sync()
        self.launches = self.counts()
        for k, v in self.launches.items():
            check(v > 0, f"evaluate never launched {k}")

        check(meta == meta2, "repeat batch changed its grouping")
        check(all(r["executable"] == "hit" for r in warm),
              "repeat batch was not all executable hits")
        check(cold[12]["group"] == cold[13]["group"] == cold[0]["group"],
              "tri2d prefix queries did not share a group")
        cpu = EvaluationService(compile_cache=CompileCache(max_entries=64))
        ref, ref_meta = cpu.evaluate_batch(
            [{**q, "interpret": True} for q in queries])
        check(ref_meta == meta, "CPU path grouped the batch differently")
        decoded = wire.decode_frame(frame)["results"]
        for q, a, b, r, f in zip(queries, cold, warm, ref, decoded):
            field = "mask" if q.get("tier") == "membership" else "coords"
            for other, what in ((b, "warm"), (r, "interpret=True"),
                                (f, "binary frame")):
                check(other[field].dtype == a[field].dtype
                      and np.array_equal(other[field], a[field]),
                      f"{q}: {what} {field} differ from the card's")
            skip = ("interpret", "executable", field)
            check({k: v for k, v in a.items() if k not in skip}
                  == {k: v for k, v in r.items() if k not in skip},
                  f"{q}: result metadata differ from the CPU path")
        exact = np_map("tri2d", np.arange(far, far + (1 << 20),
                                          dtype=np.int64))
        check(np.array_equal(cold[14]["coords"].astype(np.int64), exact),
              "tri2d past 2^31 differs from the exact numpy tier")
        emit({"phase": "evaluate", "card": self.card,
              "queries": meta["queries"], "groups": meta["groups"],
              "points": sum(q.get("n_points", 0) for q in queries),
              "cold_batch_s": cold_s, "warm_batch_s": warm_s,
              "frame_bytes": len(frame), "launches": self.launches,
              "stats": ev.stats_dict()})

    def kernels_line(self) -> None:
        src = "src/repro_torch/kernels/domain_map/csrc/"
        replaces = {"map_kernel": "src/repro/kernels/domain_map/kernel.py:53",
                    "membership_kernel":
                        "src/repro/kernels/domain_map/kernel.py:65"}
        emit({"kernels": [
            {"name": name, "route": "cuda", "source": f"{src}{name}.cu",
             "replaces": replaces[name],
             "launches": self.launches[name],
             "max_abs_err": self.max_err[name],
             "ms": t["ms"], "plain_ms": t["plain_ms"],
             "bound_ms": t["bytes"] / HBM_BYTES_PER_S * 1e3,
             "bound_by": "bytes", "library_ms": None}
            for name, t in self.totals.items()]})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smoke = Smoke()
    kind = smoke.device()
    smoke.build()
    smoke.kernels()
    smoke.paper_scale()
    smoke.evaluate()
    smoke.kernels_line()
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
