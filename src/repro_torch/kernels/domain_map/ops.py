"""Launch wrappers for the domain-map kernels + block-waste accounting.

Every entry point takes a *map spec* — a domain name, a ``Domain``, a
registry ``MapEntry`` or a validated ``MappingArtifact`` — and resolves the
geometry through the MapRegistry.  An artifact that is not deployable
(validated less than 100% ordered) raises before any launch.

``interpret`` is the device choice: ``False`` (the default) launches the
CUDA kernel and raises where there is no card; ``True`` runs the kernel's
plain torch version on the CPU.

Execution routes through :mod:`repro_torch.core.compile_cache`: the
launcher is built once per ``(spec identity, shape, block_n, ndigits,
interpret, device)`` and every repeat invocation reuses it — the hot path
is one cache hit plus the launch.  Pass ``compile_cache=None`` to bypass
(one build per call); pass a
:class:`~repro_torch.core.compile_cache.CompileCache` to use a private
cache instead of the process default.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import compile_cache as cc
from repro_torch.core.artifact import resolve_domain
from repro_torch.core.domains import get_domain
from repro_torch.kernels.domain_map import kernel
from repro_torch.kernels.domain_map.kernel import (
    build_map_call, build_membership_call,
)


def _pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


def map_plan(spec, n_points: int, block_n: int,
             start: int = 0) -> tuple[object, int, int]:
    """(domain, padded N, ndigits) for a mapped-kernel launch — shared by
    the local wrappers here and the batching EvaluationService, so both
    resolve identical executables for identical queries."""
    d = get_domain(resolve_domain(spec))
    padded = _pad_to(n_points, block_n)
    ndigits = max(d.level_for_points(start + padded), 1) \
        if d.kind == "fractal" else 13
    return d, padded, ndigits


def membership_plan(spec, extent: tuple[int, ...],
                    block_n: int) -> tuple[object, int, int]:
    """(domain, padded box total, ndigits) for a BB-membership launch."""
    d = get_domain(resolve_domain(spec))
    total = int(np.prod(extent))
    padded = _pad_to(total, block_n)
    # membership of the box needs digits covering the box extent
    ndigits = (max(d.level_for_points(total), 1) + 1) \
        if d.kind == "fractal" else 13
    return d, padded, ndigits


def mapped_executable(spec, padded: int, block_n: int, ndigits: int,
                      interpret: bool, start: int = 0,
                      compile_cache=cc.USE_DEFAULT):
    """The (cached) launcher for one mapped-kernel launch."""
    cache = cc.resolve(compile_cache)

    def build():
        return build_map_call(spec, padded, block_n, ndigits, interpret,
                              lam_offset=start)

    if cache is None:
        return build()
    key = cc.ExecKey(cc.spec_fingerprint(spec), "map",
                     (start, padded), block_n, ndigits,
                     interpret=interpret)
    return cache.get(key, build)


def membership_executable(spec, extent: tuple[int, ...], padded: int,
                          block_n: int, ndigits: int, interpret: bool,
                          compile_cache=cc.USE_DEFAULT):
    """The (cached) launcher for one BB-membership launch."""
    cache = cc.resolve(compile_cache)

    def build():
        return build_membership_call(spec, extent, block_n, ndigits,
                                     interpret, padded_total=padded)

    if cache is None:
        return build()
    key = cc.ExecKey(cc.spec_fingerprint(spec), "membership",
                     tuple(extent) + (padded,), block_n, ndigits,
                     interpret=interpret)
    return cache.get(key, build)


def sharded_map_executable(spec, n_points: int, devices, interpret: bool,
                           compile_cache=cc.USE_DEFAULT):
    """``(launcher, padded, ndigits)`` for one map-tier λ-range split evenly
    over ``devices``: padded = ceil(n/len(devices))·len(devices), and device
    i computes λ in ``[i·padded/len, (i+1)·padded/len)``.  The launcher
    issues every shard before it copies any back, then gathers them once to
    the host: a (dim, padded) int32 numpy array.

    Each shard is one map-kernel launch with its λ offset, on its own card
    (``torch.cuda.device(i)``); with ``interpret=True`` it is the kernel's
    plain version on ``devices[i]`` (a CPU test shards over
    ``["cpu", "cpu"]``)."""
    import torch

    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("a sharded launch needs at least one device")
    if not interpret:
        if any(d.type != "cuda" for d in devices):
            raise ValueError(f"the map kernel runs on cuda devices, not "
                             f"{[str(d) for d in devices]}")
        if not torch.cuda.is_available():
            raise RuntimeError(kernel.NO_CARD)
    domain_name = resolve_domain(spec)
    n_dev = len(devices)
    padded = _pad_to(n_points, n_dev)
    per = padded // n_dev
    _, _, ndigits = map_plan(spec, padded, 1)

    def build():
        if interpret:
            def run():
                return torch.cat([
                    kernel.map_plain(spec, per, ndigits, i * per, device=d)
                    .cpu() for i, d in enumerate(devices)], dim=1).numpy()
            return run
        kernel._library("map_kernel")

        def run():
            outs = []
            for i, d in enumerate(devices):
                with torch.cuda.device(d):
                    outs.append(kernel.launch_map(domain_name, per, ndigits,
                                                  i * per))
            return torch.cat([o.cpu() for o in outs], dim=1).numpy()
        return run

    cache = cc.resolve(compile_cache)
    if cache is None:
        return build(), padded, ndigits
    key = cc.ExecKey(cc.spec_fingerprint(spec),
                     "map_sharded:" + ",".join(str(d) for d in devices),
                     (padded, n_dev), 0, ndigits, interpret=interpret)
    return cache.get(key, build), padded, ndigits


def map_coordinates(spec, n_points: int, block_n: int = 1024,
                    interpret: bool = False, start: int = 0,
                    compile_cache=cc.USE_DEFAULT) -> np.ndarray:
    """Coordinates for λ in [start, start + n_points) via the mapped-grid
    kernel, (N, dim) int32.  ``start=0`` is the classic first-N launch."""
    d, padded, ndigits = map_plan(spec, n_points, block_n, start)
    call = mapped_executable(spec, padded, block_n, ndigits, interpret,
                             start=start, compile_cache=compile_cache)
    out = call().cpu().numpy()          # (dim, padded)
    return out[: d.dim, :n_points].T    # (N, dim)


def bb_membership(spec, extent: tuple[int, ...],
                  block_n: int = 1024, interpret: bool = False,
                  compile_cache=cc.USE_DEFAULT) -> np.ndarray:
    """Row-major membership mask over the bounding box via the BB kernel."""
    d, padded, ndigits = membership_plan(spec, extent, block_n)
    total = int(np.prod(extent))
    call = membership_executable(spec, tuple(extent), padded, block_n,
                                 ndigits, interpret,
                                 compile_cache=compile_cache)
    out = call().cpu().numpy()[0]
    return out[:total]


def block_counts(spec, n_points: int, block_n: int = 256) -> dict:
    """Grid-step accounting for mapped vs bounding-box strategies."""
    d = get_domain(resolve_domain(spec))
    mapped_steps = -(-n_points // block_n)
    ext = d.bounding_box_extent(n_points)
    bb_steps = -(-int(np.prod(ext)) // block_n)
    return {
        "mapped_steps": mapped_steps,
        "bb_steps": bb_steps,
        "wasted_steps": bb_steps - mapped_steps,
        "waste_fraction": (bb_steps - mapped_steps) / bb_steps if bb_steps else 0.0,
    }
