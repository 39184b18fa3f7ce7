"""CUDA kernels for mapped-grid map evaluation and BB membership filtering.

The paper's deployment kernels (Sec. V.C), hand-written for Hopper in
``csrc/`` and bound here with ``ctypes``:

  * ``map_kernel``        — mapped strategy: the coordinates of λ in
    ``[lam_offset, lam_offset + n)`` as a (dim, n) int32 array, a run of
    consecutive λ per thread, derived once and stepped.
  * ``membership_kernel`` — bounding-box strategy: the 0/1 int32 discard
    test of the box's cells as a (1, total) array, a run of consecutive
    cells per thread.

The host picks each launch's index width (``geometry.map_index_bits``,
``membership_index_bits``: 32-bit where proven exact) and makes the box's
division multipliers (``geometry.magic``).

Beside each kernel is its plain torch version (``map_plain``,
``membership_plain``), built from the registry's ``pallas``/``membership``
tiers in int64 with the same output layout.  The builders' ``interpret``
flag is the device choice: ``interpret=False`` launches the CUDA kernel and
raises where there is no card; ``interpret=True`` runs the plain version on
the CPU.  Nothing falls back from one to the other.

Build: at first use, each ``csrc/*.cu`` is compiled by ``nvcc`` (all at
once, one process each) into a shared library with a plain C interface,
through ``repro_torch.kernels.build``.  Importing this module builds
nothing.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.core.artifact import resolve_spec
from repro_torch.core.domains import get_domain
from repro_torch.core.registry import REGISTRY
from repro_torch.kernels import build
from repro_torch.kernels.domain_map import geometry as geo
from repro_torch.kernels.domain_map.geometry import (
    ALL_LEVELS, DIGITS, GEOMETRY, MAX_BASE, MAX_DIM, KernelGeometry,
)

#: kernel launches, counted by the wrappers where they launch and nowhere
#: else — a run reads them to show it went through the kernels
MAP_LAUNCHES = 0
MEMBERSHIP_LAUNCHES = 0
_count_mu = threading.Lock()

CSRC = Path(__file__).resolve().parent / "csrc"
#: the kernel libraries, one per ``csrc/<name>.cu``
LIBRARIES = ("map_kernel", "membership_kernel")

NO_CARD = ("no CUDA device: the domain-map kernels run on the card; pass "
           "interpret=True (a query's \"interpret\": true) to run their "
           "plain versions on the CPU")


class _Geom(ctypes.Structure):
    """ctypes mirror of ``DomainGeom`` in ``csrc/domain_map.cuh``."""

    _fields_ = [
        ("family", ctypes.c_int32), ("dim", ctypes.c_int32),
        ("m", ctypes.c_int32), ("perm", ctypes.c_int32 * MAX_DIM),
        ("nchain", ctypes.c_int32),
        ("chain_lo", ctypes.c_int32 * MAX_DIM),
        ("chain_hi", ctypes.c_int32 * MAX_DIM),
        ("base", ctypes.c_int32), ("scale", ctypes.c_int32),
        ("vecs", ctypes.c_int32 * (MAX_BASE * MAX_DIM)),
        ("allowed", ctypes.c_uint32), ("all_levels", ctypes.c_int32),
    ]


class _Magic(ctypes.Structure):
    """ctypes mirror of ``DmMagic`` in ``csrc/domain_map.cuh``."""

    _fields_ = [("mul", ctypes.c_uint64), ("sh1", ctypes.c_int32),
                ("sh2", ctypes.c_int32)]


class _Box(ctypes.Structure):
    """ctypes mirror of ``DomainBox`` in ``csrc/membership_kernel.cu``."""

    _fields_ = [("extent", ctypes.c_int64 * MAX_DIM),
                ("div_stride", _Magic * MAX_DIM),
                ("div_extent0", _Magic),
                ("group_levels", ctypes.c_int32),
                ("groups", ctypes.c_int32),
                ("top_mod", ctypes.c_int64)]


def pack_geometry(g: KernelGeometry) -> _Geom:
    """The kernels' argument block for one domain."""
    if g.family == DIGITS and (any(g.vecs[0]) or not g.allowed & 1):
        # the kernels lean on digit 0 adding nothing and on the origin
        # cell's code 0 being allowed
        raise ValueError(f"{g.name}: generator 0 is not the origin cell")
    c = _Geom(family=g.family, dim=g.dim, m=g.m, nchain=len(g.chain),
              base=g.base, scale=g.scale, allowed=g.allowed,
              all_levels=int(g.all_levels))
    for k, p in enumerate(g.perm):
        c.perm[k] = p
    for k, (lo, hi) in enumerate(g.chain):
        c.chain_lo[k], c.chain_hi[k] = lo, hi
    for d, vec in enumerate(g.vecs):
        for k, v in enumerate(vec):
            c.vecs[d * MAX_DIM + k] = v
    return c


#: each domain's packed argument block, built once (no kernel is built here)
PACKED: dict[str, _Geom] = {name: pack_geometry(g)
                            for name, g in GEOMETRY.items()}


def _strides(extent: tuple[int, ...]) -> list[int]:
    strides = [1] * len(extent)
    for k in range(len(extent) - 2, -1, -1):
        strides[k] = strides[k + 1] * extent[k + 1]
    return strides


def _pack_box(g: KernelGeometry, extent: tuple[int, ...], ndigits: int,
              bits: int) -> _Box:
    """The membership kernel's box block: extents, the multipliers of the
    strides and of extent[0] at the launch's width, and (DIGITS) the level
    groups to test."""
    box = _Box()
    for k, (e, s) in enumerate(zip(extent, _strides(extent))):
        box.extent[k] = e
        box.div_stride[k] = _Magic(*geo.magic(s, bits))
    box.div_extent0 = _Magic(*geo.magic(extent[0], bits))
    if g.family == DIGITS:
        levels = ALL_LEVELS if g.all_levels else ndigits
        box.group_levels, box.groups, box.top_mod = geo.digit_groups(
            g, extent, levels)
    return box


# ---------------------------------------------------------------------------
# build + bind
# ---------------------------------------------------------------------------


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    if hasattr(lib, "dm_map_launch"):
        lib.dm_map_launch.argtypes = [ctypes.POINTER(_Geom), vp, i64, i64,
                                      i32, i32, vp]
        lib.dm_map_launch.restype = ctypes.c_int
    if hasattr(lib, "dm_membership_launch"):
        lib.dm_membership_launch.argtypes = [
            ctypes.POINTER(_Geom), ctypes.POINTER(_Box), vp, i64, i32, vp]
        lib.dm_membership_launch.restype = ctypes.c_int
    return lib


#: the kernel libraries, one per ``csrc/<name>.cu``
LIBS = {name: build.register(build.Library(name, CSRC, _bind))
        for name in LIBRARIES}


def _library(name: str) -> ctypes.CDLL:
    return build.load(LIBS[name])


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(NO_CARD)


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _index_bits(auto: int, forced: int | None, what: str) -> int:
    """The launch's index width: the host's proven choice, or 64 (or a 32
    the proof allows) where a caller forces it."""
    if forced is None:
        return auto
    if forced not in (32, 64) or forced < auto:
        raise ValueError(f"{what}: {forced}-bit indices are not proven "
                         f"exact here (needs {auto})")
    return forced


def launch_map(domain_name: str, n_points: int, ndigits: int,
               lam_offset: int = 0) -> torch.Tensor:
    """Launch the map kernel on the current stream: (dim, n_points) int32
    coordinates of λ in ``[lam_offset, lam_offset + n_points)``."""
    return _launch_map(domain_name, n_points, ndigits, lam_offset)


def _launch_map(domain_name: str, n_points: int, ndigits: int,
                lam_offset: int = 0,
                index_bits: int | None = None) -> torch.Tensor:
    """``launch_map``; ``index_bits=64`` forces the 64-bit path (a check of
    that path on λ the 32-bit one would take)."""
    global MAP_LAUNCHES
    _require_cuda()
    geom = PACKED[domain_name]
    bits = _index_bits(
        geo.map_index_bits(GEOMETRY[domain_name], lam_offset, n_points),
        index_bits, f"map {domain_name} at {lam_offset}+{n_points}")
    out = torch.empty((geom.dim, n_points), dtype=torch.int32,
                      device="cuda")
    rc = _library("map_kernel").dm_map_launch(
        ctypes.byref(geom), ctypes.c_void_p(out.data_ptr()), n_points,
        lam_offset, ndigits, bits, _stream())
    if rc != 0:
        raise RuntimeError(f"map_kernel launch for {domain_name} failed: "
                           f"cudaError {rc}")
    with _count_mu:
        MAP_LAUNCHES += 1
    return out


def launch_membership(domain_name: str, extent: tuple[int, ...],
                      total: int, ndigits: int) -> torch.Tensor:
    """Launch the membership kernel on the current stream: the (1, total)
    int32 0/1 mask of the first ``total`` row-major cells of the box
    (indices past prod(extent) wrap around the box)."""
    return _launch_membership(domain_name, extent, total, ndigits)


def _launch_membership(domain_name: str, extent: tuple[int, ...],
                       total: int, ndigits: int,
                       index_bits: int | None = None) -> torch.Tensor:
    """``launch_membership``; ``index_bits=64`` forces the 64-bit path."""
    global MEMBERSHIP_LAUNCHES
    _require_cuda()
    geom = PACKED[domain_name]
    if len(extent) != geom.dim:
        raise ValueError(f"extent {extent} is not {geom.dim}-dimensional")
    bits = _index_bits(geo.membership_index_bits(total), index_bits,
                       f"membership {domain_name} over {total} cells")
    out = torch.empty((1, total), dtype=torch.int32, device="cuda")
    box = _pack_box(GEOMETRY[domain_name], tuple(extent), ndigits, bits)
    rc = _library("membership_kernel").dm_membership_launch(
        ctypes.byref(geom), ctypes.byref(box),
        ctypes.c_void_p(out.data_ptr()), total, bits, _stream())
    if rc != 0:
        raise RuntimeError(f"membership_kernel launch for {domain_name} "
                           f"failed: cudaError {rc}")
    with _count_mu:
        MEMBERSHIP_LAUNCHES += 1
    return out


def reset_launch_counts() -> None:
    global MAP_LAUNCHES, MEMBERSHIP_LAUNCHES
    with _count_mu:
        MAP_LAUNCHES = MEMBERSHIP_LAUNCHES = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _geometry_tier(spec, tier_name: str):
    """(domain, tier callable) for a map spec.

    A spec carrying a logic class (MapEntry) uses that entry's in-kernel
    tier when it registered one; otherwise it falls back to the domain's
    ground-truth geometry — the in-kernel map is per-domain geometry."""
    domain_name, logic = resolve_spec(spec)
    if logic is not None:
        try:
            entry = REGISTRY.resolve(domain_name, logic)
        except KeyError:
            entry = None
        if entry is not None and tier_name in entry.tiers:
            return domain_name, entry.tiers[tier_name]
    return domain_name, REGISTRY.tier(domain_name, None, tier_name)


def map_plain(spec, n_points: int, ndigits: int, lam_offset: int = 0,
              device="cpu") -> torch.Tensor:
    """Plain torch version of the map kernel: (dim, n_points) int32."""
    _, coords_fn = _geometry_tier(spec, "pallas")
    lam = torch.arange(n_points, dtype=torch.int64, device=device) \
        + lam_offset
    axes = coords_fn(lam, ndigits)
    return torch.stack([a.to(torch.int64) for a in axes]).to(torch.int32)


def membership_plain(spec, extent: tuple[int, ...], ndigits: int,
                     total: int | None = None, start: int = 0,
                     device="cpu") -> torch.Tensor:
    """Plain torch version of the membership kernel: the (1, total) int32
    mask of cells ``[start, start + total)`` (default: the whole box)."""
    _, membership_fn = _geometry_tier(spec, "membership")
    if total is None:
        total = 1
        for e in extent:
            total *= e
    lam = torch.arange(total, dtype=torch.int64, device=device) + start
    axes = [(lam // s) % e for s, e in zip(_strides(tuple(extent)), extent)]
    return membership_fn(axes, ndigits).to(torch.int32)[None, :]


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------


def build_map_call(spec, n_points: int, block_n: int = 1024,
                   ndigits: int = 13, interpret: bool = False,
                   lam_offset: int = 0):
    """Zero-argument thunk returning the (dim, n_points) int32 coordinates
    of λ in ``[lam_offset, lam_offset + n_points)``: a CUDA launch, or with
    ``interpret=True`` the plain version on the CPU."""
    if n_points % block_n:
        raise ValueError("pad N to a block multiple")
    domain_name, _ = resolve_spec(spec)
    get_domain(domain_name)
    if interpret:
        return lambda: map_plain(spec, n_points, ndigits, lam_offset)
    _require_cuda()
    _library("map_kernel")
    return lambda: launch_map(domain_name, n_points, ndigits, lam_offset)


def build_membership_call(spec, extent: tuple[int, ...],
                          block_n: int = 1024, ndigits: int = 13,
                          interpret: bool = False,
                          padded_total: int | None = None):
    """Zero-argument thunk returning the (1, total) int32 BB mask of the
    box, ``total`` being ``padded_total`` or prod(extent)."""
    total = 1
    for e in extent:
        total *= e
    total = padded_total if padded_total is not None else total
    if total % block_n:
        raise ValueError("pad the box to a block multiple")
    domain_name, _ = resolve_spec(spec)
    get_domain(domain_name)
    extent = tuple(extent)
    if interpret:
        return lambda: membership_plain(spec, extent, ndigits, total)
    _require_cuda()
    _library("membership_kernel")
    return lambda: launch_membership(domain_name, extent, total, ndigits)
