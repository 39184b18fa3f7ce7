"""CUDA kernels for causal attention over the triangular block domain.

The paper's technique applied to attention: the (q block i, k block j)
pairs with j <= i are the 2D lower-triangular domain.  ``csrc/tri_attn.cu``
replaces the TPU kernel ``repro/kernels/tri_attn/kernel.py::_attn_kernel``.
``launch_attention`` chooses one of two routes from the dtype and the shape,
before any launch (``attention_route``):

  * ``"sm90"`` — bf16, block 128, head_dim 64 or 128, the LM path's case
    (``csrc/tri_attn_sm90.cuh``): a persistent grid of about n_SM CTAs, each
    walking U consecutive cells of the grid in order — the mapped grid's
    B·H·T(nb) steps through the paper's exact triangular map, or the
    bounding box's B·H·nb² cells with j > i discarded — with the online
    softmax's (m, l, acc) in registers along each row, both products on the
    tensor cores (wgmma) and every tile brought by TMA.  A row cut by a CTA
    boundary leaves at most two fp32 pieces per CTA; a short second launch
    merges them in ascending j.  ``stream_grid`` / ``stream_pieces`` are that
    enumeration in Python, ``attention_stream_plain`` its arithmetic.
  * ``"simt"`` — every other shape (fp32; bf16 at other blocks or head
    dims): a pair launch whose grid is the paper's point (``"mapped"``
    launches B·H·T(nb) blocks, block λ deriving (i, j) from the inverse
    triangular map; ``"bounding_box"`` launches B·H·nb² and discards j > i),
    each writing its pair's partial (m, l, acc) to an fp32 workspace, then a
    combine launch merging them in ascending j, shared by both modes so
    their outputs are bit-identical.  ``attention_pairs_plain`` is its
    arithmetic.

``causal_attention_ref`` (``ref.py``) is the other plain version.
``launch_attention`` launches on the current stream and raises where there
is no card or a launch fails; it never gives way to the other route or to a
plain version.

Build: at first use, ``csrc/tri_attn.cu`` (which includes
``tri_attn_sm90.cuh``) is compiled by ``nvcc`` into a shared library with a
plain C interface, through ``repro_torch.kernels.build``.  Importing this
module builds nothing.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
from pathlib import Path

import torch

from repro_torch.kernels import build

NEG_INF = -1e30

#: launches of the attention kernel (its main launch and its combine, on
#: either route), counted by ``launch_attention`` where it launches and
#: nowhere else
ATTN_LAUNCHES = 0
#: the part of ATTN_LAUNCHES that took the sm90 route
ATTN_SM90_LAUNCHES = 0
_count_mu = threading.Lock()

CSRC = Path(__file__).resolve().parent / "csrc"
MODES = {"mapped": 0, "bounding_box": 1}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BLOCKS = (16, 32, 64, 128)
HEAD_DIMS = (8, 16, 32, 64, 128)
#: the most fp32 workspace (partials) one pair launch may use: the wrapper
#: splits B·H into launches that stay under it.  The workspace grows as
#: S²·D/block — 1.1 GB for (B, H, S, D) = (1, 32, 4096, 128) at block 128.
WORKSPACE_CAP_BYTES = 2 << 30
_MAX_GRID_YZ = 65535
#: the sm90 route's case: bf16, block 128, head_dim 64 or 128
SM90_BLOCK = 128
SM90_HEAD_DIMS = (64, 128)
#: an H100 SXM's SMs: the CTA count the plain version assumes off the card
H100_SMS = 132
LOG2E = math.log2(math.e)

NO_CARD = ("no CUDA device: the tri_attn kernel runs on the card; pass "
           "interpret=True (cfg.pallas_interpret) with CPU tensors to run its "
           "plain version")


def tri_grid_size(nb: int) -> int:
    return nb * (nb + 1) // 2


def attention_route(dtype: torch.dtype, block: int, head_dim: int) -> str:
    """``"sm90"`` for bf16, block 128 and head_dim 64 or 128 (yi-6b,
    llama3.2-3b, qwen3-32b, granite-8b: head_dim 128); ``"simt"`` for every
    other shape."""
    if (dtype == torch.bfloat16 and block == SM90_BLOCK
            and head_dim in SM90_HEAD_DIMS):
        return "sm90"
    return "simt"


def bh_group(bh: int, seq: int, head_dim: int, block: int) -> int:
    """simt route: how many (b, h) one pair launch takes: as many of the
    B·H as keep its workspace (T(nb)·block·(D+2) fp32 per (b, h)) under
    ``WORKSPACE_CAP_BYTES``, at least one.  A forward makes
    ceil(B·H / group) launches."""
    per_bh = tri_grid_size(seq // block) * block * (head_dim + 2) * 4
    return max(1, min(bh, WORKSPACE_CAP_BYTES // per_bh, _MAX_GRID_YZ))


def lam_to_ij(lam: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The paper's 2D triangular map g(λ) = (i, j), j <= i, exact, on an
    integer tensor.  i is seeded with a float64 root,
    i = floor((sqrt(8λ+1) - 1) / 2), and corrected by a ladder run until
    T(i) <= λ < T(i+1) holds everywhere, so no seed error survives."""
    lam = lam.to(torch.int64)
    i = (lam.to(torch.float64).mul_(8).add_(1).sqrt_().sub_(1).mul_(0.5)
         .floor_().to(torch.int64))
    while True:
        t = (i * (i + 1)) >> 1
        up = t + i + 1 <= lam
        down = t > lam
        if not bool((up | down).any()):
            return i, lam - t
        i = i + up.to(torch.int64) - down.to(torch.int64)


# ---------------------------------------------------------------------------
# build + bind
# ---------------------------------------------------------------------------


class _Args(ctypes.Structure):
    """ctypes mirror of ``TaArgs`` in ``csrc/tri_attn.cu``."""

    _fields_ = [
        ("q", ctypes.c_void_p), ("k", ctypes.c_void_p),
        ("v", ctypes.c_void_p), ("o", ctypes.c_void_p),
        *[(f"{t}_s{ax}", ctypes.c_int64) for t in "qkvo" for ax in "bhs"],
        ("ws_acc", ctypes.c_void_p), ("ws_m", ctypes.c_void_p),
        ("ws_l", ctypes.c_void_p),
        ("heads", ctypes.c_int32), ("kv_heads", ctypes.c_int32),
        ("bh0", ctypes.c_int32),
        ("nbh", ctypes.c_int32), ("nb", ctypes.c_int32),
        ("scale", ctypes.c_float),
    ]


class _Sm90Args(ctypes.Structure):
    """ctypes mirror of ``TaSm90Args`` in ``csrc/tri_attn_sm90.cuh``."""

    _fields_ = [
        ("q", ctypes.c_void_p), ("k", ctypes.c_void_p),
        ("v", ctypes.c_void_p), ("o", ctypes.c_void_p),
        *[(f"{t}_s{ax}", ctypes.c_int64) for t in "qkvo" for ax in "bhs"],
        ("ws_acc", ctypes.c_void_p), ("ws_m", ctypes.c_void_p),
        ("ws_l", ctypes.c_void_p),
        ("batch", ctypes.c_int32), ("heads", ctypes.c_int32),
        ("kv_heads", ctypes.c_int32), ("seq", ctypes.c_int32),
        ("nb", ctypes.c_int32), ("mode", ctypes.c_int32),
        ("steps_per_cta", ctypes.c_int64), ("n_cells", ctypes.c_int64),
        ("n_cta", ctypes.c_int64),
        ("scale_log2", ctypes.c_float),
    ]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    lib.ta_attn_launch.argtypes = [ctypes.POINTER(_Args), i32, i32, i32, i32,
                                   vp]
    lib.ta_attn_launch.restype = ctypes.c_int
    lib.ta_sm90_launch.argtypes = [ctypes.POINTER(_Sm90Args), i32, vp]
    lib.ta_sm90_launch.restype = ctypes.c_int
    lib.ta_lam_to_ij_launch.argtypes = [i64, i64, vp, vp, vp]
    lib.ta_lam_to_ij_launch.restype = ctypes.c_int
    return lib


LIB = build.register(build.Library("tri_attn", CSRC, _bind))


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(NO_CARD)


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def check_shapes(q, k, v, block: int) -> None:
    """Raise ValueError on shapes the kernel and its plain version refuse."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B, H, S, D) and k, v (B, Hk, S, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, d = q.shape
    if k.shape[0] != b or k.shape[2] != s or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    if k.shape[1] < 1 or h % k.shape[1]:
        raise ValueError(f"{h} heads are not a multiple of {k.shape[1]} kv "
                         f"heads")
    if block < 1 or s % block:
        raise ValueError(f"seq {s} is not a multiple of block {block}")


def launch_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     block: int, grid_mode: str) -> torch.Tensor:
    """Launch the kernel on the current stream: causal attention of q
    (B, H, S, D) against k, v (B, Hk, S, D), o (B, H, S, D) in q's dtype.

    The route follows ``attention_route`` (dtype, block, head_dim); the
    sm90 route takes ``default_steps_per_cta`` cells per CTA on this card's
    SM count.  o is stored (B, S, H, D) in memory, so the model's transpose
    back to (B, S, H, D) is free."""
    _require_cuda()
    check_shapes(q, k, v, block)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} is on {t.device}: the kernel takes CUDA "
                             f"tensors")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: the kernel "
                         f"takes float32 or bfloat16, all alike")
    if grid_mode not in MODES:
        raise ValueError(f"grid_mode {grid_mode!r}")
    d = q.shape[3]
    if block not in BLOCKS or d not in HEAD_DIMS:
        raise ValueError(f"block {block} / head_dim {d}: the kernel takes "
                         f"blocks {BLOCKS} and head dims {HEAD_DIMS}")
    if attention_route(q.dtype, block, d) == "sm90":
        return _launch_sm90(q, k, v, grid_mode)
    return _launch_simt(q, k, v, block, grid_mode)


def _launch_simt(q, k, v, block: int, grid_mode: str) -> torch.Tensor:
    global ATTN_LAUNCHES
    q, k, v = (t if t.stride(3) == 1 else t.contiguous() for t in (q, k, v))
    b, h, s, d = q.shape
    nb = s // block
    tri = tri_grid_size(nb)
    group = bh_group(b * h, s, d, block)
    ws = torch.empty(group * tri * block * (d + 2), dtype=torch.float32,
                     device=q.device)
    n_acc = group * tri * block * d
    n_row = group * tri * block
    o = torch.empty((b, s, h, d), dtype=q.dtype,
                    device=q.device).permute(0, 2, 1, 3)
    args = _Args(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), o=o.data_ptr(),
        ws_acc=ws.data_ptr(), ws_m=ws[n_acc:].data_ptr(),
        ws_l=ws[n_acc + n_row:].data_ptr(),
        heads=h, kv_heads=k.shape[1], nb=nb, scale=d ** -0.5)
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o)):
        for ax, stride in zip("bhs", t.stride()[:3]):
            setattr(args, f"{name}_s{ax}", stride)
    lib = build.load(LIB)
    for bh0 in range(0, b * h, group):
        args.bh0 = bh0
        args.nbh = min(group, b * h - bh0)
        rc = lib.ta_attn_launch(ctypes.byref(args), block, d, DTYPES[q.dtype],
                                MODES[grid_mode], _stream())
        if rc != 0:
            raise RuntimeError(f"tri_attn launch ({grid_mode}, block {block}, "
                               f"head_dim {d}, {q.dtype}) failed: "
                               f"cudaError {rc}")
        with _count_mu:
            ATTN_LAUNCHES += 1
    return o


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The card's SM count, or an H100's where the tensors lie on the CPU
    (the plain version's CTA grid)."""
    device = torch.device(device)
    if device.type != "cuda":
        return H100_SMS
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


def _tma_strides(t: torch.Tensor) -> tuple[torch.Tensor, list[int]]:
    """t, or a contiguous copy where a TMA map cannot describe it (d not
    contiguous, a base not 16-byte aligned, a stride not a multiple of 16
    bytes); and its (b, h, s) element strides, with any size-1 dimension's
    stride set to a valid multiple."""
    shape, st = t.shape, t.stride()
    if (st[3] != 1 or t.data_ptr() % 16
            or any(st[ax] % 8 for ax in range(3) if shape[ax] > 1)):
        t = t.contiguous()
        st = t.stride()
    return t, [st[ax] if shape[ax] > 1 else math.prod(shape[ax + 1:])
               for ax in range(3)]


def _sm90_error(rc: int) -> str:
    if rc == -1:
        return "cuTensorMapEncodeTiled not found (libcuda too old)"
    if rc <= -1000:
        return f"cuTensorMapEncodeTiled refused a map (CUresult {-1000 - rc})"
    return f"cudaError {rc}"


def _launch_sm90(q, k, v, grid_mode: str,
                 steps_per_cta: int | None = None) -> torch.Tensor:
    """The sm90 route on checked inputs; ``steps_per_cta`` (U) defaults to
    ``default_steps_per_cta`` on this card's SM count."""
    global ATTN_LAUNCHES, ATTN_SM90_LAUNCHES
    b, h, s, d = q.shape
    nb = s // SM90_BLOCK
    n_bh = b * h
    u = (default_steps_per_cta(n_bh, nb, sm_count(q.device))
         if steps_per_cta is None else int(steps_per_cta))
    if u < 1:
        raise ValueError(f"steps_per_cta {u}: want at least 1")
    n_cells = stream_cells(n_bh, nb, grid_mode)
    n_cta = -(-n_cells // u)
    o = torch.empty((b, s, h, d), dtype=q.dtype,
                    device=q.device).permute(0, 2, 1, 3)
    n_acc = n_cta * 2 * SM90_BLOCK * d       # then m, then l: n_row each
    n_row = n_cta * 2 * SM90_BLOCK
    ws = torch.empty(n_acc + 2 * n_row, dtype=torch.float32,
                     device=q.device)
    ws_ptr = ws.data_ptr()
    (q, qs), (k, ks), (v, vs) = (_tma_strides(t) for t in (q, k, v))
    args = _Sm90Args(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), *qs, *ks,
        *vs, *o.stride()[:3], ws_ptr, ws_ptr + 4 * n_acc,
        ws_ptr + 4 * (n_acc + n_row), b, h, k.shape[1], s, nb,
        MODES[grid_mode], u, n_cells, n_cta, d ** -0.5 * LOG2E)
    rc = build.load(LIB).ta_sm90_launch(ctypes.byref(args), d, _stream())
    if rc != 0:
        raise RuntimeError(f"tri_attn sm90 launch ({grid_mode}, head_dim {d},"
                           f" U {u}) failed: {_sm90_error(rc)}")
    with _count_mu:
        ATTN_LAUNCHES += 1
        ATTN_SM90_LAUNCHES += 1
    return o


def lam_to_ij_device(lam0: int, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(i, j) as int32 CUDA tensors for λ in [lam0, lam0 + n), computed by
    the pair kernel's own device function — to hold it exact."""
    _require_cuda()
    i = torch.empty(n, dtype=torch.int32, device="cuda")
    j = torch.empty(n, dtype=torch.int32, device="cuda")
    rc = build.load(LIB).ta_lam_to_ij_launch(
        lam0, n, ctypes.c_void_p(i.data_ptr()), ctypes.c_void_p(j.data_ptr()),
        _stream())
    if rc != 0:
        raise RuntimeError(f"tri_attn λ map launch failed: cudaError {rc}")
    return i, j


def reset_launch_counts() -> None:
    global ATTN_LAUNCHES, ATTN_SM90_LAUNCHES
    with _count_mu:
        ATTN_LAUNCHES = 0
        ATTN_SM90_LAUNCHES = 0


# ---------------------------------------------------------------------------
# the sm90 route's enumeration
# ---------------------------------------------------------------------------


def stream_cells(n_bh: int, nb: int, mode: str) -> int:
    """Cells the CTAs cut into ranges: B·H·T(nb) steps (mapped), or the
    B·H·nb² box (BB)."""
    if mode not in MODES:
        raise ValueError(f"grid_mode {mode!r}")
    return n_bh * (tri_grid_size(nb) if mode == "mapped" else nb * nb)


def default_steps_per_cta(n_bh: int, nb: int, n_sm: int) -> int:
    """U = ceil(B·H·T(nb) / n_SM): the mapped grid fills the card in one
    wave of CTAs; BB takes the same U over its box (about twice the CTAs)."""
    return max(1, -(-n_bh * tri_grid_size(nb) // n_sm))


def stream_ctas(n_bh: int, nb: int, steps_per_cta: int, mode: str) -> int:
    return -(-stream_cells(n_bh, nb, mode) // steps_per_cta)


def _cell(g: int, nb: int, mode: str) -> tuple[int, int, int]:
    """Cell γ as (bh, i, j), exact; in BB j may exceed i (discarded)."""
    if mode == "mapped":
        tri = tri_grid_size(nb)
        bh, lam = divmod(g, tri)
        i = (math.isqrt(8 * lam + 1) - 1) // 2
        return bh, i, lam - tri_grid_size(i)
    bh, r = divmod(g, nb * nb)
    return bh, r // nb, r % nb


def stream_grid(n_bh: int, nb: int, steps_per_cta: int, mode: str,
                device=None):
    """The sm90 route's work: CTA c takes the cells γ in [cU, (c+1)U) in
    order.  Returns int64 (bh, i, j) and a bool ``valid``, each
    (n_cta, U): cell (c, t) is γ = cU + t, valid where γ < the cell count
    and j <= i (BB discards the rest)."""
    u = steps_per_cta
    n_cells = stream_cells(n_bh, nb, mode)
    n_cta = -(-n_cells // u)
    g = torch.arange(n_cta * u, device=device, dtype=torch.int64)
    inside = g < n_cells
    g = g.clamp(max=n_cells - 1)
    if mode == "mapped":
        tri = tri_grid_size(nb)
        bh = g // tri
        i, j = lam_to_ij(g % tri)
    else:
        bh, r = g // (nb * nb), g % (nb * nb)
        i, j = r // nb, r % nb
    valid = inside & (j <= i)
    shape = (n_cta, u)
    return (bh.view(shape), i.view(shape), j.view(shape), valid.view(shape))


def stream_pieces(n_bh: int, nb: int, steps_per_cta: int, mode: str
                  ) -> list[tuple[int, int, list[tuple[int, int]]]]:
    """The rows that CTA boundaries cut, as (bh, i, [(cta, slot), ...]) in
    ascending j — found as the combine launch finds them: boundary c acts if
    cell cU has 0 < j <= i and the row's first cell lies in CTA c - 1.  The
    row's first CTA holds its piece in slot 1 (it starts at j = 0), every
    later CTA in slot 0 (it starts at j > 0)."""
    u = steps_per_cta
    n_cells = stream_cells(n_bh, nb, mode)
    rows = []
    for c in range(1, -(-n_cells // u)):
        bh, i, j = _cell(c * u, nb, mode)
        if j == 0 or j > i:
            continue
        row0 = c * u - j
        c0, c1 = row0 // u, (row0 + i) // u
        if c0 != c - 1:
            continue
        rows.append((bh, i, [(c0, 1)] + [(x, 0) for x in range(c0 + 1,
                                                               c1 + 1)]))
    return rows


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    block: int, grid_mode: str) -> torch.Tensor:
    """The plain version of the route the card takes for these shapes, with
    the card's CTA grid (an H100's where the tensors lie on the CPU)."""
    check_shapes(q, k, v, block)
    if attention_route(q.dtype, block, q.shape[3]) == "sm90":
        nb = q.shape[2] // block
        u = default_steps_per_cta(q.shape[0] * q.shape[1], nb,
                                  sm_count(q.device))
        return attention_stream_plain(q, k, v, block, u, grid_mode)
    return attention_pairs_plain(q, k, v, block)


def attention_stream_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           block: int, steps_per_cta: int,
                           grid_mode: str) -> torch.Tensor:
    """Plain torch version of the sm90 route's arithmetic, on q's device:
    ``stream_grid``'s CTAs walk their cells in step (all CTAs' t-th cell at
    once), each carrying the online softmax in the log2 domain along a row —
    s = (q k^T)·D^-1/2·log2 e in fp32, the causal mask where j == i,
    m' = max(m, rowmax s), p = 2^(s - m'), l' = l·2^(m - m') + Σp,
    acc' = acc·2^(m - m') + p v, with p rounded to bf16 before p v when the
    inputs are bf16, as the kernel's tensor-core product takes it.  A row
    that ends in its CTA writes acc / l; the pieces of a cut row go to their
    CTA's slot and are merged as ``stream_pieces`` lists them.  GQA reads kv
    head h // (H/Hk).  Returns o (B, H, S, D) in q's dtype."""
    check_shapes(q, k, v, block)
    b, h, s, d = q.shape
    hk = k.shape[1]
    group = h // hk
    nb = s // block
    n_bh = b * h
    dev = q.device
    f32 = torch.float32
    bh, i, j, valid = stream_grid(n_bh, nb, steps_per_cta, grid_mode, dev)
    n_cta, u = valid.shape
    qb = q.to(f32).reshape(n_bh, nb, block, d)
    kb = k.to(f32).reshape(b * hk, nb, block, d)
    vb = v.to(f32).reshape(b * hk, nb, block, d)
    scale_log2 = torch.tensor(d ** -0.5 * LOG2E, dtype=f32).item()
    round_p = q.dtype == torch.bfloat16
    first = valid.to(torch.int8).argmax(1)
    last = u - 1 - valid.flip(1).to(torch.int8).argmax(1)
    pos = torch.arange(block, device=dev)
    above = pos[None, :] > pos[:, None]              # key after query
    m = torch.full((n_cta, block), NEG_INF, dtype=f32, device=dev)
    lsum = torch.zeros((n_cta, block), dtype=f32, device=dev)
    acc = torch.zeros((n_cta, block, d), dtype=f32, device=dev)
    seg_j0 = torch.zeros(n_cta, dtype=torch.int64, device=dev)
    out = torch.empty((n_bh, nb, block, d), dtype=f32, device=dev)
    ws_acc = torch.zeros((n_cta, 2, block, d), dtype=f32, device=dev)
    ws_m = torch.zeros((n_cta, 2, block), dtype=f32, device=dev)
    ws_l = torch.zeros((n_cta, 2, block), dtype=f32, device=dev)
    ctas = torch.arange(n_cta, device=dev)
    for t in range(u):
        c = ctas[valid[:, t]]
        if c.numel() == 0:
            continue
        bt, it, jt = bh[c, t], i[c, t], j[c, t]
        new = (jt == 0) | (first[c] == t)
        cn = c[new]
        m[cn], lsum[cn], acc[cn] = NEG_INF, 0.0, 0.0
        seg_j0[cn] = jt[new]
        kv = (bt // h) * hk + (bt % h) // group
        sc = torch.einsum("nrd,ncd->nrc", qb[bt, it], kb[kv, jt]) * scale_log2
        sc = torch.where((it == jt)[:, None, None] & above, NEG_INF, sc)
        mn = torch.maximum(m[c], sc.amax(-1))
        alpha = torch.exp2(m[c] - mn)
        p = torch.exp2(sc - mn[..., None])
        lsum[c] = lsum[c] * alpha + p.sum(-1)
        if round_p:
            p = p.to(torch.bfloat16).to(f32)
        acc[c] = acc[c] * alpha[..., None] + torch.einsum("nrc,ncd->nrd", p,
                                                          vb[kv, jt])
        m[c] = mn
        end = (jt == it) | (last[c] == t)
        ce, be, ie = c[end], bt[end], it[end]
        whole = (seg_j0[ce] == 0) & (jt[end] == ie)
        cw = ce[whole]
        out[be[whole], ie[whole]] = acc[cw] / lsum[cw][..., None]
        cp = ce[~whole]
        slot = (seg_j0[cp] == 0).to(torch.int64)
        ws_acc[cp, slot], ws_m[cp, slot], ws_l[cp, slot] = \
            acc[cp], m[cp], lsum[cp]
    for row_bh, row_i, pieces in stream_pieces(n_bh, nb, steps_per_cta,
                                               grid_mode):
        mr = torch.full((block,), NEG_INF, dtype=f32, device=dev)
        lr = torch.zeros((block,), dtype=f32, device=dev)
        ar = torch.zeros((block, d), dtype=f32, device=dev)
        for cta, slot in pieces:
            mj = ws_m[cta, slot]
            mn = torch.maximum(mr, mj)
            alpha, beta = torch.exp2(mr - mn), torch.exp2(mj - mn)
            lr = lr * alpha + ws_l[cta, slot] * beta
            ar = ar * alpha[:, None] + ws_acc[cta, slot] * beta[:, None]
            mr = mn
        out[row_bh, row_i] = ar / lr[:, None]
    return out.reshape(b, h, s, d).to(q.dtype)


def attention_pairs_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          block: int) -> torch.Tensor:
    """Plain torch version of the kernel's arithmetic, on q's device: every
    (i, j) pair's partial (block-local max m, l = Σ exp(s - m),
    acc = exp(s - m)·v) in fp32, then the merge over ascending j with the
    online-softmax rescale.  GQA reads kv head h // (H/Hk), as the kernel
    does.  Returns o (B, H, S, D) in q's dtype."""
    check_shapes(q, k, v, block)
    b, h, s, d = q.shape
    hk = k.shape[1]
    g = h // hk
    nb = s // block
    dev = q.device
    qf = (q.to(torch.float32) * (d ** -0.5)).reshape(b, hk, g, nb, block, d)
    kf = k.to(torch.float32).reshape(b, hk, nb, block, d)
    vf = v.to(torch.float32).reshape(b, hk, nb, block, d)
    i, j = lam_to_ij(torch.arange(tri_grid_size(nb), device=dev))
    sc = torch.einsum("bkgtrd,bktcd->bkgtrc", qf[:, :, :, i], kf[:, :, j])
    pos = torch.arange(block, device=dev)
    keep = (i[:, None, None] * block + pos[:, None]
            >= j[:, None, None] * block + pos[None, :])
    sc = torch.where(keep, sc, torch.full_like(sc, NEG_INF))
    m = sc.amax(dim=-1)
    p = torch.exp(sc - m[..., None])
    l_pair = p.sum(dim=-1)
    acc = torch.einsum("bkgtrc,bktcd->bkgtrd", p, vf[:, :, j])

    m_run = torch.full((b, hk, g, nb, block), NEG_INF, device=dev)
    l_run = torch.zeros((b, hk, g, nb, block), device=dev)
    a_run = torch.zeros((b, hk, g, nb, block, d), device=dev)
    for jj in range(nb):
        rows = torch.arange(jj, nb, device=dev)
        lam = rows * (rows + 1) // 2 + jj
        mj = m[:, :, :, lam]
        mn = torch.maximum(m_run[:, :, :, rows], mj)
        alpha = torch.exp(m_run[:, :, :, rows] - mn)
        beta = torch.exp(mj - mn)
        l_run[:, :, :, rows] = l_run[:, :, :, rows] * alpha \
            + l_pair[:, :, :, lam] * beta
        a_run[:, :, :, rows] = a_run[:, :, :, rows] * alpha[..., None] \
            + acc[:, :, :, lam] * beta[..., None]
        m_run[:, :, :, rows] = mn
    out = a_run / l_run[..., None]
    return out.reshape(b, h, s, d).to(q.dtype)
