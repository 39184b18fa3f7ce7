"""CUDA kernel for causal attention over the triangular block domain.

The paper's technique applied to attention: the (q block i, k block j)
pairs with j <= i are the 2D lower-triangular domain.  ``csrc/tri_attn.cu``
replaces the TPU kernel ``repro/kernels/tri_attn/kernel.py::_attn_kernel``
with two launches (see the note at its top):

  * a pair launch whose grid is the paper's point: ``"mapped"`` launches
    exactly B·H·T(nb) blocks, block λ deriving (i, j) from the inverse
    triangular map with an exact integer square root; ``"bounding_box"``
    launches B·H·nb² blocks and discards those with j > i.  Each block
    writes its pair's partial (m, l, acc) to an fp32 workspace;
  * a combine launch, one block per (bh, i), that merges the partials in
    ascending j — shared by both modes, so their outputs are bit-identical.

Beside it are the plain torch versions: the exact ``lam_to_ij`` and
``attention_pairs_plain``, the same pair-and-combine arithmetic on any
device (``ref.causal_attention_ref`` is the other).  ``launch_attention``
launches the kernel on the current stream and raises where there is no
card; it never falls back to a plain version.

Build: at first use, ``csrc/tri_attn.cu`` is compiled by ``nvcc`` into a
shared library with a plain C interface, through
``repro_torch.kernels.build``.  Importing this module builds nothing.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels import build

NEG_INF = -1e30

#: launches of the attention kernel (one pair launch and its combine),
#: counted by ``launch_attention`` where it launches and nowhere else
ATTN_LAUNCHES = 0
_count_mu = threading.Lock()

CSRC = Path(__file__).resolve().parent / "csrc"
MODES = {"mapped": 0, "bounding_box": 1}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BLOCKS = (16, 32, 64, 128)
HEAD_DIMS = (16, 32, 64, 128)
#: the most fp32 workspace (partials) one pair launch may use: the wrapper
#: splits B·H into launches that stay under it.  The workspace grows as
#: S²·D/block — 1.1 GB for (B, H, S, D) = (1, 32, 4096, 128) at block 128.
WORKSPACE_CAP_BYTES = 2 << 30
_MAX_GRID_YZ = 65535

NO_CARD = ("no CUDA device: the tri_attn kernel runs on the card; pass "
           "interpret=True (cfg.pallas_interpret) with CPU tensors to run its "
           "plain version")


def tri_grid_size(nb: int) -> int:
    return nb * (nb + 1) // 2


def bh_group(bh: int, seq: int, head_dim: int, block: int) -> int:
    """How many (b, h) one pair launch takes: as many of the B·H as keep
    its workspace (T(nb)·block·(D+2) fp32 per (b, h)) under
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


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    lib.ta_attn_launch.argtypes = [ctypes.POINTER(_Args), i32, i32, i32, i32,
                                   vp]
    lib.ta_attn_launch.restype = ctypes.c_int
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

    o is stored (B, S, H, D) in memory, so the model's transpose back to
    (B, S, H, D) is free."""
    global ATTN_LAUNCHES
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
    b, h, s, d = q.shape
    if block not in BLOCKS or d not in HEAD_DIMS:
        raise ValueError(f"block {block} / head_dim {d}: the kernel takes "
                         f"blocks {BLOCKS} and head dims {HEAD_DIMS}")
    q, k, v = (t if t.stride(3) == 1 else t.contiguous() for t in (q, k, v))
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
    global ATTN_LAUNCHES
    with _count_mu:
        ATTN_LAUNCHES = 0


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


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
