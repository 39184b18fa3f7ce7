"""CUDA kernel for the chunked RWKV-6 WKV, and its plain torch version.

``csrc/wkv.cu`` replaces the TPU kernel
``repro/kernels/wkv/kernel.py::_wkv_kernel``: per (batch, head), over
chunks in order with the (D, D) fp32 state carried across them,

    o     = tril_strict(P) V + diag((u ⊙ r)·k) V + (r ⊙ A_{t-1}) S_in
    S_out = A_C ⊙ S_in + Σ_s (k_s ⊙ A_C / A_s) v_s^T

with A the in-chunk cumulative product of the decay w and
P[t, s] = Σ_d r[t,d] k[s,d] A[t-1,d] / A[s,d].  Every decay factor is
exp of a non-positive difference of the cumulative log decay, so nothing
overflows where the TPU kernel's r̃ = r·A, k̃ = k/A does (see the note at
the top of the ``.cu``).

``launch_wkv`` launches it on the current stream over (B, S, H, D)
tensors read through their strides, and raises where there is no card; it
never falls back to the plain version.  ``wkv_chunked_plain`` is that
plain version: the same stable form, chunk by chunk, in torch, on the
reference's (BH, S, D) contract and on any device.

Build: at first use, ``csrc/wkv.cu`` is compiled by ``nvcc`` into a shared
library with a plain C interface, through ``repro_torch.kernels.build``.
Importing this module builds nothing.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels import build

#: launches of the WKV kernel, counted by ``launch_wkv`` where it launches
#: and nowhere else
WKV_LAUNCHES = 0
_count_mu = threading.Lock()

CSRC = Path(__file__).resolve().parent / "csrc"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNKS = (16, 32, 64)
HEAD_DIMS = (16, 32, 64)
SPLITS = (4, 2, 1)
_MIN_SLICE = 16             # v columns per block, at least

NO_CARD = ("no CUDA device: the wkv kernel runs on the card; pass "
           "interpret=True (cfg.pallas_interpret) with CPU tensors to run its "
           "plain version")


# ---------------------------------------------------------------------------
# build + bind
# ---------------------------------------------------------------------------


class _Args(ctypes.Structure):
    """ctypes mirror of ``WkvArgs`` in ``csrc/wkv.cu``."""

    _fields_ = [
        ("r", ctypes.c_void_p), ("k", ctypes.c_void_p),
        ("v", ctypes.c_void_p), ("w", ctypes.c_void_p),
        ("u", ctypes.c_void_p), ("s_in", ctypes.c_void_p),
        ("o", ctypes.c_void_p), ("s_out", ctypes.c_void_p),
        *[(f"{t}_s{ax}", ctypes.c_int64) for t in "rkvwo" for ax in "bsh"],
        ("heads", ctypes.c_int32), ("nbh", ctypes.c_int32),
        ("seq", ctypes.c_int32), ("dv", ctypes.c_int32),
    ]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32 = ctypes.c_int32
    lib.wkv_launch.argtypes = [ctypes.POINTER(_Args), i32, i32, i32, i32,
                               ctypes.c_void_p]
    lib.wkv_launch.restype = ctypes.c_int
    return lib


LIB = build.register(build.Library("wkv", CSRC, _bind))


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------


def check_shapes(r, k, v, w, u, state, chunk: int) -> None:
    """Raise ValueError on shapes the kernel and its plain version refuse.

    (BH, S, D) inputs take u (BH, D) and state (BH, D, D), the reference's
    contract; (B, S, H, D) inputs take u (H, D) and state (B, H, D, D)."""
    if r.dim() not in (3, 4) or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"want r, k, v, w of one (BH, S, D) or (B, S, H, D) "
                         f"shape; got {tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(w.shape)}")
    if r.dim() == 3:
        bh, s, d = r.shape
        want_u, want_state = (bh, d), (bh, d, d)
    else:
        b, s, h, d = r.shape
        want_u, want_state = (h, d), (b, h, d, d)
    if tuple(u.shape) != want_u or tuple(state.shape) != want_state:
        raise ValueError(f"u {tuple(u.shape)} / state {tuple(state.shape)}: "
                         f"want {want_u} / {want_state}")
    if chunk < 1 or s % chunk:
        raise ValueError(f"seq {s} is not a multiple of chunk {chunk}")


def heads_to_rows(r, k, v, w, u, state):
    """(B, S, H, D) inputs with u (H, D), state (B, H, D, D) as the
    reference's (B·H, S, D) contract with u (B·H, D), state (B·H, D, D)."""
    b, s, h, d = r.shape

    def rows(t):
        return t.permute(0, 2, 1, 3).reshape(b * h, s, d)

    return (*map(rows, (r, k, v, w)), u.repeat(b, 1),
            state.reshape(b * h, d, d))


def rows_to_heads(o, state, b: int, h: int):
    """The inverse of ``heads_to_rows`` for the outputs."""
    bh, s, d = o.shape
    return o.reshape(b, h, s, d).permute(0, 2, 1, 3), \
        state.reshape(b, h, d, d)


def n_split(bh: int, d: int, sm_count: int) -> int:
    """v-column slices per (b, h): as many as keep every block on an SM of
    its own (B·H·nsplit <= SMs), each slice at least 16 columns wide."""
    for n in SPLITS:
        if d % n == 0 and d // n >= _MIN_SLICE and bh * n <= sm_count:
            return n
    return 1


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(NO_CARD)


def launch_wkv(r, k, v, w, u, state, chunk: int = 64,
               heads_major: bool = False):
    """Launch the kernel on the current stream over r, k, v, w (B, S, H, D)
    (any strides, d contiguous), u (H, D) fp32 and state (B, H, D, D) fp32.

    Returns o (B, S, H, D) in r's dtype, stored (B, S, H, D) in memory, or
    (B, H, S, D) with ``heads_major`` (then ``o[0].transpose(0, 1)`` is the
    (BH, S, D) contract, contiguous), and the final state fp32.  Each (b, h)
    is cut into ``n_split`` v-column slices, one block each; the output
    does not depend on their number."""
    global WKV_LAUNCHES
    _require_cuda()
    check_shapes(r, k, v, w, u, state, chunk)
    if r.dim() != 4:
        raise ValueError("launch_wkv takes (B, S, H, D) tensors")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("state", state)):
        if not t.is_cuda:
            raise ValueError(f"{name} is on {t.device}: the kernel takes CUDA "
                             f"tensors")
    if r.dtype not in DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"dtypes {r.dtype}, {k.dtype}, {v.dtype}: the kernel "
                         f"takes r, k, v float32 or bfloat16, all alike")
    b, s, h, d = r.shape
    if chunk not in CHUNKS or d not in HEAD_DIMS:
        raise ValueError(f"chunk {chunk} / head_dim {d}: the kernel takes "
                         f"chunks {CHUNKS} and head dims {HEAD_DIMS}")
    nsplit = n_split(b * h, d, torch.cuda.get_device_properties(
        r.device).multi_processor_count)
    r, k, v = (t if t.stride(3) == 1 else t.contiguous() for t in (r, k, v))
    w = w.to(torch.float32)
    w = w if w.stride(3) == 1 else w.contiguous()
    u = u.to(torch.float32).contiguous()
    state = state.to(torch.float32).contiguous()
    if heads_major:
        o = torch.empty((b, h, s, d), dtype=r.dtype,
                        device=r.device).permute(0, 2, 1, 3)
    else:
        o = torch.empty((b, s, h, d), dtype=r.dtype, device=r.device)
    s_out = torch.empty_like(state)
    args = _Args(r=r.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
                 w=w.data_ptr(), u=u.data_ptr(), s_in=state.data_ptr(),
                 o=o.data_ptr(), s_out=s_out.data_ptr(), heads=h,
                 nbh=b * h, seq=s, dv=d // nsplit)
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("o", o)):
        for ax, stride in zip("bsh", t.stride()[:3]):
            setattr(args, f"{name}_s{ax}", stride)
    rc = build.load(LIB).wkv_launch(
        ctypes.byref(args), chunk, d, DTYPES[r.dtype], nsplit,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"wkv launch (chunk {chunk}, head_dim {d}, "
                           f"nsplit {nsplit}, {r.dtype}) failed: "
                           f"cudaError {rc}")
    with _count_mu:
        WKV_LAUNCHES += 1
    return o, s_out


def reset_launch_counts() -> None:
    global WKV_LAUNCHES
    with _count_mu:
        WKV_LAUNCHES = 0


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def wkv_chunked_plain(r, k, v, w, u, state, chunk: int = 64):
    """Plain torch version of the kernel's function, on r's device: r, k, v,
    w (BH, S, D), u (BH, D), state (BH, D, D).  A loop over the chunks, all
    in fp32, every decay factor exp of a non-positive difference of the
    in-chunk cumulative log decay.  Returns (o in r's dtype, final state
    fp32)."""
    check_shapes(r, k, v, w, u, state, chunk)
    if r.dim() != 3:
        raise ValueError("wkv_chunked_plain takes (BH, S, D) tensors")
    bh, s, d = r.shape
    rf, kf, vf = (t.to(torch.float32) for t in (r, k, v))
    logw = torch.log(w.to(torch.float32))
    uf = u.to(torch.float32)[:, None, :]
    S = state.to(torch.float32)
    dev = r.device
    strict = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=dev), diagonal=-1)
    eye = torch.eye(chunk, device=dev)
    zero_row = torch.zeros((bh, 1, d), device=dev)
    outs = []
    for c0 in range(0, s, chunk):
        rc, kc, vc = (t[:, c0:c0 + chunk] for t in (rf, kf, vf))
        cl = torch.cumsum(logw[:, c0:c0 + chunk], dim=1)     # log A_t
        clp = torch.cat([zero_row, cl[:, :-1]], dim=1)       # log A_{t-1}
        diff = clp[:, :, None, :] - cl[:, None, :, :]        # (bh, t, s, d)
        diff = diff.masked_fill(~strict[None, :, :, None], float("-inf"))
        pmat = torch.einsum("btd,bsd,btsd->bts", rc, kc, torch.exp(diff))
        pmat = pmat + eye * (rc * uf * kc).sum(-1)[:, :, None]
        cend = cl[:, -1:]                                    # log A_C
        outs.append(pmat @ vc + (rc * torch.exp(clp)) @ S)
        S = torch.exp(cend).transpose(1, 2) * S \
            + (kc * torch.exp(cend - cl)).transpose(1, 2) @ vc
    return torch.cat(outs, dim=1).to(r.dtype), S
