"""CUDA kernels for the chunked RWKV-6 WKV, and their plain torch versions.

``csrc/wkv.cu`` replaces the TPU kernel
``repro/kernels/wkv/kernel.py::_wkv_kernel``: per (batch, head), over
chunks with the (D, D) fp32 state carried across them,

    o     = tril_strict(P) V + diag((u ⊙ r)·k) V + (r ⊙ A_{t-1}) S_in
    S_out = A_C ⊙ S_in + Σ_s (k_s ⊙ A_C / A_s) v_s^T

with A the in-chunk cumulative product of the decay w and
P[t, s] = Σ_d r[t,d] k[s,d] A[t-1,d] / A[s,d].  Every decay factor is
exp of a non-positive difference of the cumulative log decay, so nothing
overflows where the TPU kernel's r̃ = r·A, k̃ = k/A does (see the note at
the top of the ``.cu``).

``launch_wkv`` issues three kernels on the current stream over (B, S, H, D)
tensors read through their strides: the chunk states (each chunk's
ΔS_c = Σ_s (k_s ⊙ A_C / A_s) v_s^T and A_C, into a workspace), the state
scan (S_in of every chunk, in chunk order) and the chunk outputs.  It
raises where there is no card; it never falls back to the plain versions.
``wkv_chunk_states_plain``, ``wkv_state_scan_plain`` and
``wkv_chunk_outputs_plain`` are the three kernels' plain versions, and
``wkv_chunked_plain``, their composition, is the whole function's, on the
reference's (BH, S, D) contract and on any device.

Build: at first use, ``csrc/wkv.cu`` is compiled by ``nvcc`` into a shared
library with a plain C interface, through ``repro_torch.kernels.build``.
Importing this module builds nothing.
"""
from __future__ import annotations

import ctypes
import math
import threading
from pathlib import Path

import torch

from repro_torch.kernels import build

#: calls of ``launch_wkv`` that launched the three kernels (chunk states,
#: state scan, chunk outputs), counted there and nowhere else: one a layer
WKV_LAUNCHES = 0
#: kernels those calls issued, as ``wkv_launch`` reports them
WKV_KERNELS = 0
_count_mu = threading.Lock()

CSRC = Path(__file__).resolve().parent / "csrc"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: o's dtypes the kernels write, by the dtype of r, k, v
OUT_DTYPES = {torch.float32: (torch.float32,),
              torch.bfloat16: (torch.bfloat16, torch.float32)}
CHUNKS = (16, 32, 64)
HEAD_DIMS = (16, 32, 64)
MAX_CHUNKS = 65535          # the chunk kernels' grid.y (WKV_MAX_CHUNKS)

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
        ("ws", ctypes.c_void_p), ("a_end", ctypes.c_void_p),
        *[(f"{t}_s{ax}", ctypes.c_int64) for t in "rkvwo" for ax in "bsh"],
        ("heads", ctypes.c_int32), ("nbh", ctypes.c_int32),
        ("seq", ctypes.c_int32),
    ]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32 = ctypes.c_int32
    lib.wkv_launch.argtypes = [ctypes.POINTER(_Args), i32, i32, i32, i32,
                               i32, ctypes.c_void_p, ctypes.POINTER(i32)]
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


def launch_plan(r, k, v, w, u, state, chunk: int = 64,
                out_dtype=None) -> dict:
    """The host's choices for ``launch_wkv`` over these (B, S, H, D)
    tensors, on any device: o's dtype (default r's) and the shapes of the
    fp32 buffers the wrapper allocates, the workspace (B·H, S / chunk, D,
    D), which holds each chunk's ΔS and then its S_in, and ``a_end``
    (B·H, S / chunk, D).  Raises ValueError on what the kernels do not
    take."""
    check_shapes(r, k, v, w, u, state, chunk)
    if r.dim() != 4:
        raise ValueError("launch_wkv takes (B, S, H, D) tensors")
    if r.dtype not in DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"dtypes {r.dtype}, {k.dtype}, {v.dtype}: the kernel "
                         f"takes r, k, v float32 or bfloat16, all alike")
    out_dtype = r.dtype if out_dtype is None else out_dtype
    if out_dtype not in OUT_DTYPES[r.dtype]:
        raise ValueError(f"o {out_dtype} from r, k, v {r.dtype}: the kernel "
                         f"writes {OUT_DTYPES[r.dtype]}")
    b, s, h, d = r.shape
    if chunk not in CHUNKS or d not in HEAD_DIMS:
        raise ValueError(f"chunk {chunk} / head_dim {d}: the kernel takes "
                         f"chunks {CHUNKS} and head dims {HEAD_DIMS}")
    nc = s // chunk
    if nc > MAX_CHUNKS:
        raise ValueError(f"{nc} chunks: the kernel takes at most {MAX_CHUNKS}")
    return {"out_dtype": out_dtype, "workspace": (b * h, nc, d, d),
            "a_end": (b * h, nc, d)}


def _aligned(t):
    """``t`` where the kernels can read it four elements at a time (d
    contiguous, the other strides multiples of 4, the start on a 4-element
    boundary), else a contiguous copy."""
    if t.stride(3) == 1 and all(st % 4 == 0 for st in t.stride()[:3]) \
            and t.data_ptr() % (4 * t.element_size()) == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(NO_CARD)


def launch_wkv(r, k, v, w, u, state, chunk: int = 64,
               heads_major: bool = False, out_dtype=None):
    """Launch the three kernels on the current stream over r, k, v, w
    (B, S, H, D) (any strides, d contiguous), u (H, D) fp32 and state
    (B, H, D, D) fp32.

    Returns o (B, S, H, D) in ``out_dtype`` (default r's dtype; bf16 r, k, v
    may write fp32), stored (B, S, H, D) in memory, or (B, H, S, D) with
    ``heads_major`` (then ``o[0].transpose(0, 1)`` is the (BH, S, D)
    contract, contiguous), and the final state fp32.  The chunk states go
    through a workspace of ``launch_plan``'s shape."""
    return _launch(r, k, v, w, u, state, chunk, heads_major, out_dtype)[:2]


def _launch(r, k, v, w, u, state, chunk, heads_major, out_dtype, phases=3):
    """``launch_wkv``, issuing the first ``phases`` of the three kernels,
    and returning (o, s_out, workspace, a_end) as they leave them: after
    the first, the workspace holds each chunk's ΔS; after the second, its
    S_in.  Counts one launch a call, and the kernels it issued."""
    global WKV_LAUNCHES, WKV_KERNELS
    _require_cuda()
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("state", state)):
        if not t.is_cuda:
            raise ValueError(f"{name} is on {t.device}: the kernel takes CUDA "
                             f"tensors")
    plan = launch_plan(r, k, v, w, u, state, chunk, out_dtype)
    b, s, h, d = r.shape
    r, k, v = map(_aligned, (r, k, v))
    w = _aligned(w.to(torch.float32))
    u = u.to(torch.float32).contiguous()
    state = state.to(torch.float32).contiguous()
    out_dtype, dev = plan["out_dtype"], r.device
    if heads_major:
        o = torch.empty((b, h, s, d), dtype=out_dtype,
                        device=dev).permute(0, 2, 1, 3)
    else:
        o = torch.empty((b, s, h, d), dtype=out_dtype, device=dev)
    s_out = torch.empty_like(state)
    n_ws, n_a = math.prod(plan["workspace"]), math.prod(plan["a_end"])
    buf = torch.empty(n_ws + n_a, dtype=torch.float32, device=dev)
    ws = buf[:n_ws].view(plan["workspace"])
    a_end = buf[n_ws:].view(plan["a_end"])
    args = _Args(r=r.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
                 w=w.data_ptr(), u=u.data_ptr(), s_in=state.data_ptr(),
                 o=o.data_ptr(), s_out=s_out.data_ptr(), ws=ws.data_ptr(),
                 a_end=a_end.data_ptr(), heads=h, nbh=b * h, seq=s)
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("o", o)):
        for ax, stride in zip("bsh", t.stride()[:3]):
            setattr(args, f"{name}_s{ax}", stride)
    issued = ctypes.c_int32(0)
    rc = build.load(LIB).wkv_launch(
        ctypes.byref(args), chunk, d, DTYPES[r.dtype], DTYPES[out_dtype],
        phases, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        ctypes.byref(issued))
    if rc != 0:
        raise RuntimeError(f"wkv launch (chunk {chunk}, head_dim {d}, "
                           f"{r.dtype} -> {out_dtype}) failed: cudaError {rc}")
    with _count_mu:
        WKV_LAUNCHES += 1
        WKV_KERNELS += issued.value
    return o, s_out, ws, a_end


def reset_launch_counts() -> None:
    global WKV_LAUNCHES, WKV_KERNELS
    with _count_mu:
        WKV_LAUNCHES = WKV_KERNELS = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _chunks(t, chunk: int):
    """(BH, S, D) as (BH, S / chunk, chunk, D) fp32."""
    bh, s, d = t.shape
    return t.to(torch.float32).reshape(bh, s // chunk, chunk, d)


def _cum_log_decay(w, chunk: int):
    """L[t] = Σ_{u<=t} log w_u within each chunk: (BH, S / chunk, chunk, D)."""
    return torch.cumsum(torch.log(_chunks(w, chunk)), dim=2)


def wkv_chunk_states_plain(k, v, w, chunk: int = 64):
    """Plain version of the chunk-states kernel: k, v, w (BH, S, D).  Per
    chunk c, ΔS_c = Σ_s (k_s ⊙ exp(L[C-1] - L[s])) v_s^T (BH, S / chunk, D,
    D) and A_c = exp(L[C-1]) (BH, S / chunk, D), fp32."""
    L = _cum_log_decay(w, chunk)
    kt = _chunks(k, chunk) * torch.exp(L[:, :, -1:] - L)
    return kt.transpose(2, 3) @ _chunks(v, chunk), torch.exp(L[:, :, -1])


def wkv_state_scan_plain(ws, a_end, state):
    """Plain version of the scan kernel: ΔS (BH, nc, D, D) and A
    (BH, nc, D) from ``wkv_chunk_states_plain``, state (BH, D, D).  In chunk
    order, S_in of chunk c is S, then S <- A_c ⊙ S + ΔS_c, each step in
    float64 and rounded to fp32 once, as the kernel's fmaf rounds (but for
    the rare tie of a double rounding).  Returns (S_in of every chunk
    (BH, nc, D, D), the final state) fp32."""
    S = state.to(torch.float32)
    s_in = []
    for c in range(ws.shape[1]):
        s_in.append(S)
        S = torch.addcmul(ws[:, c].double(), a_end[:, c, :, None].double(),
                          S.double()).to(torch.float32)
    return torch.stack(s_in, dim=1), S


def wkv_chunk_outputs_plain(r, k, v, w, u, s_in, chunk: int = 64,
                            out_dtype=None):
    """Plain version of the chunk-outputs kernel: r, k, v, w (BH, S, D), u
    (BH, D), s_in (BH, S / chunk, D, D), the state before each chunk.  Per
    chunk, o = P v + (r ⊙ exp(L[t-1])) S_in with the strictly-lower pair
    matrix P[t, s] = Σ_d r[t,d] k[s,d] exp(L[t-1,d] - L[s,d]) and the bonus
    diagonal (r ⊙ u)·k.  Returns o (BH, S, D) in ``out_dtype`` (default
    r's)."""
    L = _cum_log_decay(w, chunk)
    Lp = torch.cat([torch.zeros_like(L[:, :, :1]), L[:, :, :-1]], dim=2)
    rc, kc, vc = (_chunks(t, chunk) for t in (r, k, v))
    uf = u.to(torch.float32)[:, None, :]
    strict = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=r.device), diagonal=-1)
    eye = torch.eye(chunk, device=r.device)
    outs = []
    for c in range(L.shape[1]):
        rr, kk = rc[:, c], kc[:, c]
        diff = Lp[:, c, :, None, :] - L[:, c, None, :, :]   # (bh, t, s, d)
        diff = diff.masked_fill(~strict[None, :, :, None], float("-inf"))
        pmat = torch.einsum("btd,bsd,btsd->bts", rr, kk, torch.exp(diff))
        pmat = pmat + eye * (rr * uf * kk).sum(-1)[:, :, None]
        outs.append(pmat @ vc[:, c] + (rr * torch.exp(Lp[:, c])) @ s_in[:, c])
    return torch.cat(outs, dim=1).to(out_dtype or r.dtype)


def wkv_chunked_plain(r, k, v, w, u, state, chunk: int = 64, out_dtype=None):
    """Plain torch version of the whole function, on r's device: r, k, v, w
    (BH, S, D), u (BH, D), state (BH, D, D).  The three kernels' plain
    versions in turn, in fp32 (the scan's steps each rounded once from
    float64), every decay factor exp of a non-positive difference of the
    in-chunk cumulative log decay.  Returns (o in ``out_dtype``, default
    r's dtype; final state fp32)."""
    check_shapes(r, k, v, w, u, state, chunk)
    if r.dim() != 3:
        raise ValueError("wkv_chunked_plain takes (BH, S, D) tensors")
    ws, a_end = wkv_chunk_states_plain(k, v, w, chunk)
    s_in, s_out = wkv_state_scan_plain(ws, a_end, state)
    return wkv_chunk_outputs_plain(r, k, v, w, u, s_in, chunk,
                                   out_dtype), s_out
