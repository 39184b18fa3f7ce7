"""The port's chunked WKV (repro_torch.kernels.wkv) against the JAX
package's, on the CPU: every case of tests/test_kernels_wkv.py in fp32,
bf16 and bf16 in / fp32 out, the state carried across calls, the oracles,
the strong-decay inputs where the reference's chunked form overflows,
gradients, the (B, S, H, D) layout, the host's launch choices, and the
kernel path raising where there is no card.  The reference
runs its Pallas kernel in interpret mode; the port runs the plain versions
of its CUDA kernels (``interpret=True``).  Inputs are made by numpy from a
seed."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv.ops import wkv_chunked as ref_wkv_chunked
from repro.kernels.wkv.ref import wkv_ref as ref_wkv_ref
from repro_torch.kernels.wkv import kernel
from repro_torch.kernels.wkv.ops import wkv_chunked
from repro_torch.kernels.wkv.ref import wkv_ref

CASES = [
    # (batch*heads, seq, head_dim, chunk) — tests/test_kernels_wkv.py
    (2, 128, 16, 32),
    (1, 256, 32, 64),
    (4, 64, 64, 16),
]
#: name -> (reference dtype, port r/k/v dtype, port o dtype)
DTYPES = {"float32": (jnp.float32, torch.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, torch.bfloat16),
          "bfloat16-float32": (jnp.bfloat16, torch.bfloat16, torch.float32)}
TOL = 1e-4
#: bf16 o: both sides compute in fp32 and round o to bf16 once, so they
#: differ by at most one bf16 ulp of the element, at most 2^-7 of the row's
#: max |o|; against the fp32 oracle, half that.  TOL covers the fp32 part.
#: bf16 r, k, v with fp32 o: the widening is exact, so TOL alone, against
#: the reference's kernel on the widened inputs.
BF16_ROW_RTOL = 2.0 ** -7
#: uniform decays w = exp(-exp(dec)): 0.26, 0.19, 0.066, 6e-4
STRONG_DECAYS = [0.3, 0.5, 1.0, 2.0]


def _inputs(seed, bh, s, d, dec=None):
    """tests/test_kernels_wkv.py's distributions: r, k, v ~ N(0, 0.25),
    w = exp(-exp(N(0, 0.09) - 5)) (the rwkv regime) or a uniform
    exp(-exp(dec)), u ~ N(0, 0.25), a zero state."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((bh, s, d)).astype(np.float32) * 0.5
               for _ in range(3))
    if dec is None:
        w = np.exp(-np.exp(rng.standard_normal((bh, s, d)) * 0.3 - 5.0))
    else:
        w = np.full((bh, s, d), np.exp(-np.exp(dec)))
    u = rng.standard_normal((bh, d)).astype(np.float32) * 0.5
    s0 = np.zeros((bh, d, d), np.float32)
    return r, k, v, w.astype(np.float32), u, s0


def _torch(arrays, dtype=torch.float32):
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in arrays)
    return r.to(dtype), k.to(dtype), v.to(dtype), w, u, s0


def _jax(arrays, dtype=jnp.float32):
    r, k, v, w, u, s0 = (jnp.asarray(a) for a in arrays)
    return r.astype(dtype), k.astype(dtype), v.astype(dtype), w, u, s0


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _row_excess(got, want, rtol):
    """max over rows of max |got - want| - rtol · max |want| over the row
    (<= TOL passes)."""
    g, w = _np(got), _np(want)
    dev = np.abs(g - w).max(-1)
    return float((dev - rtol * np.abs(w).max(-1)).max())


@pytest.mark.parametrize("bh,s,d,chunk", CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_matches_reference_kernel_and_recurrence(bh, s, d, chunk, dtype):
    jdt, tdt, odt = DTYPES[dtype]
    arrays = _inputs(0, bh, s, d)
    o, st = wkv_chunked(*_torch(arrays, tdt), chunk=chunk, interpret=True,
                        out_dtype=odt)
    rounded = [_np(t) for t in _torch(arrays, tdt)]
    if odt == torch.float32:    # the reference writes o in r's dtype
        o_k, s_k = ref_wkv_chunked(*map(jnp.asarray, rounded), chunk=chunk,
                                   interpret=True)
    else:
        o_k, s_k = ref_wkv_chunked(*_jax(arrays, jdt), chunk=chunk,
                                   interpret=True)
    # the oracle on the rounded inputs, as tests/test_kernels_wkv.py runs it
    o_r, s_r = ref_wkv_ref(*map(jnp.asarray, rounded))
    assert o.dtype == odt and o.shape == (bh, s, d)
    assert st.dtype == torch.float32 and st.shape == (bh, d, d)
    # the plain version is the three kernels' plain versions in turn
    x = _torch(arrays, tdt)
    ws, a_end = kernel.wkv_chunk_states_plain(*x[1:4], chunk)
    s_in, s_out = kernel.wkv_state_scan_plain(ws, a_end, x[5])
    o_p, st_p = kernel.wkv_chunked_plain(*x, chunk, odt)
    assert torch.equal(o_p, kernel.wkv_chunk_outputs_plain(
        *x[:5], s_in, chunk, odt)) and torch.equal(st_p, s_out)
    for want, rtol in ((o_k, BF16_ROW_RTOL), (o_r, BF16_ROW_RTOL / 2)):
        if odt == torch.float32:
            assert np.abs(_np(o) - _np(want)).max() < TOL
        else:
            assert _row_excess(o, want, rtol) < TOL
    for want in (s_k, s_r):
        assert np.abs(_np(st) - _np(want)).max() < TOL


def test_state_carries_across_calls():
    """tests/test_kernels_wkv.py:39: two calls chained through the state
    equal one call."""
    r, k, v, w, u, s0 = _torch(_inputs(1, 2, 128, 16))
    o_full, s_full = wkv_chunked(r, k, v, w, u, s0, chunk=32, interpret=True)
    oa, sa = wkv_chunked(r[:, :64], k[:, :64], v[:, :64], w[:, :64], u, s0,
                         chunk=32, interpret=True)
    ob, sb = wkv_chunked(r[:, 64:], k[:, 64:], v[:, 64:], w[:, 64:], u, sa,
                         chunk=32, interpret=True)
    assert (torch.cat([oa, ob], 1) - o_full).abs().max() < TOL
    assert (sb - s_full).abs().max() < TOL


@pytest.mark.parametrize("bh,s,d,chunk", CASES)
def test_oracle_matches_reference_oracle(bh, s, d, chunk):
    arrays = _inputs(2, bh, s, d)
    arrays = (*arrays[:5], np.random.default_rng(3).standard_normal(
        (bh, d, d)).astype(np.float32) * 0.1)
    o, st = wkv_ref(*_torch(arrays))
    o_r, s_r = ref_wkv_ref(*_jax(arrays))
    assert np.abs(_np(o) - _np(o_r)).max() < TOL
    assert np.abs(_np(st) - _np(s_r)).max() < TOL


@pytest.mark.parametrize("dec", STRONG_DECAYS)
def test_strong_decay_stays_finite_where_the_reference_overflows(dec):
    """Fast-decaying channels (trained RWKV-6 has them): the reference's
    k / A_s factorization grows as w^-C across a chunk and leaves the
    recurrence (ROADMAP queue 3); the port's stable form stays within TOL of
    it.  Nothing in ``repro`` changes."""
    arrays = _inputs(4, 2, 128, 16, dec=dec)
    o, st = wkv_chunked(*_torch(arrays), chunk=64, interpret=True)
    o_r, s_r = wkv_ref(*_torch(arrays))
    assert torch.isfinite(o).all() and torch.isfinite(st).all()
    assert (o - o_r).abs().max() < TOL
    assert (st - s_r).abs().max() < TOL
    o_k, _ = ref_wkv_chunked(*_jax(arrays), chunk=64, interpret=True)
    ref_err = np.abs(_np(o_k) - _np(o_r)).max()
    assert not ref_err < TOL        # NaN or far off


def test_gradient_matches_autograd_through_the_recurrence():
    arrays = _inputs(5, 2, 64, 16)
    arrays = (*arrays[:5], np.random.default_rng(6).standard_normal(
        (2, 16, 16)).astype(np.float32) * 0.1)
    g_o = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 64, 16)).astype(np.float32))
    g_s = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 16, 16)).astype(np.float32))
    grads = []
    for fn in (lambda *x: wkv_chunked(*x, chunk=16, interpret=True),
               wkv_ref):
        xs = [t.clone().requires_grad_() for t in _torch(arrays)]
        o, st = fn(*xs)
        ((o * g_o).sum() + (st * g_s).sum()).backward()
        grads.append([t.grad for t in xs])
    # fp32 sums over 64 steps in other orders: 1e-5 of the gradient's scale
    for name, a, b in zip(("r", "k", "v", "w", "u", "state"), *grads):
        assert a is not None and torch.isfinite(a).all(), name
        assert (a - b).abs().max() < 1e-5 * float(b.abs().max()), name


@pytest.mark.parametrize("grad", [False, True])
def test_autograd_node_only_where_a_gradient_is_wanted(grad):
    """The forward skips the autograd node where no input wants a gradient
    (its outputs equal all the same) and keeps it, so gradients flow, where
    one does."""
    x = _torch(_inputs(12, 2, 64, 16))
    want_o, want_s = kernel.wkv_chunked_plain(*x, chunk=16)
    if grad:
        x[4].requires_grad_()
    o, st = wkv_chunked(*x, chunk=16, interpret=True)
    assert torch.equal(o.detach(), want_o) and torch.equal(st.detach(), want_s)
    assert (o.grad_fn is not None) == grad == (st.grad_fn is not None)
    with torch.no_grad():
        assert wkv_chunked(*x, chunk=16, interpret=True)[0].grad_fn is None
    if grad:
        o.sum().backward()
        assert x[4].grad is not None and torch.isfinite(x[4].grad).all()


def test_heads_layout_equals_rows_layout():
    """The model's (B, S, H, D) layout, u (H, D), state (B, H, D, D), gives
    the (BH, S, D) contract's numbers with u tiled over the batch."""
    b, s, h, d = 2, 64, 3, 16
    rng = np.random.default_rng(9)
    r, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, d))
                                .astype(np.float32)) * 0.5 for _ in range(3))
    w = torch.from_numpy(np.exp(-np.exp(rng.standard_normal((b, s, h, d))
                                        * 0.3 - 3.0)).astype(np.float32))
    u = torch.from_numpy(rng.standard_normal((h, d)).astype(np.float32))
    s0 = torch.from_numpy(rng.standard_normal((b, h, d, d))
                          .astype(np.float32)) * 0.1
    o, st = wkv_chunked(r, k, v, w, u, s0, chunk=16, interpret=True)
    assert o.shape == (b, s, h, d) and st.shape == (b, h, d, d)
    rows = kernel.heads_to_rows(r, k, v, w, u, s0)
    o3, st3 = wkv_chunked(*rows, chunk=16, interpret=True)
    o4, st4 = kernel.rows_to_heads(o3, st3, b, h)
    assert torch.equal(o, o4) and torch.equal(st, st4)


def test_kernel_path_needs_cuda_tensors():
    r, k, v, w, u, s0 = _torch(_inputs(10, 2, 64, 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        wkv_chunked(r, k, v, w, u, s0, chunk=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel.launch_wkv(*(t.transpose(0, 1)[None] for t in (r, k, v, w)),
                          u, s0[None], 16)
    meta = [t.to("meta") for t in (r, k, v, w, u, s0)]
    with pytest.raises(ValueError, match="interpret=True runs the plain"):
        wkv_chunked(*meta, chunk=16, interpret=True)


@pytest.mark.parametrize("bad", ["seq", "u", "state", "shape"])
def test_bad_shapes_raise(bad):
    r, k, v, w, u, s0 = _torch(_inputs(11, 2, 64, 16))
    if bad == "seq":
        args, chunk = (r[:, :40], k[:, :40], v[:, :40], w[:, :40], u, s0), 16
    elif bad == "u":
        args, chunk = (r, k, v, w, u[:1], s0), 16
    elif bad == "state":
        args, chunk = (r, k, v, w, u, s0[:, :8]), 16
    else:
        args, chunk = (r, k[:1], v, w, u, s0), 16
    with pytest.raises(ValueError):
        wkv_chunked(*args, chunk=chunk, interpret=True)
    with pytest.raises(ValueError):
        kernel.wkv_chunked_plain(*args, chunk=chunk)


#: (B, S, H, D, chunk): rwkv6-3b's forward and generate's prefill (batch 4),
#: tests/test_kernels_wkv.py's cases as one head each, and a B·H past
#: 65535 (B·H is the chunk kernels' grid.x)
PLAN_CASES = [(1, 4096, 40, 64, 64), (4, 512, 40, 64, 64),
              (1, 128, 2, 16, 32), (1, 256, 1, 32, 64), (1, 64, 4, 64, 16),
              (2048, 64, 40, 16, 64)]


def _heads_inputs(b, s, h, d, dtype=torch.float32, device="meta"):
    def t(*shape, dt=torch.float32):
        return torch.empty(shape, dtype=dt, device=device)

    return (t(b, s, h, d, dt=dtype), t(b, s, h, d, dt=dtype),
            t(b, s, h, d, dt=dtype), t(b, s, h, d), t(h, d), t(b, h, d, d))


@pytest.mark.parametrize("b,s,h,d,chunk", PLAN_CASES)
def test_launch_plan_workspace(b, s, h, d, chunk):
    """The workspace holds a (D, D) fp32 state per (b·h, chunk) -- 2,560 of
    them, 42 MB, at rwkv6-3b's forward -- and a_end a D-vector of decays
    per (b·h, chunk)."""
    plan = kernel.launch_plan(*_heads_inputs(b, s, h, d), chunk)
    nc = s // chunk
    assert plan["workspace"] == (b * h, nc, d, d)
    assert plan["a_end"] == (b * h, nc, d)
    assert plan["out_dtype"] == torch.float32
    if (b, s, h) == (1, 4096, 40):
        assert nc * b * h == 2560
        assert math.prod(plan["workspace"]) * 4 == 41_943_040


@pytest.mark.parametrize("in_dtype,out_dtype,want", [
    (torch.float32, None, torch.float32),
    (torch.float32, torch.float32, torch.float32),
    (torch.bfloat16, None, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32, torch.float32),   # the model's call
])
def test_launch_plan_out_dtypes(in_dtype, out_dtype, want):
    plan = kernel.launch_plan(*_heads_inputs(1, 64, 2, 16, in_dtype), 16,
                              out_dtype)
    assert plan["out_dtype"] == want


@pytest.mark.parametrize("bad", ["out_fp32_to_bf16", "out_fp16", "in_fp16",
                                 "k_dtype", "chunk", "head_dim", "rows",
                                 "chunks"])
def test_launch_plan_refuses(bad):
    b, s, h, d, chunk, dt, out = 1, 64, 2, 16, 16, torch.float32, None
    if bad == "out_fp32_to_bf16":
        out = torch.bfloat16
    elif bad == "out_fp16":
        dt, out = torch.bfloat16, torch.float16
    elif bad == "in_fp16":
        dt = torch.float16
    elif bad == "chunk":
        chunk = 128
    elif bad == "head_dim":
        d = 128
    elif bad == "chunks":     # S / chunk is the chunk kernels' grid.y
        s = chunk * (kernel.MAX_CHUNKS + 1)
    x = list(_heads_inputs(b, s, h, d, dt))
    if bad == "k_dtype":
        x[1] = x[1].to(torch.bfloat16)
    if bad == "rows":
        x = kernel.heads_to_rows(*x)
    with pytest.raises(ValueError):
        kernel.launch_plan(*x, chunk, out)
