"""The plain versions of the port's three WKV kernels (chunk states, state
scan, chunk outputs; repro_torch.kernels.wkv.kernel), each alone, on the
CPU: each phase against the recurrence run over one chunk, the scan's
rounding (one rounding a step, as the kernel's fmaf) and a state chained
over two scans.  Their composition, ``wkv_chunked_plain``, is held against
the JAX package's kernel and oracle in tests/test_torch_wkv.py.  Inputs are
made by numpy from a seed."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.wkv import kernel
from repro_torch.kernels.wkv.ref import wkv_ref

TOL = 1e-4


def _inputs(seed, bh, s, d, state_scale=0.0):
    """tests/test_kernels_wkv.py's distributions: r, k, v ~ N(0, 0.25),
    w = exp(-exp(N(0, 0.09) - 5)), u ~ N(0, 0.25); the state zero or
    N(0, state_scale^2).  As torch tensors, fp32."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((bh, s, d)).astype(np.float32) * 0.5
               for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((bh, s, d)) * 0.3 - 5.0))
    u = rng.standard_normal((bh, d)).astype(np.float32) * 0.5
    s0 = (rng.standard_normal((bh, d, d)) * state_scale).astype(np.float32)
    return tuple(torch.from_numpy(a)
                 for a in (r, k, v, w.astype(np.float32), u, s0))


@pytest.mark.parametrize("chunk", [16, 64])
def test_states_phase_is_the_recurrence_over_one_chunk(chunk):
    """ΔS_c is the state the recurrence reaches over chunk c from zero, and
    A_c the product of the chunk's decays."""
    r, k, v, w, u, _ = _inputs(5, 3, 128, 32)
    ws, a_end = kernel.wkv_chunk_states_plain(k, v, w, chunk)
    nc = 128 // chunk
    assert ws.shape == (3, nc, 32, 32) and a_end.shape == (3, nc, 32)
    zero = torch.zeros((3, 32, 32))
    for c in range(nc):
        rows = slice(c * chunk, (c + 1) * chunk)
        _, s_c = wkv_ref(r[:, rows], k[:, rows], v[:, rows], w[:, rows], u,
                         zero)
        assert (ws[:, c] - s_c).abs().max() < TOL
        assert (a_end[:, c] - w[:, rows].prod(1)).abs().max() < 1e-6


def test_outputs_phase_is_the_recurrence_from_each_chunks_state():
    """Given each chunk's S_in from the recurrence, the outputs phase gives
    the recurrence's o."""
    x = _inputs(6, 2, 128, 16, state_scale=0.1)
    r, k, v, w, u, s0 = x
    chunk = 32
    o_r, _ = wkv_ref(*x)
    s_in, S = [], s0
    for c in range(128 // chunk):
        s_in.append(S)
        rows = slice(c * chunk, (c + 1) * chunk)
        _, S = wkv_ref(r[:, rows], k[:, rows], v[:, rows], w[:, rows], u, S)
    o = kernel.wkv_chunk_outputs_plain(r, k, v, w, u, torch.stack(s_in, 1),
                                       chunk)
    assert (o - o_r).abs().max() < TOL


def test_scan_rounds_each_step_once():
    """S <- A_c ⊙ S + ΔS_c in chunk order, each step rounded to fp32 once
    (the kernel's fmaf), S_in of chunk c the state before it."""
    rng = np.random.default_rng(7)
    bh, nc, d = 3, 9, 8
    ws = rng.standard_normal((bh, nc, d, d)).astype(np.float32)
    a_end = rng.random((bh, nc, d)).astype(np.float32)
    s0 = rng.standard_normal((bh, d, d)).astype(np.float32)
    s_in, s_out = kernel.wkv_state_scan_plain(
        *(torch.from_numpy(a) for a in (ws, a_end, s0)))
    S = s0
    for c in range(nc):
        np.testing.assert_array_equal(s_in[:, c].numpy(), S)
        # an fp32 product is exact in float64: one rounding, to fp32
        S = (a_end[:, c, :, None].astype(np.float64) * S.astype(np.float64)
             + ws[:, c].astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(s_out.numpy(), S)
    # two roundings (the product, then the sum) differ somewhere
    two = s0
    for c in range(nc):
        two = a_end[:, c, :, None] * two + ws[:, c]
    assert not np.array_equal(two, S)


def test_scan_chained_over_two_calls_equals_one():
    """A state carried from one scan into the next gives one scan's
    result (to 1e-6 here; bit for bit on the card, where the per-chunk
    arithmetic is fixed, chip_smoke.py)."""
    r, k, v, w, u, s0 = _inputs(8, 2, 256, 16, state_scale=0.1)
    ws, a_end = kernel.wkv_chunk_states_plain(k, v, w, 32)
    s_in, s_out = kernel.wkv_state_scan_plain(ws, a_end, s0)
    in_a, s_a = kernel.wkv_state_scan_plain(ws[:, :3], a_end[:, :3], s0)
    in_b, s_b = kernel.wkv_state_scan_plain(ws[:, 3:], a_end[:, 3:], s_a)
    assert (torch.cat([in_a, in_b], 1) - s_in).abs().max() < 1e-6
    assert (s_b - s_out).abs().max() < 1e-6
