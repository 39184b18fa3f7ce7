"""The tri_attn kernel's sm90 route (repro_torch.kernels.tri_attn), on the
CPU: its plain version ``attention_stream_plain`` against the JAX package's
interpret-mode ``causal_attention`` and its oracle ``causal_attention_ref``
(both grid modes, GQA, several cells per CTA), the work enumeration and the
piece bookkeeping that the CUDA kernel and its combine launch follow, the
route choice, and the route raising where there is no card.  Inputs are
made by numpy from a seed."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.tri_attn.ops import causal_attention as ref_causal_attention
from repro.kernels.tri_attn.ref import (
    causal_attention_ref as ref_causal_attention_ref,
)
from repro_torch.kernels.tri_attn import kernel
from repro_torch.kernels.tri_attn.ops import causal_attention

#: fp32: the reference kernel's own tolerance.  bf16: the sm90 route rounds
#: P to bf16 before P·V (the tensor cores' input), where the reference keeps
#: fp32, and o is rounded to bf16 once in each
TOL = {"float32": 3e-5, "bfloat16": 3e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
#: (B, H, Hk, S, D, block) and cells per CTA U: one U that splits rows
#: across three or more CTAs, U = 1, and a U above one (b, h)'s T(nb) steps
CASES = {
    "nb8": ((1, 2, 2, 128, 32, 16), (1, 2, 73)),
    "gqa": ((2, 4, 2, 64, 16, 16), (1, 3, 21)),
    "sm90_shape": ((1, 2, 1, 256, 64, 128), (1, 2, 7)),
}
MODES = ("mapped", "bounding_box")


def _inputs(seed, b, h, hk, s, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, s, d), (b, hk, s, d), (b, hk, s, d))]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _reference(case, dtype, mode):
    """The inputs and the reference's interpret-mode kernel and oracle."""
    (b, h, hk, s, d, blk), _ = CASES[case]
    arrays = _inputs(7, b, h, hk, s, d)
    jdt, tdt = DTYPES[dtype]
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in arrays)
    kern = ref_causal_attention(jq, jk, jv, blk, blk, mode, True)
    g = h // hk
    oracle = ref_causal_attention_ref(jq, jnp.repeat(jk, g, axis=1),
                                      jnp.repeat(jv, g, axis=1))
    return ([torch.from_numpy(a).to(tdt) for a in arrays], _np(kern),
            _np(oracle))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("u_index", [0, 1, 2])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode", MODES)
def test_stream_plain_matches_reference(case, u_index, dtype, mode):
    (b, h, hk, s, d, blk), us = CASES[case]
    (q, k, v), want_kernel, want_oracle = _reference(case, dtype, mode)
    got = kernel.attention_stream_plain(q, k, v, blk, us[u_index], mode)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert np.abs(_np(got) - want_kernel).max() < TOL[dtype]
    assert np.abs(_np(got) - want_oracle).max() < TOL[dtype]


@pytest.mark.parametrize("case", sorted(CASES))
def test_u_values_cut_rows_as_intended(case):
    """The first U cuts some row across three or more CTAs, the last takes
    more than one (b, h) in a CTA, and that one cuts no row at nb <= 2."""
    (b, h, hk, s, d, blk), us = CASES[case]
    nb = s // blk
    for mode in MODES:
        pieces = kernel.stream_pieces(b * h, nb, us[0], mode)
        if nb > 2:
            assert max(len(p[2]) for p in pieces) >= 3
        assert us[2] > kernel.tri_grid_size(nb)


def _segments(n_bh, nb, u, mode):
    """Each CTA's row segments from ``stream_grid``: (cta, bh, i, j0, j1)."""
    bh, i, j, valid = kernel.stream_grid(n_bh, nb, u, mode)
    segs = []
    for c in range(valid.shape[0]):
        cur = None
        for t in range(valid.shape[1]):
            if not valid[c, t]:
                continue
            key = (int(bh[c, t]), int(i[c, t]))
            if cur is not None and tuple(cur[1:3]) == key:
                cur[4] = int(j[c, t])
            else:
                if cur is not None:
                    segs.append(tuple(cur))
                cur = [c, *key, int(j[c, t]), int(j[c, t])]
        if cur is not None:
            segs.append(tuple(cur))
    return segs


GRIDS = [(1, 1, 1), (1, 3, 1), (2, 4, 3), (3, 5, 4), (4, 8, 7), (2, 6, 50),
         (5, 7, 13), (1, 16, 9)]


@pytest.mark.parametrize("n_bh,nb,u", GRIDS)
@pytest.mark.parametrize("mode", MODES)
def test_enumeration_covers_every_step_once(n_bh, nb, u, mode):
    bh, i, j, valid = kernel.stream_grid(n_bh, nb, u, mode)
    assert valid.shape == (kernel.stream_ctas(n_bh, nb, u, mode), u)
    cells = list(zip(bh[valid].tolist(), i[valid].tolist(),
                     j[valid].tolist()))
    want = [(x, r, c) for x in range(n_bh) for r in range(nb)
            for c in range(r + 1)]
    assert sorted(cells) == want            # every valid step exactly once
    assert cells == want                    # and in the kernel's order
    if mode == "bounding_box":              # the box, j > i discarded
        assert valid.numel() >= n_bh * nb * nb
        assert int((~valid).sum()) == valid.numel() - len(want)


@pytest.mark.parametrize("n_bh,nb,u", GRIDS)
@pytest.mark.parametrize("mode", MODES)
def test_pieces_at_most_two_per_cta_and_as_the_combine_finds_them(
        n_bh, nb, u, mode):
    """A segment that is not a whole row is a piece: slot 0 if it starts at
    j > 0, else slot 1; at most one of each per CTA.  ``stream_pieces``
    (the combine launch's rule) lists every cut row once, with exactly the
    CTAs and slots that hold its pieces, in ascending j."""
    segs = _segments(n_bh, nb, u, mode)
    held = {}
    for c, b, r, j0, j1 in segs:
        if j0 == 0 and j1 == r:
            continue
        slot = 0 if j0 > 0 else 1
        assert (c, slot) not in held
        held[(c, slot)] = (b, r, j0, j1)
    for c in {c for c, _ in held}:
        assert sum((c, x) in held for x in (0, 1)) <= 2
    listed = kernel.stream_pieces(n_bh, nb, u, mode)
    assert len({(b, r) for b, r, _ in listed}) == len(listed)
    covered = set()
    for b, r, pieces in listed:
        assert len(pieces) >= 2
        spans = [held[p] for p in pieces]
        assert all(x[:2] == (b, r) for x in spans)
        assert spans[0][2] == 0 and spans[-1][3] == r
        for a, z in zip(spans, spans[1:]):
            assert z[2] == a[3] + 1             # contiguous, ascending j
        covered.update(pieces)
    assert covered == set(held)


@pytest.mark.parametrize("mode,ctas", [("mapped", 132), ("bounding_box", 256)])
def test_lm_shape_grid(mode, ctas):
    """(1, 32 heads, 4096, 128) on 132 SMs: U = 128 cells, one wave of 132
    CTAs mapped, 256 over the box."""
    n_bh, nb = 32, 4096 // 128
    u = kernel.default_steps_per_cta(n_bh, nb, kernel.H100_SMS)
    assert u == 128
    assert kernel.stream_cells(n_bh, nb, "mapped") == 16_896
    assert kernel.stream_ctas(n_bh, nb, u, mode) == ctas
    pieces = kernel.stream_pieces(n_bh, nb, u, mode)
    # a row of at most 32 steps spans at most two CTAs of 128 cells; the
    # box's CTAs start at every fourth box row, so BB cuts no row there
    assert all(len(p) == 2 for _, _, p in pieces)
    assert bool(pieces) == (mode == "mapped")


@pytest.mark.parametrize("dtype,block,d,route", [
    (torch.bfloat16, 128, 128, "sm90"), (torch.bfloat16, 128, 64, "sm90"),
    (torch.bfloat16, 128, 32, "simt"), (torch.bfloat16, 128, 16, "simt"),
    (torch.bfloat16, 64, 128, "simt"), (torch.bfloat16, 64, 64, "simt"),
    (torch.bfloat16, 32, 128, "simt"), (torch.bfloat16, 16, 64, "simt"),
    (torch.float32, 128, 128, "simt"), (torch.float32, 128, 64, "simt"),
    (torch.float32, 64, 64, "simt"),
])
def test_route_choice(dtype, block, d, route):
    assert kernel.attention_route(dtype, block, d) == route


def test_interpret_runs_the_plain_version_of_the_route():
    """interpret=True runs ``attention_stream_plain`` with an H100's grid at
    an sm90 shape and ``attention_pairs_plain`` at a simt shape."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(3, 1, 4, 2, 512, 64))
    u = kernel.default_steps_per_cta(4, 4, kernel.H100_SMS)
    for mode in MODES:
        got = causal_attention(q, k, v, 128, 128, mode, True)
        want = kernel.attention_stream_plain(q, k, v, 128, u, mode)
        assert torch.equal(got, want)
    got = causal_attention(q, k, v, 64, 64, "mapped", True)
    assert torch.equal(got, kernel.attention_pairs_plain(q, k, v, 64))


@pytest.mark.parametrize("mode", MODES)
def test_sm90_shape_matches_reference_kernel(mode):
    """The port's entry point at the LM path's case (bf16, block 128,
    head_dim 128, GQA) against the reference's interpret-mode kernel."""
    qa, ka, va = _inputs(4, 1, 4, 2, 384, 128)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (qa, ka, va))
    want = ref_causal_attention(jq, jk, jv, 128, 128, mode, True)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in (qa, ka, va))
    got = causal_attention(q, k, v, 128, 128, mode, True)
    assert np.abs(_np(got) - _np(want)).max() < TOL["bfloat16"]


def test_sm90_route_raises_on_cpu_tensors_and_without_a_card(monkeypatch):
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(5, 1, 2, 1, 256, 64))
    assert kernel.attention_route(q.dtype, 128, 64) == "sm90"
    n0 = kernel.ATTN_LAUNCHES, kernel.ATTN_SM90_LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        causal_attention(q, k, v, 128, 128, "mapped", False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.launch_attention(q, k, v, 128, "bounding_box")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel.launch_attention(q, k, v, 128, "mapped")
    assert (kernel.ATTN_LAUNCHES, kernel.ATTN_SM90_LAUNCHES) == n0


def test_sm90_launch_refuses_fewer_than_one_cell_per_cta():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(6, 1, 1, 1, 256, 64))
    n0 = kernel.ATTN_LAUNCHES, kernel.ATTN_SM90_LAUNCHES
    with pytest.raises(ValueError, match="steps_per_cta 0"):
        kernel._launch_sm90(q, k, v, "mapped", 0)
    assert (kernel.ATTN_LAUNCHES, kernel.ATTN_SM90_LAUNCHES) == n0


def test_reset_launch_counts_clears_both(monkeypatch):
    monkeypatch.setattr(kernel, "ATTN_LAUNCHES", 5)
    monkeypatch.setattr(kernel, "ATTN_SM90_LAUNCHES", 3)
    kernel.reset_launch_counts()
    assert kernel.ATTN_LAUNCHES == 0 and kernel.ATTN_SM90_LAUNCHES == 0


@pytest.mark.parametrize("grad", [False, True])
def test_autograd_node_only_where_a_gradient_is_wanted(grad):
    """The forward skips the autograd node where no input wants a gradient
    (its output equal all the same) and keeps it, so gradients flow, where
    one does."""
    qa, ka, va = _inputs(8, 1, 2, 1, 256, 64)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in (qa, ka, va))
    want = kernel.attention_plain(q, k, v, 128, "mapped")
    if grad:
        q.requires_grad_()
    got = causal_attention(q, k, v, 128, 128, "mapped", True)
    assert torch.equal(got.detach(), want)
    assert (got.grad_fn is not None) == grad
    with torch.no_grad():
        assert causal_attention(q, k, v, 128, 128, "mapped",
                                True).grad_fn is None
    if grad:
        got.float().sum().backward()
        assert q.grad is not None and torch.isfinite(q.grad.float()).all()
