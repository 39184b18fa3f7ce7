"""The port's tri_attn attention (repro_torch.kernels.tri_attn) against the
JAX package's, on the CPU: every case of tests/test_kernels_tri_attn.py in
both grid modes, GQA, gradients, the exact λ → (i, j) map, the waste
accounting, and the kernel path raising where there is no card.  Both
packages run with ``interpret=True``: the reference's Pallas kernel in
interpret mode, the port's plain version of its CUDA kernel (the same
pair-and-combine arithmetic).  Inputs are made by numpy from a seed."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.tri_attn.kernel import lam_to_ij as ref_lam_to_ij
from repro.kernels.tri_attn.ops import (
    causal_attention as ref_causal_attention, grid_steps as ref_grid_steps,
)
from repro.kernels.tri_attn.ref import (
    causal_attention_ref as ref_causal_attention_ref,
)
from repro_torch.kernels.tri_attn import kernel
from repro_torch.kernels.tri_attn.ops import causal_attention, grid_steps
from repro_torch.kernels.tri_attn.ref import causal_attention_ref

CASES = [
    # (batch, heads, seq, head_dim, block) — tests/test_kernels_tri_attn.py
    (1, 1, 128, 64, 32),
    (1, 2, 256, 64, 64),
    (2, 1, 128, 128, 32),
    (1, 1, 256, 32, 128),
    (2, 2, 64, 16, 16),
]
DTYPES = {"float32": (jnp.float32, torch.float32, 3e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
#: every λ of a pair grid up to nb = 65535, past the reference's nb <= 4096
NB_MAX = 65535


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(arrays, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("b,h,s,d,blk", CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode", ["mapped", "bounding_box"])
def test_matches_reference_kernel(b, h, s, d, blk, dtype, mode):
    (jq, jk, jv), (q, k, v) = _both(_inputs(0, *[(b, h, s, d)] * 3), dtype)
    want = ref_causal_attention(jq, jk, jv, blk, blk, mode, True)
    got = causal_attention(q, k, v, blk, blk, mode, True)
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = DTYPES[dtype][2]
    assert np.abs(_np(got) - _np(want)).max() < tol
    oracle = causal_attention_ref(q, k, v)
    assert np.abs(_np(got) - _np(oracle)).max() < tol


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_oracle_matches_reference_oracle(dtype):
    (jq, jk, jv), (q, k, v) = _both(_inputs(1, *[(2, 2, 96, 32)] * 3), dtype)
    want = ref_causal_attention_ref(jq, jk, jv)
    got = causal_attention_ref(q, k, v)
    assert got.dtype == q.dtype
    assert np.abs(_np(got) - _np(want)).max() < DTYPES[dtype][2]


@pytest.mark.parametrize("mode", ["mapped", "bounding_box"])
def test_gqa_reads_kv_heads_in_place(mode):
    """kv head h // (H/Hk) serves q head h, with no repeat — as the
    reference's repeat path gives."""
    qa, ka, va = _inputs(2, (1, 4, 128, 32), (1, 2, 128, 32), (1, 2, 128, 32))
    want = ref_causal_attention(jnp.asarray(qa), jnp.asarray(ka),
                                jnp.asarray(va), 32, 32, mode, True)
    got = causal_attention(torch.from_numpy(qa), torch.from_numpy(ka),
                           torch.from_numpy(va), 32, 32, mode, True)
    assert np.abs(_np(got) - _np(want)).max() < 3e-5


def test_gradients_match_reference():
    """q, k and v gradients through the autograd.Function equal jax.grad of
    the reference's custom_vjp, to 1e-5."""
    qa, ka, va, wa = _inputs(3, *[(1, 1, 64, 32)] * 4)

    def loss(q, k, v):
        return (ref_causal_attention(q, k, v, 32, 32, "mapped", True)
                * jnp.asarray(wa)).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(qa), jnp.asarray(ka), jnp.asarray(va))
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (qa, ka, va))
    (causal_attention(q, k, v, 32, 32, "mapped", True)
     * torch.from_numpy(wa)).sum().backward()
    for got, ref in zip((q.grad, k.grad, v.grad), want):
        assert np.abs(_np(got) - _np(ref)).max() < 1e-5


def test_gqa_gradients_sum_over_the_group():
    qa, ka, va = _inputs(4, (1, 4, 64, 16), (1, 2, 64, 16), (1, 2, 64, 16))
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (qa, ka, va))
    causal_attention(q, k, v, 16, 16, "bounding_box", True).square().sum() \
        .backward()
    q2, k2, v2 = (torch.from_numpy(a).requires_grad_() for a in (qa, ka, va))
    causal_attention_ref(q2, k2.repeat_interleave(2, 1),
                         v2.repeat_interleave(2, 1)).square().sum().backward()
    for got, ref in ((q.grad, q2.grad), (k.grad, k2.grad), (v.grad, v2.grad)):
        assert (got - ref).abs().max() < 1e-5


def test_mapped_grid_is_exact_triangular():
    """The λ-grid enumerates exactly the lower-triangular block pairs in
    order, as the reference's does."""
    nb = 7
    lams = torch.arange(kernel.tri_grid_size(nb))
    i, j = kernel.lam_to_ij(lams)
    seen = list(zip(i.tolist(), j.tolist()))
    expect = [(a, b) for a in range(nb) for b in range(a + 1)]
    assert seen == expect
    ri, rj = jax.vmap(ref_lam_to_ij)(jnp.arange(kernel.tri_grid_size(nb)))
    assert seen == list(zip(ri.tolist(), rj.tolist()))


def test_lam_to_ij_exact_up_to_nb_65535():
    """Every λ < T(65535) maps to (i, j) = (row, λ - T(row)), the rows laid
    out by numpy with no square root, in chunks of 2^23 λ."""
    starts = np.arange(NB_MAX + 1, dtype=np.int64)
    starts = starts * (starts + 1) // 2              # T(row)
    total = int(starts[-1])
    chunk = 1 << 23
    for a in range(0, total, chunk):
        b = min(a + chunk, total)
        ia = int(np.searchsorted(starts, a, "right")) - 1
        ib = int(np.searchsorted(starts, b - 1, "right")) - 1
        rows = np.arange(ia, ib + 1, dtype=np.int64)
        lens = np.minimum(starts[rows + 1], b) - np.maximum(starts[rows], a)
        want_i = np.repeat(rows, lens)
        want_j = np.arange(a, b, dtype=np.int64) - np.repeat(starts[rows],
                                                             lens)
        i, j = kernel.lam_to_ij(torch.arange(a, b, dtype=torch.int64))
        assert torch.equal(i, torch.from_numpy(want_i)), a
        assert torch.equal(j, torch.from_numpy(want_j)), a
    assert b == kernel.tri_grid_size(NB_MAX)
    assert want_i[-1] == want_j[-1] == NB_MAX - 1


@pytest.mark.parametrize("s,blk", [(4096, 128), (2048, 64), (64, 16),
                                   (128, 128)])
@pytest.mark.parametrize("mode", ["mapped", "bounding_box"])
def test_grid_steps_match_reference(s, blk, mode):
    assert grid_steps(s, blk, mode) == ref_grid_steps(s, blk, mode)


def test_waste_accounting():
    """BB launches nb² pair blocks, mapped T(nb) (paper Fig. 1)."""
    s, blk = 4096, 128
    nb = s // blk
    assert grid_steps(s, blk, "bounding_box") == nb * nb
    assert grid_steps(s, blk, "mapped") == nb * (nb + 1) // 2
    waste = 1 - grid_steps(s, blk, "mapped") / grid_steps(s, blk,
                                                          "bounding_box")
    assert waste == pytest.approx(0.5 - 0.5 / nb)


def test_kernel_path_raises_on_cpu_tensors(monkeypatch):
    q, k, v = (torch.from_numpy(a) for a in _inputs(5, *[(1, 1, 64, 16)] * 3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        causal_attention(q, k, v, 16, 16, "mapped", False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel.launch_attention(q, k, v, 16, "mapped")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel.lam_to_ig_device(0, 16)
    assert kernel.ATTN_LAUNCHES == 0


@pytest.mark.parametrize("bad", [
    dict(block_k=32), dict(grid_mode="diagonal"), dict(block_q=48,
                                                       block_k=48)])
def test_bad_arguments_raise(bad):
    q, k, v = (torch.from_numpy(a) for a in _inputs(6, *[(1, 1, 64, 16)] * 3))
    args = dict(block_q=16, block_k=16, grid_mode="mapped", interpret=True)
    with pytest.raises(ValueError):
        causal_attention(q, k, v, **{**args, **bad})


# ---------------------------------------------------------------------------
# the simt route's strips: cells (i, g) of G key blocks on the staircase map
# ---------------------------------------------------------------------------

STRIPS = (1, 2, 3, 4, 8)


@pytest.mark.parametrize("strip", STRIPS)
def test_staircase_map_exact_against_enumeration(strip):
    """For every nb <= 200, λ -> (i, g) enumerates exactly the cells
    (i, g <= i // G) in row order, ``ig_to_lam`` inverts it, and the count
    is C(nb, G) = G·T(Q) + r·(Q+1)."""
    i_all, g_all = kernel.lam_to_ig(
        torch.arange(kernel.strip_cells(200, strip)), strip)
    for nb in range(strip, 201):
        want = [(i, g) for i in range(nb) for g in range(i // strip + 1)]
        n = kernel.strip_cells(nb, strip)
        q, r = divmod(nb, strip)
        assert n == len(want) == strip * q * (q + 1) // 2 + r * (q + 1)
        assert list(zip(i_all[:n].tolist(), g_all[:n].tolist())) == want
    lam = kernel.ig_to_lam(i_all, g_all, strip)
    assert torch.equal(lam, torch.arange(lam.numel()))


@pytest.mark.parametrize("strip", STRIPS)
def test_staircase_map_exact_in_int64_up_to_nb_65535(strip):
    """Spot λ near every tenth of C(65535, G), at the last cell and past
    2^31 (the map is int64 whatever the grid holds): each (i, g) is a cell
    of the staircase and maps back to its λ."""
    total = kernel.strip_cells(NB_MAX, strip)
    starts = [total * k // 10 for k in range(10)] + [total - 512,
                                                     (1 << 31) - 256,
                                                     (1 << 33) + 7]
    lam = torch.cat([torch.arange(a, a + 512) for a in starts])
    i, g = kernel.lam_to_ig(lam, strip)
    assert bool(((g >= 0) & (g <= i // strip)).all())
    assert torch.equal(kernel.ig_to_lam(i, g, strip), lam)
    last_i, last_g = kernel.lam_to_ig(torch.tensor([total - 1]), strip)
    assert (int(last_i), int(last_g)) == (NB_MAX - 1, (NB_MAX - 1) // strip)
    # the map agrees with the triangular map of λ // G for the row group
    q, _ = kernel.lam_to_ij(lam // strip)
    assert torch.equal(i // strip, q)


@pytest.mark.parametrize("nb,strip,mapped,bb", [
    (32, 8, 80, 128), (64, 8, 288, 512), (32, 1, 528, 1024),
    (7, 3, 12, 21), (1, 1, 1, 1), (10, 10, 10, 10),
    (65535, 8, 268_460_032, 536_862_720)])
def test_cell_counts(nb, strip, mapped, bb):
    """The mapped launch's C(nb, G) blocks and the BB launch's
    nb·ceil(nb/G), a (b, h)."""
    assert kernel.strip_cells(nb, strip) == mapped
    assert nb * -(-nb // strip) == bb
    assert sum(i // strip + 1 for i in range(nb)) == mapped


@functools.lru_cache(maxsize=None)
def _reference_out(case, dtype, mode):
    (jq, jk, jv), _ = _both(_inputs(7, *[case[:4]] * 3), dtype)
    return _np(ref_causal_attention(jq, jk, jv, case[4], case[4], mode,
                                    True))


@pytest.mark.parametrize("b,h,s,d,blk", CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("strip,mode", [("1", "mapped"),
                                        ("2", "bounding_box"),
                                        ("nb", "mapped")])
def test_strip_plain_matches_reference_kernel(b, h, s, d, blk, dtype,
                                              strip, mode):
    """The simt route's plain version at G = 1, 2 and nb against the
    reference's interpret-mode kernel (its output in each grid mode is
    computed once for the file)."""
    _, (q, k, v) = _both(_inputs(7, *[(b, h, s, d)] * 3), dtype)
    nb = s // blk
    g = nb if strip == "nb" else min(int(strip), nb)
    got = kernel.attention_pairs_plain(q, k, v, blk, g)
    assert got.dtype == q.dtype and got.shape == q.shape
    want = _reference_out((b, h, s, d, blk), dtype, mode)
    assert np.abs(_np(got) - want).max() < DTYPES[dtype][2]


def test_strip_plain_gqa_and_default():
    """GQA read in place at G = 3 (a short last strip), and the default G
    being the H100 chooser's."""
    qa, ka, va = _inputs(8, (1, 4, 448, 16), (1, 2, 448, 16),
                         (1, 2, 448, 16))
    q, k, v = (torch.from_numpy(a) for a in (qa, ka, va))
    want = causal_attention_ref(q, k.repeat_interleave(2, 1),
                                v.repeat_interleave(2, 1))
    got = kernel.attention_pairs_plain(q, k, v, 32, 3)
    assert (got - want).abs().max() < 3e-5
    g = kernel.default_strip(4, 14, kernel.H100_SMS)
    assert torch.equal(kernel.attention_pairs_plain(q, k, v, 32),
                       kernel.attention_pairs_plain(q, k, v, 32, g))
    with pytest.raises(ValueError):
        kernel.attention_pairs_plain(q, k, v, 32, 15)


@pytest.mark.parametrize("n_bh,nb,n_sm,want", [
    (32, 32, 132, 8), (32, 64, 132, 16), (1, 4, 132, 1), (48, 1, 132, 1),
    (4, 8, 132, 1), (128, 16, 132, 8), (8, 32, 132, 2), (16, 32, 132, 4),
    (32, 32, 264, 4), (1024, 4, 132, 4)])
def test_default_strip(n_bh, nb, n_sm, want):
    """G: the largest power of two up to min(16, nb) leaving 16·G block
    pairs an SM; at yi-6b's heads at S 4096, 8 at block 128 and 16 at 64."""
    g = kernel.default_strip(n_bh, nb, n_sm)
    assert g == want
    assert g == 1 or n_bh * kernel.tri_grid_size(nb) >= (
        kernel.STRIP_FILL * g * n_sm)


@pytest.mark.parametrize("bh,s,d,blk,strip,want", [
    (32, 4096, 128, 128, 8, 32), (32, 4096, 128, 64, 8, 32),
    (32, 4096, 128, 64, 1, 31), (32, 4096, 128, 128, 1, 32),
    (100000, 128, 8, 16, 2, 65535), (1, 65536, 128, 16, 1, 1)])
def test_bh_group_workspace(bh, s, d, blk, strip, want):
    """(b, h) a strip launch: C(nb, G)·block·(D+2) fp32 each under the
    2 GiB cap — yi-6b's heads fit one launch at G = 8, and at block 64 the
    pair grid (G = 1) needed two."""
    group = kernel.bh_group(bh, s, d, blk, strip)
    assert group == want
    per_bh = kernel.strip_cells(s // blk, strip) * blk * (d + 2) * 4
    assert group == 1 or group * per_bh <= kernel.WORKSPACE_CAP_BYTES


def test_plain_follows_the_strips_arithmetic():
    """The plain version carries the online softmax along a strip: at
    G = nb each row is one strip, at G = 1 each pair is; both agree with
    the oracle in fp32, to rounding."""
    qa, ka, va = _inputs(9, *[(2, 2, 256, 32)] * 3)
    q, k, v = (torch.from_numpy(a) for a in (qa, ka, va))
    want = causal_attention_ref(q, k, v)
    one = kernel.attention_pairs_plain(q, k, v, 32, 1)
    whole = kernel.attention_pairs_plain(q, k, v, 32, 8)
    assert (one - want).abs().max() < 3e-6
    assert (whole - want).abs().max() < 3e-6
    assert (one - whole).abs().max() < 3e-6
