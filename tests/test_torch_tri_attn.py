"""The port's tri_attn attention (repro_torch.kernels.tri_attn) against the
JAX package's, on the CPU: every case of tests/test_kernels_tri_attn.py in
both grid modes, GQA, gradients, the exact λ → (i, j) map, the waste
accounting, and the kernel path raising where there is no card.  Both
packages run with ``interpret=True``: the reference's Pallas kernel in
interpret mode, the port's plain version of its CUDA kernel (the same
pair-and-combine arithmetic).  Inputs are made by numpy from a seed."""
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
        kernel.lam_to_ij_device(0, 16)
    assert kernel.ATTN_LAUNCHES == 0


@pytest.mark.parametrize("bad", [
    dict(block_k=32), dict(grid_mode="diagonal"), dict(block_q=48,
                                                       block_k=48)])
def test_bad_arguments_raise(bad):
    q, k, v = (torch.from_numpy(a) for a in _inputs(6, *[(1, 1, 64, 16)] * 3))
    args = dict(block_q=16, block_k=16, grid_mode="mapped", interpret=True)
    with pytest.raises(ValueError):
        causal_attention(q, k, v, **{**args, **bad})
