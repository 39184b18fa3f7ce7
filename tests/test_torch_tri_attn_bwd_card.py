"""The sm90 route's backward kernel (``csrc/tri_attn_bwd.cu``) on the card:
against its plain version ``attention_stream_backward_plain`` and the
oracle's vjp at yi-6b's training shape and at a head_dim 64 shape, in both
grid modes; bitwise repeatable; the forward's row log-sum-exp; the launch
counters.  Marked ``card`` and skipped where there is no CUDA device
(``python -m pytest -q -m card tests/test_torch_tri_attn_bwd_card.py`` on
the card).  No JAX here: the comparisons are with the port's plain
versions."""
import pytest
import torch

from repro_torch.kernels.tri_attn import kernel
from repro_torch.kernels.tri_attn.ops import causal_attention
from repro_torch.kernels.tri_attn.ref import causal_attention_ref

pytestmark = [pytest.mark.card,
              pytest.mark.skipif(not torch.cuda.is_available(),
                                 reason="needs an NVIDIA GPU (CUDA); this "
                                 "machine has none")]

#: (B, H, Hk, S, D): yi-6b's training call, a D 64 GQA case with B 2, and
#: an MHA case (one q head a column)
SHAPES = {"yi6b": (1, 32, 4, 4096, 128), "d64": (2, 8, 2, 1024, 64),
          "mha": (1, 16, 16, 2048, 128)}
MODES = ("mapped", "bounding_box")
#: kernel against the plain version, max |diff| over the tensor's max |value|:
#: both round P and dS to bf16 before their products and the result once;
#: fp32 sums in another order flip a rounding here and there (one bf16 ulp
#: of an element is 2^-8 of it)
PLAIN_RTOL = 1e-2
#: against the oracle's fp32 vjp on the same bf16 inputs (P and dS kept in
#: fp32 there)
ORACLE_RTOL = 2e-2


def _inputs(shape, seed):
    b, h, hk, s, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, g = (torch.randn((b, n, s, d), generator=gen, device="cuda")
                  .to(torch.bfloat16) for n in (h, hk, hk, h))
    return q, k, v, g


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max())


def _grads(q, k, v, g, mode):
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    o = causal_attention(q, k, v, 128, 128, mode)
    return torch.autograd.grad(o, (q, k, v), g)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_backward_matches_plain_and_oracle(shape, mode):
    b, h, hk, s, d = SHAPES[shape]
    q, k, v, g = _inputs(SHAPES[shape], 5)
    n0 = (kernel.ATTN_LAUNCHES, kernel.ATTN_SM90_LAUNCHES,
          kernel.ATTN_BWD_LAUNCHES)
    got = _grads(q, k, v, g, mode)
    torch.cuda.synchronize()
    assert (kernel.ATTN_LAUNCHES - n0[0], kernel.ATTN_SM90_LAUNCHES - n0[1],
            kernel.ATTN_BWD_LAUNCHES - n0[2]) == (1, 1, 1)
    assert [t.dtype for t in got] == [torch.bfloat16] * 3
    assert [t.shape for t in got] == [q.shape, k.shape, v.shape]
    o, lse = kernel.launch_attention(q, k, v, 128, mode, lse=True)
    plain = kernel.attention_backward_plain(q, k, v, o, lse, g, 128, mode)
    for a, w in zip(got, plain):
        assert _rel(a, w) < PLAIN_RTOL
    qq, kk, vv = (t.float().requires_grad_() for t in (q, k, v))
    ref = causal_attention_ref(qq, kk.repeat_interleave(h // hk, 1),
                               vv.repeat_interleave(h // hk, 1))
    want = torch.autograd.grad(ref, (qq, kk, vv), g.float())
    for a, w in zip(got, want):
        assert _rel(a, w) < ORACLE_RTOL


@pytest.mark.parametrize("mode", MODES)
def test_backward_bitwise_repeatable(mode):
    q, k, v, g = _inputs(SHAPES["yi6b"], 6)
    first = _grads(q, k, v, g, mode)
    second = _grads(q, k, v, g, mode)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("mode", MODES)
def test_forward_row_logsumexp(mode):
    """L = m + log2(l) from the forward (whole rows and the combine's cut
    rows) against the fp32 scores' logsumexp; o the same with and without
    L."""
    b, h, hk, s, d = SHAPES["yi6b"]
    q, k, v, _ = _inputs(SHAPES["yi6b"], 7)
    o, lse = kernel.launch_attention(q, k, v, 128, mode, lse=True)
    assert torch.equal(o, kernel.launch_attention(q, k, v, 128, mode))
    sc = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                      k.float().repeat_interleave(h // hk, 1)) * d ** -0.5
    sc.masked_fill_(~torch.ones(s, s, dtype=torch.bool,
                                device="cuda").tril(), float("-inf"))
    want = torch.logsumexp(sc, -1) / torch.log(torch.tensor(2.0))
    assert float((lse - want).abs().max()) < 1e-3


def test_launch_counts_and_refusals():
    """A backward adds one to ATTN_BWD_LAUNCHES and nothing to the forward's
    counters; a simt-shaped call keeps the oracle's vjp; the kernel's
    wrapper refuses what it does not take."""
    q, k, v, g = _inputs((1, 4, 2, 512, 64), 8)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    o = causal_attention(q, k, v, 128, 128, "mapped")
    n0 = (kernel.ATTN_LAUNCHES, kernel.ATTN_SM90_LAUNCHES,
          kernel.ATTN_BWD_LAUNCHES)
    torch.autograd.grad(o, (q, k, v), g)
    assert (kernel.ATTN_LAUNCHES, kernel.ATTN_SM90_LAUNCHES,
            kernel.ATTN_BWD_LAUNCHES) == (n0[0], n0[1], n0[2] + 1)
    o64 = causal_attention(q, k, v, 64, 64, "mapped")
    torch.autograd.grad(o64, (q, k, v), g)
    assert kernel.ATTN_BWD_LAUNCHES == n0[2] + 1
    with torch.no_grad():
        o, lse = kernel.launch_attention(q, k, v, 128, "mapped", lse=True)
        with pytest.raises(ValueError, match="sm90 backward"):
            kernel.launch_attention_backward(q.float(), k.float(), v.float(),
                                             o.float(), lse, g.float(),
                                             "mapped")
        with pytest.raises(ValueError, match="log-sum-exp"):
            kernel.launch_attention(q, k, v, 64, "mapped", lse=True)
    assert kernel.ATTN_BWD_LAUNCHES == n0[2] + 1


def test_expanded_gradient():
    """dO as ``o.sum()``'s backward hands it (expanded, every stride 0) gives
    the gradients of an all-ones dO bit for bit."""
    q, k, v, _ = _inputs(SHAPES["d64"], 9)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    o = causal_attention(q, k, v, 128, 128, "mapped")
    got = torch.autograd.grad(o.sum(), (q, k, v), retain_graph=True)
    want = torch.autograd.grad(o, (q, k, v), torch.ones_like(o))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
