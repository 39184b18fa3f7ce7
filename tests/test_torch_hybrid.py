"""The port's ``hybrid`` family (repro_torch.models.mamba2, zamba2-1.2b:
Mamba2 layers and one shared attention + MLP block) against the JAX
package's, on the CPU, at the smoke config (fp32), with the reference's
parameters loaded through ``params_from_jax``.

At init the norm weights are 1, ``conv_b`` and ``dt_bias`` 0, ``d_skip`` 1
and ``a_log`` a fixed ramp, which would hide a wrong norm, bias, skip or
decay: the reference tree is perturbed before both packages get it.  The
tri_attn impls run with ``pallas_interpret=True`` and block 16 on both
sides.  A 64-token pass takes the chunked SSD, a 32-token one and every
decode step the scan."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke
from repro.models import common as ref_common
from repro.models import mamba2 as ref_m2
from repro.models import transformer as RT
from repro.serving.engine import generate as ref_generate
from repro.train.train_step import lm_loss as ref_lm_loss
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.tri_attn import ops as attn_ops
from repro_torch.launch import serve
from repro_torch.models import common, mamba2
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import generate
from repro_torch.train.train_step import lm_loss

ARCH = "zamba2-1.2b"
IMPLS = ["xla", "pallas_mapped", "pallas_bb"]
TOL = 1e-4
#: the full config's parameters (the reference's count of the same tree)
FULL_PARAMS = 1_170_473_856
MAX_NEW = 6
#: init-time constants of a Mamba2 layer and the norms, each moved
PERTURBED = ("ln", "final_norm", "norm", "conv_b", "dt_bias", "d_skip",
             "a_log")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, dtype=np.float32)


def _rng(seed):
    return np.random.default_rng(seed)


def _cfgs(**kw):
    return ref_smoke(ARCH).replace(**kw), get_smoke_config(ARCH).replace(**kw)


def _impl_kw(impl):
    return dict(attn_impl=impl, attn_block=16, pallas_interpret=True)


def perturb(tree, seed=0):
    """Norm weights, conv_b, dt_bias, d_skip and a_log moved by N(0, 0.2)."""
    r = _rng(seed)

    def f(path, a):
        a = np.asarray(a)
        if path[-1].key.startswith(PERTURBED):
            return (a + 0.2 * r.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(f, tree)


@functools.lru_cache(maxsize=None)
def _build():
    rcfg, cfg = _cfgs()
    tree = perturb(jax.tree.map(np.asarray,
                                RT.init_params(jax.random.PRNGKey(0), rcfg)))
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree, cfg, "cpu")


@pytest.fixture(scope="module")
def model():
    return _build()


def _tokens(seed, vocab, shape=(2, 64)):
    return _rng(seed).integers(0, vocab, shape).astype(np.int32)


def _layer(model, i=1):
    tree, params = model
    return (jax.tree.map(lambda a: a[i], tree["layers"]["mamba"]),
            params.layers[i].mamba)


def _ssm_inputs(cfg, seed, s=64, b=2):
    """Random conv outputs (B, S, d_inner + 2N), raw dt (B, S, H) and a
    nonzero fp32 state (B, H, P, N)."""
    r = _rng(seed)
    h, n = cfg.mamba_heads, cfg.ssm_state
    xbc = (r.standard_normal((b, s, cfg.mamba_d_inner + 2 * n)) * 0.5)
    dt = r.standard_normal((b, s, h)) * 0.5
    st = r.standard_normal((b, h, cfg.mamba_d_inner // h, n)) * 0.1
    return [a.astype(np.float32) for a in (xbc, dt, st)]


# --- the Mamba2 block --------------------------------------------------------


@pytest.mark.parametrize("core", ["chunked", "scan"])
def test_core_matches_reference(model, core):
    """mamba2_core_chunked (chunk 16 and 64) and mamba2_core_scan from a
    nonzero state: output and final state."""
    rcfg, cfg = _cfgs()
    rp, p = _layer(model)
    xbc, dt, st = _ssm_inputs(cfg, 1)
    chunks = (16, 64) if core == "chunked" else (None,)
    for chunk in chunks:
        args = (jnp.asarray(xbc), jnp.asarray(dt), jnp.asarray(st))
        targs = tuple(map(torch.from_numpy, (xbc, dt, st)))
        if core == "chunked":
            want = ref_m2.mamba2_core_chunked(rp, rcfg, *args, chunk=chunk)
            got = mamba2.mamba2_core_chunked(p, cfg, *targs, chunk=chunk)
        else:
            want = ref_m2.mamba2_core_scan(rp, rcfg, *args)
            got = mamba2.mamba2_core_scan(p, cfg, *targs)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            assert np.abs(_np(g) - _np(w)).max() < TOL


def test_chunked_equals_scan(model):
    """The two evaluation orders agree, as the reference's test holds them
    (1e-5 on y), and the final states too."""
    _, cfg = _cfgs()
    _, p = _layer(model)
    xbc, dt, st = map(torch.from_numpy, _ssm_inputs(cfg, 2, s=128))
    ys, ss = mamba2.mamba2_core_scan(p, cfg, xbc, dt, st)
    for chunk in (16, 32, 64):
        yc, sc = mamba2.mamba2_core_chunked(p, cfg, xbc, dt, st, chunk)
        assert (yc - ys).abs().max() < 1e-5
        assert (sc - ss).abs().max() < TOL


def test_chunked_rejects_an_unaligned_sequence(model):
    _, cfg = _cfgs()
    _, p = _layer(model)
    xbc, dt, st = map(torch.from_numpy, _ssm_inputs(cfg, 3, s=40))
    with pytest.raises(ValueError, match="multiple of chunk"):
        mamba2.mamba2_core_chunked(p, cfg, xbc, dt, st, 64)


@pytest.mark.parametrize("seq", [64, 32], ids=["chunked", "scan"])
def test_mamba2_apply_matches_reference(model, seq):
    """The whole block: projection, causal conv, the SSD, gated norm and
    out projection; the returned state and conv tail too."""
    rcfg, cfg = _cfgs()
    rp, p = _layer(model)
    x = (_rng(4).standard_normal((2, seq, cfg.d_model)) * 0.5) \
        .astype(np.float32)
    want = ref_m2.mamba2_apply(rp, rcfg, jnp.asarray(x))
    got = mamba2.mamba2_apply(p, cfg, torch.from_numpy(x))
    for g, w in zip(got, want):
        assert np.abs(_np(g) - _np(w)).max() < TOL


def test_decode_token_by_token_matches_the_parallel_form(model):
    """One token at a time from the carried state and conv tail (the scan)
    against one chunked pass, and against the reference's own steps."""
    rcfg, cfg = _cfgs()
    rp, p = _layer(model)
    x = (_rng(5).standard_normal((2, 64, cfg.d_model)) * 0.5) \
        .astype(np.float32)
    full, _, _ = mamba2.mamba2_apply(p, cfg, torch.from_numpy(x))
    st = tail = rst = rtail = None
    for t in range(8):
        o, st, tail = mamba2.mamba2_apply(p, cfg, torch.from_numpy(
            x[:, t:t + 1]), state=st, conv_tail=tail)
        ro, rst, rtail = ref_m2.mamba2_apply(rp, rcfg, jnp.asarray(
            x[:, t:t + 1]), state=rst, conv_tail=rtail)
        assert (o[:, 0] - full[:, t]).abs().max() < 1e-5
        assert np.abs(_np(o) - _np(ro)).max() < TOL
        assert np.abs(_np(tail) - _np(rtail)).max() < TOL
    assert tail.shape == (2, cfg.mamba_conv_width - 1,
                          cfg.mamba_d_inner + 2 * cfg.ssm_state)


# --- parameters --------------------------------------------------------------


def _expected(tree, n_layers, pick=lambda leaf, i: leaf[i]) -> dict:
    """Port parameter name -> the reference leaf's slice it must hold
    (``pick(leaf, i)`` of layer i's; ``shared`` is not stacked)."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        keys = [q.key for q in path]
        if keys[0] == "layers":
            for i in range(n_layers):
                out[".".join(["layers", str(i), *keys[1:]])] = pick(leaf, i)
        else:
            out[".".join(keys)] = leaf
    return out


def test_params_from_jax_keeps_every_weight(model):
    """Every reference leaf (every layer's slice of it) lands in exactly one
    port tensor, value for value, and the port holds nothing else."""
    tree, params = model
    cfg = get_smoke_config(ARCH)
    want = _expected(tree, cfg.n_layers)
    got = dict(params.named_parameters())
    assert set(got) == set(want)
    for name, leaf in want.items():
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(leaf))
    assert common.count_params(params) == ref_common.count_params(tree)
    assert isinstance(params, T.HybridLM)
    for name in ("a_log", "dt_bias", "d_skip"):
        assert getattr(params.layers[0].mamba, name).dtype == torch.float32


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
def test_init_params_matches_reference_shapes(full):
    """Random init gives the reference's names, shapes and count (the smoke
    config on the CPU, the full config on the meta device), and at the smoke
    config the reference's deterministic constants."""
    cfg = get_config(ARCH) if full else get_smoke_config(ARCH)
    rcfg = ref_get_config(ARCH) if full else ref_smoke(ARCH)
    tree = jax.eval_shape(lambda: RT.init_params(jax.random.PRNGKey(0), rcfg))
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           "meta" if full else "cpu")
    shapes = {n: tuple(getattr(a, "shape", a)) for n, a in _expected(
        tree, cfg.n_layers, lambda leaf, i: leaf.shape[1:]).items()}
    assert {n: tuple(p.shape) for n, p in params.named_parameters()} == shapes
    assert common.count_params(params) == ref_common.count_params(tree)
    if full:
        assert common.count_params(params) == FULL_PARAMS
        assert params.layers[0].mamba.in_proj.dtype == torch.bfloat16
        return
    rtree = RT.init_params(jax.random.PRNGKey(0), rcfg)
    m = params.layers[2].mamba
    for name in ("a_log", "dt_bias", "d_skip", "conv_b", "norm"):
        np.testing.assert_allclose(
            _np(getattr(m, name)),
            np.asarray(rtree["layers"]["mamba"][name][2]), rtol=1e-6)
    w = cfg.mamba_conv_width
    assert float(m.conv_w.std()) == pytest.approx(1.0 / w, rel=0.1)


# --- forward, lm_loss --------------------------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_matches_reference(model, impl):
    tree, params = model
    rcfg, cfg = _cfgs(**_impl_kw(impl))
    toks = _tokens(1, cfg.vocab_size)
    want = RT.forward(tree, rcfg, jnp.asarray(toks))
    got, aux = T.forward(params, cfg, torch.from_numpy(toks), with_aux=True)
    assert got.dtype == torch.float32
    assert got.shape == (2, 64, cfg.padded_vocab)
    assert np.abs(_np(got) - _np(want)).max() < TOL
    assert float(aux) == 0.0
    if impl == "xla":   # the module's own call runs its config ("xla")
        assert torch.equal(params(torch.from_numpy(toks)), got)


@pytest.mark.parametrize("impl", IMPLS)
def test_lm_loss_matches_reference(model, impl):
    tree, params = model
    rcfg, cfg = _cfgs(**_impl_kw(impl))
    toks = _tokens(2, cfg.vocab_size)
    labels = np.roll(toks, -1, axis=1)
    want, wm = ref_lm_loss(tree, rcfg, {"tokens": jnp.asarray(toks),
                                        "labels": jnp.asarray(labels)})
    got, gm = lm_loss(params, cfg, {"tokens": torch.from_numpy(toks),
                                    "labels": torch.from_numpy(labels)})
    assert abs(float(got) - float(want)) < TOL
    for key in ("ce", "z_loss", "moe_aux"):
        assert abs(float(gm[key]) - float(wm[key])) < TOL


def test_kernel_runs_at_every_firing(model, monkeypatch):
    """A cache-less kernel forward calls tri_attn once per firing of the
    shared block (layers 2 and 5 of 6, period 3), from no Mamba2 layer; at
    a length that is not a multiple of the block, never."""
    _, params = model
    cfg = get_smoke_config(ARCH).replace(**_impl_kw("pallas_mapped"))
    real, seen = attn_ops.causal_attention, []

    def counting(q, *args, **kw):
        seen.append(tuple(q.shape))
        return real(q, *args, **kw)

    monkeypatch.setattr(attn_ops, "causal_attention", counting)
    toks = torch.from_numpy(_tokens(3, cfg.vocab_size))
    T.forward(params, cfg, toks)
    assert len(seen) == cfg.n_layers // cfg.hybrid_attn_every == 2
    assert set(seen) == {(2, cfg.n_heads, 64, cfg.head_dim)}
    seen.clear()
    T.forward(params, cfg, toks[:, :24])
    assert seen == []


def test_shared_block_moves_the_logits(model):
    """The shared block is live: a forward whose firings add nothing
    differs from the real one far beyond the tolerance."""
    _, params = model
    cfg = get_smoke_config(ARCH)
    toks = torch.from_numpy(_tokens(4, cfg.vocab_size))
    base = T.forward(params, cfg, toks)
    never = T.forward(params, cfg.replace(hybrid_attn_every=cfg.n_layers + 1),
                      toks)
    assert (base - never).abs().max() > 100 * TOL


# --- caches, prefill, decode, generate ---------------------------------------


def test_init_cache_layout():
    """fp32 Mamba states (B, H, P, N), conv tails (B, W-1, d_inner + 2N) in
    the weights' dtype, one GQA cache per invocation, unquantised under
    kv_cache_quant, as the reference's."""
    cfg = get_smoke_config(ARCH).replace(kv_cache_quant=True)
    c = T.init_cache(cfg, 3, 40, device="cpu")
    rc = RT.init_cache(ref_smoke(ARCH).replace(kv_cache_quant=True), 3, 40)
    assert len(c["layers"]) == cfg.n_layers and c["idx"] == 0
    for lc in c["layers"]:
        assert lc["state"].dtype == torch.float32
        assert tuple(lc["state"].shape) == rc["mamba_state"].shape[1:]
        assert tuple(lc["conv_tail"].shape) == rc["conv_tail"].shape[1:]
    assert len(c["shared"]) == rc["shared"]["k"].shape[0] == 2
    for sc in c["shared"]:
        assert set(sc) == {"k", "v", "idx"}
        assert sc["k"].dtype == torch.float32
        assert tuple(sc["k"].shape) == rc["shared"]["k"].shape[1:]


@pytest.mark.parametrize("seq", [64, 32], ids=["chunked", "scan"])
def test_prefill_and_decode_match_reference(model, seq):
    """Prefill logits, every layer's Mamba state and conv tail, and each
    invocation's k/v; then four decode steps, each fed the reference's
    argmax, their caches held after the last."""
    tree, params = model
    rcfg, cfg = _cfgs(max_seq=seq + 8)
    toks = _tokens(5, cfg.vocab_size, (2, seq))
    want, rc = RT.prefill(tree, rcfg, jnp.asarray(toks))
    got, c = T.prefill(params, cfg, torch.from_numpy(toks))
    assert np.abs(_np(got) - _np(want)).max() < TOL
    tok = np.asarray(jnp.argmax(want[:, -1:], -1)).astype(np.int32)
    for _ in range(4):
        wd, rc = RT.decode_step(tree, rcfg, jnp.asarray(tok), rc)
        gd, c = T.decode_step(params, cfg, torch.from_numpy(tok), c)
        assert np.abs(_np(gd) - _np(wd)).max() < TOL
        tok = np.asarray(jnp.argmax(wd, -1)).astype(np.int32)
    assert c["idx"] == int(rc["idx"]) == seq + 4
    for i, lc in enumerate(c["layers"]):
        assert np.abs(_np(lc["state"]) - _np(rc["mamba_state"][i])).max() \
            < TOL
        assert np.abs(_np(lc["conv_tail"])
                      - _np(rc["conv_tail"][i])).max() < TOL
    for inv, sc in enumerate(c["shared"]):
        assert sc["idx"] == seq + 4
        for key in ("k", "v"):
            assert np.abs(_np(sc[key]) - _np(rc["shared"][key][inv])).max() \
                < TOL


@pytest.mark.parametrize("prompt_len,batch,seed",
                         [(16, 1, 11), (16, 3, 12), (64, 2, 13)])
def test_greedy_tokens_match_reference(model, prompt_len, batch, seed):
    tree, params = model
    rcfg, cfg = _cfgs(max_seq=prompt_len + MAX_NEW)
    toks = _tokens(seed, cfg.vocab_size, (batch, prompt_len))
    want = ref_generate(tree, rcfg, jnp.asarray(toks), MAX_NEW)
    got = generate(params, cfg, torch.from_numpy(toks), MAX_NEW)
    assert got.steps == want.steps == MAX_NEW
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))


def test_lm_demo_runs_on_the_cpu(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "16", "--max-new", "4"])
    out = capsys.readouterr().out
    assert f"arch={ARCH}" in out and "device=cpu" in out
    assert "generated 4 steps x 2 seqs" in out
