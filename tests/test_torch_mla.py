"""The port's MLA attention (repro_torch.models.attention.mla_*,
deepseek-v2-236b) against the JAX package's, on the CPU: ``mla_apply``
without and with a cache, the whole smoke model (fp32) with the reference's
parameters loaded through ``params_from_jax``, prefill, decode on both
paths (absorbed and ``mla_absorb="never"``) and greedy tokens.

At init ``q_norm``, ``kv_norm`` and every other norm weight is 1, which
would hide a wrong norm: the reference tree is perturbed before both
packages get it.  MLA never reaches the tri_attn kernel (q·k is dn + dr
wide, v dv), so the ``attn_impl`` modes give the same logits."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke
from repro.models import attention as ref_attn
from repro.models import common as ref_common
from repro.models import transformer as RT
from repro.serving.engine import generate as ref_generate
from repro.train.train_step import lm_loss as ref_lm_loss
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.tri_attn import ops as attn_ops
from repro_torch.launch import serve
from repro_torch.models import attention, common
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.serving.engine import generate
from repro_torch.train.train_step import lm_loss

ARCH = "deepseek-v2-236b"
TOL = 1e-4
#: the full config's parameters (the reference's count of the same tree)
FULL_PARAMS = 239_375_569_920
SEQ = 32
MAX_NEW = 6


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, dtype=np.float32)


def _rng(seed):
    return np.random.default_rng(seed)


def _cfgs(**kw):
    return ref_smoke(ARCH).replace(**kw), get_smoke_config(ARCH).replace(**kw)


def perturb(tree, seed=0):
    """Every norm weight (q_norm, kv_norm, ln1, ln2, final_norm) moved off
    1 by N(0, 0.2)."""
    r = _rng(seed)

    def f(path, a):
        a = np.asarray(a)
        if path[-1].key.endswith("norm") or path[-1].key.startswith("ln"):
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


def _tokens(seed, vocab, shape=(2, SEQ)):
    return _rng(seed).integers(0, vocab, shape).astype(np.int32)


def _layer0_attn(model):
    tree, params = model
    rp = jax.tree.map(lambda a: a[0], tree["layers"]["attn"])
    return rp, params.layers[0].attn


def test_norms_are_perturbed(model):
    _, params = model
    a = params.layers[0].attn
    for w in (a.q_norm, a.kv_norm, params.layers[0].ln1, params.final_norm):
        assert float((w - 1).abs().max()) > 0.1


# --- mla_apply ---------------------------------------------------------------


@pytest.mark.parametrize("cached", [False, True], ids=["no_cache", "cache"])
def test_mla_apply_matches_reference(model, cached):
    """The full path (up-projected k, v through ``_sdpa``), cache-less and
    against a cache (prefill: more than 32 tokens, so not absorbed), with
    the cache's latent and RoPE key held too."""
    rp, p = _layer0_attn(model)
    rcfg, cfg = _cfgs()
    x = (_rng(3).standard_normal((2, 40, cfg.d_model)) * 0.5) \
        .astype(np.float32)
    rc = ref_attn.mla_cache_init(rcfg, 2, 48, jnp.float32) if cached else None
    c = attention.mla_cache_init(cfg, 2, 48, torch.float32) if cached else None
    want, wc = ref_attn.mla_apply(rp, rcfg, jnp.asarray(x), cache=rc)
    got, gc = attention.mla_apply(p, cfg, torch.from_numpy(x), cache=c)
    assert got.shape == (2, 40, cfg.d_model)
    assert np.abs(_np(got) - _np(want)).max() < TOL
    if cached:
        assert gc["idx"] == 40
        for key in ("ckv", "krope"):
            assert np.abs(_np(gc[key]) - _np(wc[key])).max() < TOL
    else:
        assert gc is None


@pytest.mark.parametrize("absorb", ["auto", "never"])
def test_mla_decode_paths_match_reference(model, absorb):
    """A 3-token step against a cache holding 20: the absorbed path
    (``auto``, at most 32 new tokens) and the up-projected one (``never``),
    each against the reference's same path."""
    rp, p = _layer0_attn(model)
    rcfg, cfg = _cfgs(mla_absorb=absorb)
    x = (_rng(4).standard_normal((2, 23, cfg.d_model)) * 0.5) \
        .astype(np.float32)
    rc = ref_attn.mla_cache_init(rcfg, 2, 32, jnp.float32)
    c = attention.mla_cache_init(cfg, 2, 32, torch.float32)
    _, rc = ref_attn.mla_apply(rp, rcfg, jnp.asarray(x[:, :20]), cache=rc)
    _, c = attention.mla_apply(p, cfg, torch.from_numpy(x[:, :20]), cache=c)
    pos = np.broadcast_to(np.arange(20, 23), (2, 3))
    want, _ = ref_attn.mla_apply(rp, rcfg, jnp.asarray(x[:, 20:]),
                                 positions=jnp.asarray(pos), cache=rc)
    got, c = attention.mla_apply(p, cfg, torch.from_numpy(x[:, 20:]),
                                 positions=torch.from_numpy(pos.copy()),
                                 cache=c)
    assert c["idx"] == 23
    assert np.abs(_np(got) - _np(want)).max() < TOL


def test_absorbed_decode_equals_up_projected(model):
    """The two decode paths of the port on one cache agree (the
    reference's own test holds them to 2e-4)."""
    rp, p = _layer0_attn(model)
    _, cfg = _cfgs()
    x = torch.from_numpy((_rng(5).standard_normal((2, 17, cfg.d_model))
                          * 0.5).astype(np.float32))
    outs = []
    for absorb in ("auto", "never"):
        c = attention.mla_cache_init(cfg, 2, 24, torch.float32)
        _, c = attention.mla_apply(p, cfg, x[:, :16], cache=c)
        outs.append(attention.mla_apply(
            p, cfg.replace(mla_absorb=absorb), x[:, 16:],
            positions=torch.full((2, 1), 16), cache=c)[0])
    assert float((outs[0] - outs[1]).abs().max()) < TOL


def test_mla_cache_shapes_and_no_int8(model):
    """The cache holds the latent (kv_lora) and the shared RoPE key
    (qk_rope) per layer, in the model's dtype; ``kv_cache_quant`` leaves it
    as it is, as in the reference, and decode gives the same logits."""
    _, params = model
    _, cfg = _cfgs()
    for quant in (False, True):
        c = T.init_cache(cfg.replace(kv_cache_quant=quant), 3, 40,
                         device="cpu")
        assert len(c["layers"]) == cfg.n_layers
        for lc in c["layers"]:
            assert set(lc) == {"ckv", "krope", "idx"}
            assert lc["ckv"].shape == (3, 40, cfg.kv_lora_rank)
            assert lc["krope"].shape == (3, 40, cfg.qk_rope_dim)
            assert lc["ckv"].dtype == torch.float32 and lc["idx"] == 0
    rcfg = ref_smoke(ARCH).replace(kv_cache_quant=True)
    rc = RT.init_cache(rcfg, 3, 40)
    assert rc["layers"]["ckv"].dtype == jnp.float32
    toks = torch.from_numpy(_tokens(6, cfg.vocab_size, (2, 12)))
    logits = []
    for quant in (False, True):
        qcfg = cfg.replace(kv_cache_quant=quant)
        _, c = T.prefill(params, qcfg, toks[:, :11])
        logits.append(T.decode_step(params, qcfg, toks[:, 11:], c)[0])
    assert torch.equal(logits[0], logits[1])


# --- parameters --------------------------------------------------------------


def test_params_round_trip_bitwise(model):
    """params_to_jax(params_from_jax(tree)) gives the tree back, leaf for
    leaf and bit for bit, in fp32 and with bf16 leaves (as raw 2-byte
    words)."""
    tree, params = model
    rcfg, cfg = _cfgs()
    back = params_to_jax(params, cfg)
    flat = jax.tree_util.tree_leaves_with_path(tree)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat] == [p for p, _ in got]
    for (_, a), (_, b) in zip(flat, got):
        np.testing.assert_array_equal(np.asarray(a), b)
    bf = jax.tree.map(np.asarray, RT.init_params(
        jax.random.PRNGKey(1), rcfg.replace(dtype="bfloat16")))
    back = params_to_jax(params_from_jax(bf, cfg.replace(dtype="bfloat16"),
                                         "cpu"), cfg)
    for a, b in zip(jax.tree.leaves(bf), jax.tree.leaves(back)):
        assert a.shape == b.shape
        if a.dtype.name == "bfloat16":
            assert b.dtype == np.dtype("V2")
            np.testing.assert_array_equal(a.view(np.uint16),
                                          b.view(np.uint16))
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
def test_init_params_matches_reference_shapes(full):
    """Random init gives the reference's names, shapes and count: the smoke
    config on the CPU, the full config on the meta device."""
    cfg = get_config(ARCH) if full else get_smoke_config(ARCH)
    rcfg = ref_get_config(ARCH) if full else ref_smoke(ARCH)
    tree = jax.eval_shape(lambda: RT.init_params(jax.random.PRNGKey(0), rcfg))
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           "meta" if full else "cpu")
    want = {tuple(q.key for q in path): leaf.shape
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}
    got = params_to_jax(params, cfg) if not full else None
    if got is not None:
        assert {tuple(q.key for q in path): leaf.shape for path, leaf
                in jax.tree_util.tree_leaves_with_path(got)} == want
    assert isinstance(params.layers[0].attn, attention.MLAAttention)
    assert common.count_params(params) == ref_common.count_params(tree)
    if full:
        assert common.count_params(params) == FULL_PARAMS
        assert params.layers[0].attn.wuq.shape == (1536, 128, 192)
        assert params.layers[0].attn.wo.dtype == torch.bfloat16


# --- forward, lm_loss --------------------------------------------------------


@pytest.mark.parametrize("impl", ["xla", "pallas_mapped"])
def test_forward_matches_reference(model, impl, monkeypatch):
    """Whole-model logits and the MoE aux; no attn_impl sends MLA to the
    tri_attn kernel."""
    tree, params = model
    kw = dict(attn_impl=impl, attn_block=16, pallas_interpret=True)
    rcfg, cfg = _cfgs(**kw)
    seen = []
    monkeypatch.setattr(attn_ops, "causal_attention",
                        lambda *a, **k: seen.append(a))
    toks = _tokens(1, cfg.vocab_size)
    want, waux = RT.forward(tree, rcfg, jnp.asarray(toks), with_aux=True)
    got, gaux = T.forward(params, cfg, torch.from_numpy(toks), with_aux=True)
    assert seen == []
    assert got.shape == (2, SEQ, cfg.padded_vocab)
    assert np.abs(_np(got) - _np(want)).max() < TOL
    assert abs(float(gaux) - float(waux)) < TOL


def test_lm_loss_matches_reference(model):
    tree, params = model
    rcfg, cfg = _cfgs()
    toks = _tokens(2, cfg.vocab_size)
    labels = np.roll(toks, -1, axis=1)
    want, wm = ref_lm_loss(tree, rcfg, {"tokens": jnp.asarray(toks),
                                        "labels": jnp.asarray(labels)})
    got, gm = lm_loss(params, cfg, {"tokens": torch.from_numpy(toks),
                                    "labels": torch.from_numpy(labels)})
    assert abs(float(got) - float(want)) < TOL
    for key in ("ce", "z_loss", "moe_aux"):
        assert abs(float(gm[key]) - float(wm[key])) < TOL


# --- prefill, decode, generate -----------------------------------------------


@pytest.mark.parametrize("absorb", ["auto", "never"])
def test_prefill_and_decode_match_reference(model, absorb):
    """Prefill logits and every layer's latent and RoPE key, then four
    decode steps on the absorbed (``auto``) or up-projected (``never``)
    path, each fed the reference's argmax, at a capacity that drops
    nothing."""
    tree, params = model
    rcfg, cfg = _cfgs(mla_absorb=absorb, capacity_factor=16.0)
    toks = _tokens(5, cfg.vocab_size, (2, 24))
    want, rc = RT.prefill(tree, rcfg, jnp.asarray(toks))
    got, c = T.prefill(params, cfg, torch.from_numpy(toks))
    assert np.abs(_np(got) - _np(want)).max() < TOL
    for i, lc in enumerate(c["layers"]):
        assert lc["idx"] == 24
        for key in ("ckv", "krope"):
            assert np.abs(_np(lc[key]) - _np(rc["layers"][key][i])).max() \
                < TOL
    tok = np.asarray(jnp.argmax(want[:, -1:], -1)).astype(np.int32)
    for _ in range(4):
        wd, rc = RT.decode_step(tree, rcfg, jnp.asarray(tok), rc)
        gd, c = T.decode_step(params, cfg, torch.from_numpy(tok), c)
        assert np.abs(_np(gd) - _np(wd)).max() < TOL
        tok = np.asarray(jnp.argmax(wd, -1)).astype(np.int32)
    assert c["layers"][0]["idx"] == 28


def test_whole_model_absorbed_equals_up_projected(model):
    """One decode step on one cache, absorbed against ``never``, and both
    against a cache-less forward over prompt + token."""
    _, params = model
    _, cfg = _cfgs(capacity_factor=16.0)
    toks = torch.from_numpy(_tokens(7, cfg.vocab_size, (2, 16)))
    outs = []
    for absorb in ("auto", "never"):
        c = T.init_cache(cfg, 2, 16, device="cpu")
        _, c = T.prefill(params, cfg, toks[:, :15], cache=c)
        outs.append(T.decode_step(params, cfg.replace(mla_absorb=absorb),
                                  toks[:, 15:], c)[0][:, 0])
    full = T.forward(params, cfg, toks)[:, -1]
    assert float((outs[0] - outs[1]).abs().max()) < TOL
    assert float((outs[0] - full).abs().max()) < TOL


@pytest.mark.parametrize("batch,seed", [(1, 11), (3, 12)])
def test_greedy_tokens_match_reference(model, batch, seed):
    tree, params = model
    rcfg, cfg = _cfgs(max_seq=16 + MAX_NEW)
    toks = _tokens(seed, cfg.vocab_size, (batch, 16))
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
