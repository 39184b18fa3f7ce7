"""The port's dense LM path (repro_torch.configs, models, train.train_step)
against the JAX package's, on the CPU.  Reference parameters go into the
port through ``params_from_jax``; inputs are made by numpy from a seed; the
smoke configs of yi-6b and llama3.2-3b (tied embeddings) are fp32.  The
tri_attn impls run with ``pallas_interpret=True`` on both sides."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke
from repro.models import attention as ref_attn
from repro.models import common as ref_common
from repro.models import transformer as RT
from repro.train.train_step import (
    TrainConfig as RefTrainConfig, lm_loss as ref_lm_loss,
    make_eval_step as ref_make_eval_step,
)
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import attention, common
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.train.train_step import TrainConfig, lm_loss, make_eval_step

ARCHS = ["yi-6b", "llama3.2-3b"]
IMPLS = ["xla", "pallas_mapped", "pallas_bb"]
TOL = 1e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, dtype=np.float32)


def _rng(seed):
    return np.random.default_rng(seed)


def _cfgs(arch, **kw):
    return ref_smoke(arch).replace(**kw), get_smoke_config(arch).replace(**kw)


def _impl_kw(impl):
    return dict(attn_impl=impl, attn_block=16, pallas_interpret=True)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    rcfg, cfg = _cfgs(arch)
    rparams = RT.init_params(jax.random.PRNGKey(0), rcfg)
    params = params_from_jax(jax.tree.map(np.asarray, rparams), cfg, "cpu")
    return arch, rparams, params


def _tokens(seed, vocab, shape=(2, 32)):
    return _rng(seed).integers(0, vocab, shape).astype(np.int32)


# --- configs -----------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_round_trip(arch):
    assert dataclasses.asdict(get_config(arch)) \
        == dataclasses.asdict(ref_get_config(arch))
    assert dataclasses.asdict(get_smoke_config(arch)) \
        == dataclasses.asdict(ref_smoke(arch))
    assert get_config(arch).padded_vocab == ref_get_config(arch).padded_vocab


# --- common ------------------------------------------------------------------


def test_rms_norm_matches_reference():
    x, w = _rng(0).standard_normal((2, 5, 48)), _rng(1).standard_normal(48)
    x, w = x.astype(np.float32), w.astype(np.float32)
    want = ref_common.rms_norm(jnp.asarray(x), jnp.asarray(w))
    got = common.rms_norm(torch.from_numpy(x), torch.from_numpy(w))
    assert np.abs(_np(got) - _np(want)).max() < 1e-5


@pytest.mark.parametrize("theta", [10000.0, 5000000.0])
def test_rope_matches_reference(theta):
    x = _rng(2).standard_normal((2, 12, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12)[None] + 100, (2, 12))
    want = ref_common.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = common.rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                      theta)
    assert np.abs(_np(got) - _np(want)).max() < 1e-5


def test_swiglu_matches_reference():
    r = _rng(3)
    x = r.standard_normal((2, 7, 16)).astype(np.float32)
    ws = [r.standard_normal(s).astype(np.float32) * 0.3
          for s in ((16, 40), (16, 40), (40, 16))]
    want = ref_common.swiglu(jnp.asarray(x), *map(jnp.asarray, ws))
    got = common.swiglu(torch.from_numpy(x), *map(torch.from_numpy, ws))
    assert np.abs(_np(got) - _np(want)).max() < 1e-5


def test_quantize_rows_matches_reference():
    x = (_rng(4).standard_normal((4, 7, 2, 16)) * 3.0).astype(np.float32)
    wq, ws = ref_attn._quantize_rows(jnp.asarray(x))
    gq, gs = attention._quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-7)


# --- attention ---------------------------------------------------------------


def _gqa_pair(cfg_kw=None):
    rcfg, cfg = _cfgs("yi-6b", rope_theta=10000.0, **(cfg_kw or {}))
    rp = ref_attn.gqa_init(jax.random.PRNGKey(0), rcfg, jnp.float32)
    p = attention.GQAAttention(*(torch.from_numpy(np.array(rp[k]))
                                 for k in ("wq", "wk", "wv", "wo")))
    return rcfg, cfg, rp, p


@pytest.mark.parametrize("impl", IMPLS)
def test_gqa_apply_matches_reference(impl):
    rcfg, cfg, rp, p = _gqa_pair(_impl_kw(impl))
    x = (_rng(5).standard_normal((2, 64, cfg.d_model)) * 0.3) \
        .astype(np.float32)
    want, _ = ref_attn.gqa_apply(rp, rcfg, jnp.asarray(x))
    got, cache = attention.gqa_apply(p, cfg, torch.from_numpy(x))
    assert cache is None
    assert np.abs(_np(got) - _np(want)).max() < TOL


@pytest.mark.parametrize("quant", [False, True])
def test_gqa_cache_prefill_decode_matches_reference(quant):
    """Prefill 15 positions into a cache, then decode the 16th — with the
    int8 cache too — as the reference does."""
    rcfg, cfg, rp, p = _gqa_pair({"kv_cache_quant": quant})
    x = (_rng(6).standard_normal((2, 16, cfg.d_model)) * 0.3) \
        .astype(np.float32)
    rc = ref_attn.gqa_cache_init(rcfg, 2, 32, jnp.float32)
    c = attention.gqa_cache_init(cfg, 2, 32, torch.float32, "cpu")
    if quant:
        assert c["k"].dtype == torch.int8 and c["k_scale"].shape == (2, 32, 2, 1)
    wpre, rc = ref_attn.gqa_apply(rp, rcfg, jnp.asarray(x[:, :15]),
                                  positions=jnp.arange(15)[None], cache=rc)
    gpre, c = attention.gqa_apply(p, cfg, torch.from_numpy(x[:, :15]),
                                  positions=torch.arange(15)[None], cache=c)
    assert c["idx"] == 15
    wlast, rc = ref_attn.gqa_apply(rp, rcfg, jnp.asarray(x[:, 15:16]),
                                   positions=jnp.full((2, 1), 15), cache=rc)
    glast, c = attention.gqa_apply(p, cfg, torch.from_numpy(x[:, 15:16]),
                                   positions=torch.full((2, 1), 15), cache=c)
    assert np.abs(_np(gpre) - _np(wpre)).max() < TOL
    assert np.abs(_np(glast) - _np(wlast)).max() < TOL
    assert c["idx"] == int(rc["idx"]) == 16
    for key in c:
        if key != "idx":
            np.testing.assert_allclose(_np(c[key]), _np(rc[key]), atol=TOL)


def test_sdpa_chunked_equals_unchunked():
    r = _rng(7)
    q = torch.from_numpy(r.standard_normal((2, 512, 4, 32)).astype(np.float32))
    k = torch.from_numpy(r.standard_normal((2, 512, 2, 32)).astype(np.float32))
    v = torch.from_numpy(r.standard_normal((2, 512, 2, 32)).astype(np.float32))
    pos = torch.arange(512)[None].expand(2, 512)
    full = attention._sdpa(q, k, v, 2, pos, chunk=1024)
    chunked = attention._sdpa(q, k, v, 2, pos, chunk=128)
    assert (full - chunked).abs().max() < 1e-5
    want = ref_attn._sdpa(*(jnp.asarray(t.numpy()) for t in (q, k, v)), 2,
                          jnp.asarray(pos.numpy()))
    assert np.abs(_np(chunked) - _np(want)).max() < TOL


# --- the model ---------------------------------------------------------------


def test_params_from_jax_keeps_every_weight(model):
    arch, rparams, params = model
    assert common.count_params(params) == ref_common.count_params(rparams)
    np.testing.assert_array_equal(
        params.layers[1].attn.wq.numpy(),
        np.asarray(rparams["layers"]["attn"]["wq"][1]))
    assert (params.lm_head is None) == get_smoke_config(arch).tie_embeddings


def test_init_params_matches_reference_shapes(model):
    """Random init on the port's side gives the converted reference model's
    parameter names and shapes, frozen unless a gradient is asked for."""
    arch, _, converted = model
    params = T.init_params(get_smoke_config(arch),
                           torch.Generator().manual_seed(0), "cpu")

    def shapes(m):
        return {n: tuple(p.shape) for n, p in m.named_parameters()}

    assert shapes(params) == shapes(converted)
    assert all(not p.requires_grad for p in params.parameters())
    assert params.embed.std().item() == pytest.approx(0.02, rel=0.05)


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_matches_reference(model, impl):
    arch, rparams, params = model
    rcfg, cfg = _cfgs(arch, **_impl_kw(impl))
    toks = _tokens(1, cfg.vocab_size)
    want = RT.forward(rparams, rcfg, jnp.asarray(toks))
    # the module's own call runs the config it was built with ("xla")
    got = params(torch.from_numpy(toks)) if impl == "xla" \
        else T.forward(params, cfg, torch.from_numpy(toks))
    assert got.dtype == torch.float32
    assert got.shape == (2, 32, cfg.padded_vocab)
    assert np.abs(_np(got) - _np(want)).max() < TOL


@pytest.mark.parametrize("impl", IMPLS)
def test_lm_loss_and_eval_step_match_reference(model, impl):
    arch, rparams, params = model
    rcfg, cfg = _cfgs(arch, **_impl_kw(impl))
    toks = _tokens(2, cfg.vocab_size)
    labels = np.roll(toks, -1, axis=1)
    mask = (_rng(3).random(toks.shape) > 0.2).astype(np.float32)
    rbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
              "mask": jnp.asarray(mask)}
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels), "mask": torch.from_numpy(mask)}
    want, wm = ref_lm_loss(rparams, rcfg, rbatch)
    got, gm = lm_loss(params, cfg, batch)
    assert abs(float(got) - float(want)) < TOL
    for key in ("ce", "z_loss", "moe_aux"):
        assert abs(float(gm[key]) - float(wm[key])) < TOL
    rev = ref_make_eval_step(rcfg, RefTrainConfig())(rparams, rbatch)
    ev = make_eval_step(cfg, TrainConfig())(params, batch)
    assert set(ev) == set(rev)
    assert abs(float(ev["loss"]) - float(rev["loss"])) < TOL


def test_gradients_flow_through_the_kernel_path(model):
    """With a weight that asks for a gradient, forward builds the graph and
    the tri_attn autograd.Function's backward gives the plain path's
    gradient."""
    arch, _, params = model
    toks = torch.from_numpy(_tokens(4, get_smoke_config(arch).vocab_size))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    wq = params.layers[0].attn.wq
    grads = {}
    try:
        wq.requires_grad_(True)
        for impl in ("xla", "pallas_mapped"):
            cfg = get_smoke_config(arch).replace(**_impl_kw(impl))
            loss, _ = lm_loss(params, cfg, batch)
            (grads[impl],) = torch.autograd.grad(loss, [wq])
    finally:
        wq.requires_grad_(False)
    assert torch.isfinite(grads["xla"]).all()
    assert (grads["xla"] - grads["pallas_mapped"]).abs().max() < 1e-5


def test_float64_model_computes_in_float64():
    """``dtype="float64"`` (numerics checks on the CPU): the weights, the
    activations, the fp32 islands (norms, rope, softmax, logits, the loss)
    and every gradient in float64, within fp32 rounding of the fp32
    model's loss and gradients from the same seed."""
    cfg32 = get_smoke_config("yi-6b")
    toks = torch.from_numpy(_tokens(4, cfg32.vocab_size))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    out = {}
    for cfg in (cfg32, cfg32.replace(dtype="float64")):
        params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        leaves = list(params.parameters())
        for w in leaves:
            w.requires_grad_(True)
        loss, _ = lm_loss(params, cfg, batch)
        out[cfg.dtype] = (loss, torch.autograd.grad(loss, leaves))
    loss64, grads64 = out["float64"]
    loss32, grads32 = out["float32"]
    assert loss64.dtype == torch.float64
    assert all(g.dtype == torch.float64 for g in grads64)
    assert abs(float(loss64) - float(loss32)) < 1e-5 * abs(float(loss64))
    for g64, g32 in zip(grads64, grads32):
        assert (g64 - g32).abs().max() <= 1e-4 * g64.abs().max()


def test_prefill_decode_match_reference(model):
    arch, rparams, params = model
    rcfg, cfg = _cfgs(arch)
    toks = _tokens(5, cfg.vocab_size)
    wpre, rcache = RT.prefill(rparams, rcfg, jnp.asarray(toks))
    gpre, cache = T.prefill(params, cfg, torch.from_numpy(toks))
    assert np.abs(_np(gpre) - _np(wpre)).max() < TOL
    nt = np.asarray(jnp.argmax(wpre[:, -1:], axis=-1)).astype(np.int32)
    assert np.array_equal(gpre[:, -1:].argmax(-1).numpy(), nt)
    wdec, _ = RT.decode_step(rparams, rcfg, jnp.asarray(nt), rcache)
    gdec, cache = T.decode_step(params, cfg, torch.from_numpy(nt), cache)
    assert np.abs(_np(gdec) - _np(wdec)).max() < TOL
    assert all(c["idx"] == 33 for c in cache["layers"])
    # decode against the cache = a forward over prompt + token (the
    # reference's own consistency bound)
    full = T.forward(params, cfg, torch.from_numpy(
        np.concatenate([toks, nt], axis=1)))
    assert (gdec[:, 0] - full[:, -1]).abs().max() < 5e-3


def test_int8_kv_decode_matches_reference(model):
    arch, rparams, params = model
    rcfg, cfg = _cfgs(arch, kv_cache_quant=True)
    toks = _tokens(6, cfg.vocab_size, (2, 16))
    _, rcache = RT.prefill(rparams, rcfg, jnp.asarray(toks[:, :15]))
    _, cache = T.prefill(params, cfg, torch.from_numpy(toks[:, :15]))
    assert cache["layers"][0]["k"].dtype == torch.int8
    wdec, _ = RT.decode_step(rparams, rcfg, jnp.asarray(toks[:, 15:]), rcache)
    gdec, _ = T.decode_step(params, cfg, torch.from_numpy(toks[:, 15:]), cache)
    assert np.abs(_np(gdec) - _np(wdec)).max() < TOL


# --- what is not ported yet --------------------------------------------------


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if ref_smoke(a).family
                                  not in T.PORTED_FAMILIES
                                  or ref_smoke(a).attention_type == "mla"])
def test_unported_families_raise(arch):
    """Every family is ported (moe and hybrid held in
    tests/test_torch_{moe,hybrid}.py), and so is deepseek-v2-236b, a moe
    config on MLA attention (held in tests/test_torch_mla.py): it builds
    with MLA layers, takes an MLA cache and runs a forward."""
    cfg = get_smoke_config(arch)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert all(isinstance(lp.attn, attention.MLAAttention)
               for lp in params.layers)
    cache = T.init_cache(cfg, 1, 8, device="cpu")
    assert cache["layers"][0]["ckv"].shape == (1, 8, cfg.kv_lora_rank)
    logits = T.forward(params, cfg, torch.zeros((1, 8), dtype=torch.int64))
    assert logits.shape == (1, 8, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())


def test_unported_attention_raises():
    """xla_mapped (item 10) is ported: it no longer raises, and at S 512
    it gives the plain attention's output (its parity with the reference's
    is held in ``tests/test_torch_launch_tools.py``).  Cross-attention
    (item 7) is ported: ``cross_kv`` attends over the given states without
    a mask and takes no cache (its parity is held in
    ``tests/test_torch_cross_models.py``).  MLA (item 8c) is ported: a
    config with ``attention_type="mla"`` builds MLA layers, which take no
    ``cross_kv`` (parity in ``tests/test_torch_mla.py``)."""
    rcfg, cfg, rp, p = _gqa_pair()
    x = torch.zeros((1, 512, cfg.d_model))
    xs = (_rng(8).standard_normal((1, 12, cfg.d_model)) * 0.3) \
        .astype(np.float32)
    q = (_rng(9).standard_normal((1, 8, cfg.d_model)) * 0.3) \
        .astype(np.float32)
    want, _ = ref_attn.gqa_apply(rp, rcfg, jnp.asarray(q),
                                 cross_kv=jnp.asarray(xs))
    got, cache = attention.gqa_apply(p, cfg, torch.from_numpy(q),
                                     cross_kv=torch.from_numpy(xs))
    assert cache is None
    assert np.abs(_np(got) - _np(want)).max() < TOL
    x = torch.from_numpy((_rng(10).standard_normal((1, 512, cfg.d_model))
                          * 0.3).astype(np.float32))
    mapped, _ = attention.gqa_apply(p, cfg.replace(attn_impl="xla_mapped"), x)
    plain, _ = attention.gqa_apply(p, cfg.replace(attn_impl="xla"), x)
    assert (mapped - plain).abs().max() < 2e-5
    mla_cfg = get_smoke_config("deepseek-v2-236b")
    mla = attention.mla_init(torch.Generator(), mla_cfg, torch.float32)
    assert isinstance(mla, attention.MLAAttention)
    xm = torch.zeros((1, 4, mla_cfg.d_model))
    assert attention.mla_apply(mla, mla_cfg, xm)[0].shape == xm.shape
    with pytest.raises(ValueError, match="cross-attention"):
        attention.mla_apply(mla, mla_cfg, xm, cross_kv=xm)


def test_kernel_impl_needs_a_card_or_interpret(model, monkeypatch):
    """attn_impl='pallas_*' without pallas_interpret launches the kernel:
    on CPU tensors that raises, and nothing falls back."""
    arch, _, params = model
    cfg = get_smoke_config(arch).replace(attn_impl="pallas_mapped",
                                         attn_block=16)
    toks = torch.from_numpy(_tokens(7, cfg.vocab_size))
    with pytest.raises(ValueError, match="CUDA tensors"):
        T.forward(params, cfg, toks)
