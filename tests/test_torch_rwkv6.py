"""The port's RWKV-6 path (repro_torch.models.rwkv6, the ``ssm`` family of
models.transformer, train.train_step) against the JAX package's, on the
CPU.  The time and channel mixes run at tests/test_models.py's
SimpleNamespace config; the model at the rwkv6-3b smoke config (3 layers,
d 64, 4 heads, fp32) with the reference's weights through
``params_from_jax``.  The reference computes its chunked form in plain jnp;
the port runs the wkv kernel's plain version (``pallas_interpret=True``).
Inputs are made by numpy from a seed."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke
from repro.models import common as ref_common
from repro.models import rwkv6 as ref_rwkv
from repro.models import transformer as RT
from repro.train.train_step import (
    TrainConfig as RefTrainConfig, lm_loss as ref_lm_loss,
    make_eval_step as ref_make_eval_step,
)
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.wkv import kernel as wkv_kernel
from repro_torch.models import common, rwkv6
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.train.train_step import TrainConfig, lm_loss, make_eval_step

ARCH = "rwkv6-3b"
TOL = 1e-4
#: The whole smoke model's logits, relative to their max |logit|.  Against a
#: float64 evaluation of the same math the reference's chunked logits lie
#: 5.5e-5 of the max away and the port's 8.8e-5; layer 0's fp32 output
#: alone (1e-6 off), carried on in float64, already lands 1.9e-4 (reference)
#: and 2.9e-4 (port) from it: the per-head group norm divides by a head's
#: rms of o, 0.008 at one position of layer 1, so fp32 rounding grows about
#: 200x by the logits.  The bound sits between the packages' measured
#: difference (3.2e-5) and the sum of their float64 distances (1.4e-4);
#: ``test_forward_bound_catches_a_decay_fault`` holds that it still fails a
#: 1e-3 shift of layer 0's ``decay_base``.
FWD_REL = 1e-4
#: tests/test_models.py:199
MIX_CFG = dict(d_model=64, rwkv_heads=4, rwkv_decay_lora=16, d_ff=128)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, dtype=np.float32)


def _rng(seed):
    return np.random.default_rng(seed)


def _mix_inputs(seed, b=2, s=128):
    r = _rng(seed)
    d, h = MIX_CFG["d_model"], MIX_CFG["rwkv_heads"]
    hd = d // h
    x = (r.standard_normal((b, s, d)) * 0.5).astype(np.float32)
    x_prev = (r.standard_normal((b, d)) * 0.5).astype(np.float32)
    state = (r.standard_normal((b, h, hd, hd)) * 0.1).astype(np.float32)
    return x, x_prev, state


@pytest.fixture(scope="module")
def mixes():
    rcfg = SimpleNamespace(**MIX_CFG)
    cfg = SimpleNamespace(**MIX_CFG, pallas_interpret=True)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    rt = ref_rwkv.rwkv_block_init(k1, rcfg, jnp.float32)
    rc = ref_rwkv.rwkv_cmix_init(k2, rcfg, jnp.float32)

    def t(a):
        return torch.from_numpy(np.array(a))

    tm = rwkv6.RWKVTimeMix(**{n: t(rt[n]) for n in rwkv6.TMIX_NAMES})
    cm = rwkv6.RWKVChannelMix(**{n: t(rc[n]) for n in rwkv6.CMIX_NAMES})
    return rcfg, cfg, rt, rc, tm, cm


def _close(got, want, tol=TOL):
    for g, w in zip(got, want):
        assert g.shape == tuple(w.shape)
        assert np.abs(_np(g) - _np(w)).max() < tol


@pytest.mark.parametrize("chunk", [32, 64])
def test_mix_chunked_matches_reference(mixes, chunk):
    rcfg, cfg, rt, _, tm, _ = mixes
    x, xp, st = _mix_inputs(1)
    want = ref_rwkv.rwkv_mix_chunked(rt, rcfg, jnp.asarray(x),
                                     jnp.asarray(xp), jnp.asarray(st),
                                     chunk=chunk)
    got = rwkv6.rwkv_mix_chunked(tm, cfg, torch.from_numpy(x),
                                 torch.from_numpy(xp), torch.from_numpy(st),
                                 chunk=chunk)
    _close(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mix_chunked_hands_wkv_its_projections_uncast(mixes, monkeypatch,
                                                       dtype):
    """The chunked time mix hands the wkv op r, k, v in the model's dtype,
    as the projections come (bf16 for rwkv6-3b), w fp32, and asks for o in
    fp32, as the reference computes it; since bf16 -> fp32 is exact, the
    result is the one from r, k, v cast first, bit for bit."""
    _, cfg, _, _, tm, _ = mixes
    keep = {"decay_base", "bonus_u"}        # fp32 in every config
    p = rwkv6.RWKVTimeMix(**{n: getattr(tm, n).detach().to(
        torch.float32 if n in keep else dtype) for n in rwkv6.TMIX_NAMES})
    x, xp, st = (torch.from_numpy(a) for a in _mix_inputs(9))
    x = x.to(dtype)
    seen = []
    real = rwkv6.wkv_ops.wkv_chunked

    def spy(r, k, v, w, u, state, chunk=64, interpret=False, out_dtype=None):
        seen.append((r.dtype, k.dtype, v.dtype, w.dtype, out_dtype))
        return real(r, k, v, w, u, state, chunk, interpret, out_dtype)

    monkeypatch.setattr(rwkv6.wkv_ops, "wkv_chunked", spy)
    out, _, state = rwkv6.rwkv_mix_chunked(p, cfg, x, xp, st, chunk=32)
    assert seen == [(dtype, dtype, dtype, torch.float32, torch.float32)]
    rh, kh, vh, wh, g = rwkv6._heads(p, cfg, x, xp)
    assert rh.dtype == torch.float32
    o, s_f = real(rh, kh, vh, wh, p.bonus_u, st, chunk=32, interpret=True)
    assert torch.equal(out, rwkv6._gate_out(p, x, o, g))
    assert torch.equal(state, s_f)


@pytest.mark.parametrize("s", [1, 40, 128])
def test_mix_scan_matches_reference(mixes, s):
    rcfg, cfg, rt, _, tm, _ = mixes
    x, xp, st = _mix_inputs(2, s=s)
    want = ref_rwkv.rwkv_mix_scan(rt, rcfg, jnp.asarray(x), jnp.asarray(xp),
                                  jnp.asarray(st))
    got = rwkv6.rwkv_mix_scan(tm, cfg, torch.from_numpy(x),
                              torch.from_numpy(xp), torch.from_numpy(st))
    _close(got, want)


def test_mix_chunked_equals_scan(mixes):
    """tests/test_models.py:199's equivalence, on the port's side."""
    _, cfg, _, _, tm, _ = mixes
    x, xp, st = (torch.from_numpy(a) for a in _mix_inputs(3))
    o1, x1, s1 = rwkv6.rwkv_mix_scan(tm, cfg, x, xp, st)
    o2, x2, s2 = rwkv6.rwkv_mix_chunked(tm, cfg, x, xp, st, chunk=32)
    assert (o1 - o2).abs().max() < 1e-5
    assert torch.equal(x1, x2)
    assert (s1 - s2).abs().max() < TOL


@pytest.mark.parametrize("s", [1, 64])
def test_cmix_matches_reference(mixes, s):
    rcfg, _, _, rc, _, cm = mixes
    x, xp, _ = _mix_inputs(4, s=s)
    want = ref_rwkv.rwkv_cmix_apply(rc, rcfg, jnp.asarray(x),
                                    jnp.asarray(xp))
    got = rwkv6.rwkv_cmix_apply(cm, rcfg, torch.from_numpy(x),
                                torch.from_numpy(xp))
    _close(got, want)


def test_token_shift_carries_fp32_state_into_bf16():
    x = torch.randn((2, 5, 8), generator=torch.Generator().manual_seed(0)) \
        .to(torch.bfloat16)
    prev = torch.full((2, 8), 1.0 / 3.0)
    xs = rwkv6._token_shift(x, prev)
    assert xs.dtype == torch.bfloat16
    assert torch.equal(xs[:, 0], prev.to(torch.bfloat16))
    assert torch.equal(xs[:, 1:], x[:, :-1])


# --- the rwkv6-3b smoke model --------------------------------------------------


@pytest.fixture(scope="module")
def model():
    rcfg = ref_smoke(ARCH)
    rparams = RT.init_params(jax.random.PRNGKey(0), rcfg)
    params = params_from_jax(jax.tree.map(np.asarray, rparams),
                             get_smoke_config(ARCH), "cpu")
    return rcfg, rparams, params


def _cfg(**kw):
    return get_smoke_config(ARCH).replace(pallas_interpret=True, **kw)


def _tokens(seed, vocab, shape):
    return _rng(seed).integers(0, vocab, shape).astype(np.int32)


def test_params_from_jax_keeps_every_weight(model):
    _, rparams, params = model
    assert isinstance(params, T.RWKVLM)
    assert common.count_params(params) == ref_common.count_params(rparams)
    rl = rparams["layers"]
    for i, layer in enumerate(params.layers):
        for n in rwkv6.TMIX_NAMES:
            np.testing.assert_array_equal(getattr(layer.tmix, n).numpy(),
                                          np.asarray(rl["tmix"][n][i]))
        for n in rwkv6.CMIX_NAMES:
            np.testing.assert_array_equal(getattr(layer.cmix, n).numpy(),
                                          np.asarray(rl["cmix"][n][i]))
        np.testing.assert_array_equal(layer.ln1.numpy(),
                                      np.asarray(rl["ln1"][i]))
    np.testing.assert_array_equal(params.lm_head.numpy(),
                                  np.asarray(rparams["lm_head"]))


def _ref_shapes(tree) -> dict:
    """name -> shape of one layer's slice, in the port's naming."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        keys = [p.key for p in path]
        if keys[0] == "layers":
            out[".".join(keys[1:])] = tuple(leaf.shape[1:])
        else:
            out[keys[0]] = tuple(leaf.shape)
    return out


def _port_shapes(params) -> dict:
    out = {}
    for name, p in params.named_parameters():
        parts = name.split(".")
        key = ".".join(parts[2:]) if parts[0] == "layers" else name
        out[key] = tuple(p.shape)
    return out


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
def test_init_params_matches_reference_shapes(full):
    """Random init gives the reference's names, shapes, dtypes and count:
    the smoke config on the CPU, rwkv6-3b at full width on the meta device
    (3,073,313,280 parameters)."""
    cfg = get_config(ARCH) if full else get_smoke_config(ARCH)
    rcfg = ref_get_config(ARCH) if full else ref_smoke(ARCH)
    tree = jax.eval_shape(lambda: RT.init_params(jax.random.PRNGKey(0),
                                                 rcfg))
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           "meta" if full else "cpu")
    assert isinstance(params, T.RWKVLM) and len(params.layers) == cfg.n_layers
    assert _port_shapes(params) == _ref_shapes(tree)
    assert common.count_params(params) == ref_common.count_params(tree)
    if full:
        assert common.count_params(params) == 3_073_313_280
        assert params.layers[0].tmix.wr.dtype == torch.bfloat16
        assert params.layers[0].tmix.decay_base.dtype == torch.float32
    else:
        assert all(not p.requires_grad for p in params.parameters())
        tm = params.layers[0].tmix
        assert torch.equal(tm.decay_base, torch.full_like(tm.decay_base,
                                                          -6.0))
        assert tm.wd2.std().item() == pytest.approx(
            0.01 * 0.8796, rel=0.1)   # truncated N(0, 1) on [-2, 2]


@pytest.mark.parametrize("s", [64, 40], ids=["chunked", "scan"])
def test_forward_matches_reference(model, s):
    rcfg, rparams, params = model
    cfg = _cfg()
    toks = _tokens(1, cfg.vocab_size, (2, s))
    want = RT.forward(rparams, rcfg, jnp.asarray(toks))
    got = params(torch.from_numpy(toks)) if s % 64 else \
        T.forward(params, cfg, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (2, s,
                                                        cfg.padded_vocab)
    assert _fwd_rel(got, want) < FWD_REL


def _fwd_rel(got, want) -> float:
    return float(np.abs(_np(got) - _np(want)).max() / np.abs(_np(want)).max())


def _rms64(x, w, eps=1e-6):
    return x / np.sqrt((x * x).mean(-1, keepdims=True) + eps) * w


def _layer64(lp: dict, x):
    """One RWKV-6 layer in float64 numpy (the recurrence step by step),
    from a zero state: the same math as both packages."""
    tp, cp = lp["tmix"], lp["cmix"]
    b, s, d = x.shape
    h, hd = tp["bonus_u"].shape

    def shifted(t):
        return np.concatenate([np.zeros_like(t[:, :1]), t[:, :-1]], 1)

    n1 = _rms64(x, lp["ln1"])
    xs = shifted(n1)

    def mix(m):
        return n1 * m + xs * (1 - m)

    r, k, v, g = (mix(tp[f"mix_{c}"]) @ tp[f"w{c}"] for c in "rkvg")
    w = np.exp(-np.exp(tp["decay_base"]
                       + np.tanh(mix(tp["mix_w"]) @ tp["wd1"]) @ tp["wd2"]))
    rh, kh, vh, wh = (t.reshape(b, s, h, hd) for t in (r, k, v, w))
    state = np.zeros((b, h, hd, hd))
    o = np.empty_like(rh)
    for t in range(s):
        o[:, t] = np.einsum("bhk,bhkv->bhv", rh[:, t], state) + (
            rh[:, t] * tp["bonus_u"] * kh[:, t]).sum(-1, keepdims=True) \
            * vh[:, t]
        state = wh[:, t][..., None] * state \
            + kh[:, t][..., None] * vh[:, t][..., None, :]
    o = _rms64(o, np.ones(hd)).reshape(b, s, d) * tp["ln_x"]
    x = x + (o * g / (1 + np.exp(-g))) @ tp["wo"]
    n2 = _rms64(x, lp["ln2"])
    xs = shifted(n2)
    xk = n2 * cp["mix_k"] + xs * (1 - cp["mix_k"])
    xr = n2 * cp["mix_r"] + xs * (1 - cp["mix_r"])
    kk = np.square(np.maximum(xk @ cp["wk"], 0))
    return x + (kk @ cp["wv"]) / (1 + np.exp(-(xr @ cp["wr"])))


def test_forward_float64_distances(model):
    """What ``FWD_REL`` rests on: against a float64 evaluation of the same
    math, the reference's and the port's chunked logits each lie within
    1.5e-4 of the max, and layer 0's fp32 output alone (each package's),
    carried through the other layers in float64, already lands more than
    ``TOL`` (the old absolute bound) from it: the model, not a departure,
    grows layer 0's rounding (about 1e-6) past that bound."""
    rcfg, rparams, params = model
    cfg = _cfg()
    toks = _tokens(1, cfg.vocab_size, (2, 64))
    p64 = jax.tree.map(lambda a: np.asarray(a, np.float64), rparams)
    layers = [jax.tree.map(lambda a: a[i], p64["layers"])
              for i in range(rcfg.n_layers)]

    def head(x):
        return _rms64(x, p64["final_norm"]) @ p64["lm_head"]

    x = p64["embed"][toks]
    for lp in layers:
        x = _layer64(lp, x)
    exact = head(x)
    scale = np.abs(exact).max()
    ref_logits = np.asarray(RT.forward(rparams, rcfg, jnp.asarray(toks)),
                            np.float64)
    port_logits = T.forward(params, cfg, torch.from_numpy(toks)) \
        .double().numpy()
    for got in (ref_logits, port_logits):
        assert np.abs(got - exact).max() / scale < 1.5e-4
    # layer 0 in fp32 by each package, the rest in float64
    ref_x0, _ = RT._rwkv_layer_apply(
        jax.tree.map(lambda a: a[0], rparams["layers"]), rcfg,
        jnp.take(rparams["embed"], jnp.asarray(toks), axis=0),
        RT._rwkv_zero_state(rcfg, 2))
    with torch.no_grad():
        port_x0, _ = T._rwkv_layer_apply(
            params.layers[0], cfg, T._embed(params, cfg,
                                            torch.from_numpy(toks).long()),
            T._rwkv_zero_state(cfg, 2, "cpu"))
    for x0 in (np.asarray(ref_x0, np.float64), port_x0.double().numpy()):
        assert np.abs(x0 - _layer64(layers[0], p64["embed"][toks])).max() \
            < 2e-6
        x = x0
        for lp in layers[1:]:
            x = _layer64(lp, x)
        assert np.abs(head(x) - exact).max() > TOL


def test_forward_bound_catches_a_decay_fault(model):
    """The control of ``FWD_REL``: layer 0's ``decay_base`` moved by 1e-3
    (w = exp(-exp(-6)) moves by 2.5e-6 a step) must fail the bound that
    the clean port passes."""
    rcfg, rparams, _ = model
    cfg = _cfg()
    params = params_from_jax(jax.tree.map(np.asarray, rparams),
                             get_smoke_config(ARCH), "cpu")
    with torch.no_grad():
        params.layers[0].tmix.decay_base.add_(1e-3)
    toks = _tokens(1, cfg.vocab_size, (2, 64))
    want = RT.forward(rparams, rcfg, jnp.asarray(toks))
    got = T.forward(params, cfg, torch.from_numpy(toks))
    assert _fwd_rel(got, want) > FWD_REL


def test_lm_loss_and_eval_step_match_reference(model):
    rcfg, rparams, params = model
    cfg = _cfg()
    toks = _tokens(2, cfg.vocab_size, (2, 64))
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


@pytest.mark.parametrize("s", [64, 40], ids=["chunked", "scan"])
def test_prefill_decode_match_reference(model, s):
    """prefill, then two decode steps: logits and every state leaf of every
    layer."""
    rcfg, rparams, params = model
    cfg = _cfg()
    toks = _tokens(5, cfg.vocab_size, (2, s))
    wpre, rcache = RT.prefill(rparams, rcfg, jnp.asarray(toks))
    gpre, cache = T.prefill(params, cfg, torch.from_numpy(toks))
    assert np.abs(_np(gpre) - _np(wpre)).max() < TOL
    for step in range(2):
        for i, layer in enumerate(cache["layers"]):
            assert set(layer) == {"tmix_x", "cmix_x", "wkv"}
            for key, leaf in layer.items():
                assert leaf.dtype == torch.float32
                want = rcache["layers"][key][i]
                assert np.abs(_np(leaf) - _np(want)).max() < TOL, (step, i,
                                                                   key)
        nt = np.asarray(jnp.argmax(wpre[:, -1:, :cfg.vocab_size],
                                   axis=-1)).astype(np.int32)
        wpre, rcache = RT.decode_step(rparams, rcfg, jnp.asarray(nt), rcache)
        gpre, cache = T.decode_step(params, cfg, torch.from_numpy(nt), cache)
        assert np.abs(_np(gpre) - _np(wpre)).max() < TOL


def test_decode_equals_forward_over_prompt_and_token(model):
    """The state after prefill carries the whole prompt: decoding one token
    gives a forward's last logits over prompt + token."""
    _, _, params = model
    cfg = _cfg()
    toks = torch.from_numpy(_tokens(6, cfg.vocab_size, (2, 64)))
    pre, cache = T.prefill(params, cfg, toks)
    nt = pre[:, -1:, :cfg.vocab_size].argmax(-1)
    dec, _ = T.decode_step(params, cfg, nt, cache)
    full = T.forward(params, cfg, torch.cat([toks, nt], dim=1))
    assert (dec[:, 0] - full[:, -1]).abs().max() < TOL


def test_init_cache_is_the_zero_state():
    cfg = _cfg()
    cache = T.init_cache(cfg, 3, 99, device="cpu")
    hd = cfg.d_model // cfg.rwkv_heads
    assert len(cache["layers"]) == cfg.n_layers
    for layer in cache["layers"]:
        assert layer["tmix_x"].shape == layer["cmix_x"].shape \
            == (3, cfg.d_model)
        assert layer["wkv"].shape == (3, cfg.rwkv_heads, hd, hd)
        assert all(not t.any() for t in layer.values())


def test_gradients_flow_through_the_wkv_op(model):
    """With a weight that asks for a gradient, the chunked path's gradient
    (through the wkv autograd.Function's plain backward) equals the scan
    path's on the same 64 tokens."""
    _, _, params = model
    cfg = _cfg()
    toks = torch.from_numpy(_tokens(7, cfg.vocab_size, (2, 64)))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    wr = params.layers[0].tmix.wr
    grads = {}
    real = rwkv6.rwkv_mix_chunked
    try:
        wr.requires_grad_(True)
        loss, _ = lm_loss(params, cfg, batch)
        (grads["chunked"],) = torch.autograd.grad(loss, [wr])
        rwkv6.rwkv_mix_chunked = \
            lambda p, c, x, xp, st, chunk=64: rwkv6.rwkv_mix_scan(p, c, x,
                                                                  xp, st)
        loss, _ = lm_loss(params, cfg, batch)
        (grads["scan"],) = torch.autograd.grad(loss, [wr])
    finally:
        rwkv6.rwkv_mix_chunked = real
        wr.requires_grad_(False)
    assert torch.isfinite(grads["chunked"]).all()
    assert grads["chunked"].abs().max() > 0
    assert (grads["chunked"] - grads["scan"]).abs().max() \
        < 1e-5 * float(grads["scan"].abs().max())


def test_kernel_path_needs_a_card_or_interpret(model):
    """Without pallas_interpret the chunked path launches the kernel: on
    CPU tensors that raises, and nothing falls back.  The scan path (a
    sequence that is not a multiple of 64) never reaches it."""
    _, _, params = model
    cfg = get_smoke_config(ARCH)
    with pytest.raises(ValueError, match="CUDA tensors"):
        T.forward(params, cfg, torch.from_numpy(_tokens(8, 256, (1, 64))))
    before = wkv_kernel.WKV_LAUNCHES
    out = T.forward(params, cfg, torch.from_numpy(_tokens(8, 256, (1, 40))))
    assert out.shape == (1, 40, cfg.padded_vocab)
    assert wkv_kernel.WKV_LAUNCHES == before
