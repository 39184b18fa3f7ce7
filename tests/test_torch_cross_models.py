"""The port's cross-attention model families against the JAX package's, on
the CPU: ``vlm`` (llama-3.2-vision-11b: groups of self layers and one gated
cross-attention layer over stub vision states) and ``audio``
(whisper-medium: a bidirectional encoder over stub frames, a causal decoder
with cross-attention), at their smoke configs (fp32), with the reference's
parameters loaded through ``params_from_jax``.

At init every ``xattn_gate`` is 0 and every layer norm is weight 1, bias 0,
which would hide a wrong cross path, a wrong bias or a wrong GELU: the
reference tree is perturbed before both packages get it (gates near 0.5,
norm weights and biases moved by N(0, 0.2)).  The tri_attn impls run with
``pallas_interpret=True`` and block 16 on both sides."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

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
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import generate
from repro_torch.train.train_step import lm_loss

ARCHS = ["llama-3.2-vision-11b", "whisper-medium"]
IMPLS = ["xla", "pallas_mapped", "pallas_bb"]
TOL = 1e-4
#: parameters of the full configs (the reference's count of the same tree)
FULL_PARAMS = {"llama-3.2-vision-11b": 9_775_157_256,
               "whisper-medium": 817_053_696}
#: causal self-attention layers of each smoke config: the kernel's calls
#: per cache-less kernel forward (2 groups x 4 self layers; 2 decoder layers)
SMOKE_KERNEL_CALLS = {"llama-3.2-vision-11b": 8, "whisper-medium": 2}
MAX_NEW = 6


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, dtype=np.float32)


def _rng(seed):
    return np.random.default_rng(seed)


def _impl_kw(impl):
    return dict(attn_impl=impl, attn_block=16, pallas_interpret=True)


def _cfgs(arch, **kw):
    return ref_smoke(arch).replace(**kw), get_smoke_config(arch).replace(**kw)


def _extra_len(cfg):
    return cfg.vision_seq if cfg.family == "vlm" else cfg.encoder_seq


def perturb(tree, seed=0):
    """Every xattn_gate near 0.5, every norm weight and bias off 1 and 0."""
    r = _rng(seed)

    def f(path, a):
        a = np.asarray(a)
        name = path[-1].key
        if name == "xattn_gate":
            return (0.5 + 0.1 * r.standard_normal(a.shape)).astype(a.dtype)
        if name.startswith(("ln", "final_norm", "enc_norm")):
            return (a + 0.2 * r.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(f, tree)


@functools.lru_cache(maxsize=None)
def _build(arch):
    rcfg, cfg = _cfgs(arch)
    tree = perturb(jax.tree.map(np.asarray,
                                RT.init_params(jax.random.PRNGKey(0), rcfg)))
    params = params_from_jax(tree, cfg, "cpu")
    return arch, jax.tree.map(jnp.asarray, tree), params


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _build(request.param)


def _inputs(cfg, seed, batch=2, seq=32):
    r = _rng(seed)
    toks = r.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    extra = (r.standard_normal((batch, _extra_len(cfg), cfg.d_model))
             * 0.1).astype(np.float32)
    return toks, extra


# --- the shared layers -------------------------------------------------------


def test_layer_norm_matches_reference():
    r = _rng(0)
    x = (r.standard_normal((2, 5, 48)) * 3 + 1).astype(np.float32)
    w, b = (r.standard_normal(48).astype(np.float32) for _ in range(2))
    want = ref_common.layer_norm(*map(jnp.asarray, (x, w, b)))
    got = common.layer_norm(*map(torch.from_numpy, (x, w, b)))
    assert np.abs(_np(got) - _np(want)).max() < 1e-5


def test_gelu_mlp_is_the_tanh_gelu():
    """jax.nn.gelu's default is the tanh form; torch's erf default differs
    by more than the parity tolerance on these inputs."""
    r = _rng(1)
    x = (r.standard_normal((2, 7, 16)) * 2).astype(np.float32)
    up = (r.standard_normal((16, 40)) * 0.5).astype(np.float32)
    down = (r.standard_normal((40, 16)) * 0.5).astype(np.float32)
    want = RT._gelu_mlp({"up": jnp.asarray(up), "down": jnp.asarray(down)},
                        jnp.asarray(x))
    xt, ut, dt = map(torch.from_numpy, (x, up, down))
    got = common.gelu_mlp(xt, ut, dt)
    assert np.abs(_np(got) - _np(want)).max() < 1e-5
    erf = F.gelu(xt @ ut) @ dt
    assert np.abs(_np(erf) - _np(want)).max() > 10 * TOL


@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_attention_matches_reference(qk_norm):
    """gqa_apply(cross_kv=...): k and v from the cross states, no RoPE, no
    mask, no cache; never the kernel, whatever attn_impl says."""
    rcfg, cfg = _cfgs("llama-3.2-vision-11b", qk_norm=qk_norm,
                      **_impl_kw("pallas_mapped"))
    rp = ref_attn.gqa_init(jax.random.PRNGKey(3), rcfg, jnp.float32)
    if qk_norm:
        rp = {**rp, "q_norm": rp["q_norm"] + 0.3, "k_norm": rp["k_norm"] - 0.2}
    norms = {n: torch.from_numpy(np.array(rp[n]))
             for n in ("q_norm", "k_norm") if n in rp}
    p = attention.GQAAttention(*(torch.from_numpy(np.array(rp[n]))
                                 for n in ("wq", "wk", "wv", "wo")), **norms)
    r = _rng(4)
    x = (r.standard_normal((2, 32, cfg.d_model)) * 0.3).astype(np.float32)
    xs = (r.standard_normal((2, 20, cfg.d_model)) * 0.3).astype(np.float32)
    pos = np.broadcast_to(np.arange(32)[None] + 7, (2, 32)).copy()
    want, wc = ref_attn.gqa_apply(rp, rcfg, jnp.asarray(x),
                                  positions=jnp.asarray(pos),
                                  cross_kv=jnp.asarray(xs))
    got, gc = attention.gqa_apply(p, cfg, torch.from_numpy(x),
                                  positions=torch.from_numpy(pos),
                                  cross_kv=torch.from_numpy(xs))
    assert gc is None and wc is None
    assert np.abs(_np(got) - _np(want)).max() < TOL


# --- parameters --------------------------------------------------------------


def test_params_from_jax_keeps_every_weight(model):
    arch, tree, params = model
    assert common.count_params(params) == ref_common.count_params(tree)
    if arch == "whisper-medium":
        assert isinstance(params, T.WhisperLM)
        np.testing.assert_array_equal(
            params.dec_layers[1].xattn.wk.numpy(),
            np.asarray(tree["dec_layers"]["xattn"]["wk"][1]))
        np.testing.assert_array_equal(
            params.enc_layers[0].ln2_b.numpy(),
            np.asarray(tree["enc_layers"]["ln2_b"][0]))
    else:
        assert isinstance(params, T.VisionLM)
        g = tree["groups"]
        np.testing.assert_array_equal(
            params.groups[1].self_layers[2].attn.wq.numpy(),
            np.asarray(g["self"]["attn"]["wq"][1, 2]))
        np.testing.assert_array_equal(
            params.groups[1].cross.mlp.down.numpy(),
            np.asarray(g["cross"]["mlp"]["down"][1]))
        gate = params.groups[0].cross.xattn_gate
        assert gate.dtype == torch.float32 and gate.shape == ()
        assert float(gate) == float(g["cross"]["xattn_gate"][0]) != 0.0


def _ref_shapes(tree) -> dict:
    """name -> shape of one layer's slice, in the port's naming."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        keys = [p.key for p in path]
        if keys[0] == "groups":
            lead = 2 if keys[1] == "self" else 1
            part = "self_layers" if keys[1] == "self" else "cross"
            out[".".join([part, *keys[2:]])] = tuple(leaf.shape[lead:])
        elif keys[0] in ("enc_layers", "dec_layers"):
            out[".".join(keys)] = tuple(leaf.shape[1:])
        else:
            out[keys[0]] = tuple(leaf.shape)
    return out


def _port_shapes(params) -> dict:
    out = {}
    for name, p in params.named_parameters():
        parts = name.split(".")
        if parts[0] == "groups":
            drop = 4 if parts[2] == "self_layers" else 3
            key = ".".join([parts[2], *parts[drop:]])
        elif parts[0] in ("enc_layers", "dec_layers"):
            key = ".".join([parts[0], *parts[2:]])
        else:
            key = name
        out[key] = tuple(p.shape)
    return out


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_reference_shapes(arch, full):
    """Random init gives the reference's names, shapes and count: the smoke
    config on the CPU, the full config on the meta device."""
    cfg = get_config(arch) if full else get_smoke_config(arch)
    rcfg = ref_get_config(arch) if full else ref_smoke(arch)
    tree = jax.eval_shape(lambda: RT.init_params(jax.random.PRNGKey(0), rcfg))
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           "meta" if full else "cpu")
    assert _port_shapes(params) == _ref_shapes(tree)
    assert common.count_params(params) == ref_common.count_params(tree)
    if full:
        assert common.count_params(params) == FULL_PARAMS[arch]
        assert params.embed.dtype == torch.bfloat16
    else:
        assert all(not p.requires_grad for p in params.parameters())
    if arch == "llama-3.2-vision-11b":
        assert len(params.groups) == cfg.n_layers // cfg.cross_attn_every
        assert params.groups[0].cross.xattn_gate.dtype == torch.float32
        if not full:
            assert float(params.groups[0].cross.xattn_gate) == 0.0
    else:
        assert len(params.enc_layers) == cfg.encoder_layers
        assert len(params.dec_layers) == cfg.decoder_layers


# --- forward, lm_loss --------------------------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_matches_reference(model, impl):
    arch, tree, params = model
    rcfg, cfg = _cfgs(arch, **_impl_kw(impl))
    toks, extra = _inputs(cfg, 1)
    want = RT.forward(tree, rcfg, jnp.asarray(toks), jnp.asarray(extra))
    got = params(torch.from_numpy(toks), torch.from_numpy(extra)) \
        if impl == "xla" else T.forward(params, cfg, torch.from_numpy(toks),
                                        torch.from_numpy(extra))
    assert got.dtype == torch.float32
    assert got.shape == (2, 32, cfg.padded_vocab)
    assert np.abs(_np(got) - _np(want)).max() < TOL


@pytest.mark.parametrize("impl", IMPLS)
def test_lm_loss_matches_reference(model, impl):
    arch, tree, params = model
    rcfg, cfg = _cfgs(arch, **_impl_kw(impl))
    toks, extra = _inputs(cfg, 2)
    labels = np.roll(toks, -1, axis=1)
    rbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
              "extra": jnp.asarray(extra)}
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels),
             "extra": torch.from_numpy(extra)}
    want, wm = ref_lm_loss(tree, rcfg, rbatch)
    got, gm = lm_loss(params, cfg, batch)
    assert abs(float(got) - float(want)) < TOL
    for key in ("ce", "z_loss", "moe_aux"):
        assert abs(float(gm[key]) - float(wm[key])) < TOL


def test_kernel_runs_in_every_causal_self_layer(model, monkeypatch):
    """A cache-less kernel forward calls tri_attn once per causal
    self-attention layer and never from a cross layer or the encoder; at a
    length that is not a multiple of the block, never."""
    arch, _, params = model
    cfg = get_smoke_config(arch).replace(**_impl_kw("pallas_mapped"))
    real, seen = attn_ops.causal_attention, []

    def counting(q, k, v, *args, **kw):
        seen.append(tuple(q.shape))
        return real(q, k, v, *args, **kw)

    monkeypatch.setattr(attn_ops, "causal_attention", counting)
    toks, extra = _inputs(cfg, 3)
    T.forward(params, cfg, torch.from_numpy(toks), torch.from_numpy(extra))
    assert len(seen) == SMOKE_KERNEL_CALLS[arch]
    assert set(seen) == {(2, cfg.n_heads, 32, cfg.head_dim)}
    seen.clear()
    T.forward(params, cfg, torch.from_numpy(toks[:, :24]),
              torch.from_numpy(extra))
    assert seen == []


def test_cross_path_and_norms_move_the_logits(model):
    """The perturbed gates and norms are live: zeroing the gates (vlm) or
    the frames (whisper) changes the logits far beyond the tolerance."""
    arch, tree, params = model
    rcfg, cfg = _cfgs(arch)
    toks, extra = _inputs(cfg, 4)
    base = T.forward(params, cfg, torch.from_numpy(toks),
                     torch.from_numpy(extra))
    if arch == "llama-3.2-vision-11b":
        gates = [g.cross.xattn_gate for g in params.groups]
        saved = [float(g) for g in gates]
        try:
            for g in gates:
                g.data.zero_()
            other = T.forward(params, cfg, torch.from_numpy(toks),
                              torch.from_numpy(extra))
        finally:
            for g, v in zip(gates, saved):
                g.data.fill_(v)
    else:
        other = T.forward(params, cfg, torch.from_numpy(toks),
                          torch.from_numpy(extra * 0))
    assert (base - other).abs().max() > 100 * TOL


# --- prefill, decode ---------------------------------------------------------


def test_prefill_matches_reference_with_caches(model):
    arch, tree, params = model
    rcfg, cfg = _cfgs(arch)
    toks, extra = _inputs(cfg, 5)
    want, rc = RT.prefill(tree, rcfg, jnp.asarray(toks), jnp.asarray(extra))
    got, c = T.prefill(params, cfg, torch.from_numpy(toks),
                       torch.from_numpy(extra))
    assert np.abs(_np(got) - _np(want)).max() < TOL
    if arch == "llama-3.2-vision-11b":
        n_groups = cfg.n_layers // cfg.cross_attn_every
        assert len(c["layers"]) == n_groups
        for g in range(n_groups):
            selfs = c["layers"][g]["self"]
            assert len(selfs) == cfg.cross_attn_every - 1
            for i, lc in enumerate(selfs):
                assert lc["idx"] == 32
                for key in ("k", "v"):
                    ref = rc["layers"]["self"][key][g, i]
                    assert np.abs(_np(lc[key]) - _np(ref)).max() < TOL
    else:
        for i, lc in enumerate(c["layers"]):
            assert lc["idx"] == 32
            for key in ("k", "v"):
                ref = rc["layers"][key][i]
                assert np.abs(_np(lc[key]) - _np(ref)).max() < TOL
        for key in ("k", "v"):
            assert tuple(c["cross"][key].shape) == (
                cfg.decoder_layers, 2, cfg.encoder_seq, cfg.n_kv_heads,
                cfg.head_dim)
            assert np.abs(_np(c["cross"][key])
                          - _np(rc["cross"][key])).max() < TOL


def test_decode_steps_match_reference(model):
    """Four decode steps, each fed the reference's argmax."""
    arch, tree, params = model
    rcfg, cfg = _cfgs(arch)
    toks, extra = _inputs(cfg, 6)
    rx, x = jnp.asarray(extra), torch.from_numpy(extra)
    wl, rc = RT.prefill(tree, rcfg, jnp.asarray(toks), rx)
    _, c = T.prefill(params, cfg, torch.from_numpy(toks), x)
    tok = np.asarray(jnp.argmax(wl[:, -1:], -1)).astype(np.int32)
    for _ in range(4):
        wd, rc = RT.decode_step(tree, rcfg, jnp.asarray(tok), rc, rx)
        gd, c = T.decode_step(params, cfg, torch.from_numpy(tok), c, x)
        assert np.abs(_np(gd) - _np(wd)).max() < TOL
        tok = np.asarray(jnp.argmax(wd, -1)).astype(np.int32)
    idx = (c["layers"][0]["self"][0]["idx"] if cfg.family == "vlm"
           else c["layers"][0]["idx"])
    assert idx == 36


def test_audio_decode_reads_the_cross_cache():
    """Whisper's decode steps read cache["cross"], projected once at
    prefill: it equals a fresh projection of the encoder states, and the
    steps ignore ``extra``."""
    arch, _, params = _build("whisper-medium")
    cfg = get_smoke_config(arch)
    toks, extra = _inputs(cfg, 7)
    x = torch.from_numpy(extra)
    _, c = T.prefill(params, cfg, torch.from_numpy(toks), x)
    enc = T._whisper_encode(params, cfg, x)
    lp = params.dec_layers[1]
    fresh = (enc @ lp.xattn.wk.reshape(cfg.d_model, -1)).view(
        2, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim)
    assert torch.allclose(c["cross"]["k"][1], fresh, atol=1e-6)
    tok = torch.zeros((2, 1), dtype=torch.int64)
    c2 = {"layers": [{**lc, "k": lc["k"].clone(), "v": lc["v"].clone()}
                     for lc in c["layers"]], "cross": c["cross"]}
    a, _ = T.decode_step(params, cfg, tok, c)
    b, _ = T.decode_step(params, cfg, tok, c2, x * 5)
    assert torch.equal(a, b)


def test_init_cache_sizes_the_cross_cache():
    cfg = get_smoke_config("whisper-medium")
    c = T.init_cache(cfg, 3, 40, extra_len=17, device="cpu")
    assert len(c["layers"]) == cfg.decoder_layers
    assert c["layers"][0]["k"].shape == (3, 40, cfg.n_kv_heads, cfg.head_dim)
    assert c["cross"]["k"].shape == (cfg.decoder_layers, 3, 17,
                                     cfg.n_kv_heads, cfg.head_dim)
    vcfg = get_smoke_config("llama-3.2-vision-11b")
    v = T.init_cache(vcfg, 2, 16, device="cpu")
    assert len(v["layers"]) == 2 and len(v["layers"][0]["self"]) == 4
    assert "cross" not in v


# --- the engine and the LM demo ----------------------------------------------


@pytest.mark.parametrize("batch,seed", [(1, 11), (3, 12)])
def test_greedy_tokens_match_reference(model, batch, seed):
    arch, tree, params = model
    rcfg, cfg = _cfgs(arch, max_seq=16 + MAX_NEW)
    toks, extra = _inputs(cfg, seed, batch=batch, seq=16)
    want = ref_generate(tree, rcfg, jnp.asarray(toks), MAX_NEW,
                        extra=jnp.asarray(extra))
    got = generate(params, cfg, torch.from_numpy(toks), MAX_NEW,
                   extra=torch.from_numpy(extra))
    assert got.steps == want.steps == MAX_NEW
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_demo_runs_on_the_cpu(arch, capsys):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "16", "--max-new", "4"])
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "device=cpu" in out
    assert "generated 4 steps x 2 seqs" in out
