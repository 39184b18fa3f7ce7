"""The port's ``moe`` family (repro_torch.models.moe, moonshot-v1-16b-a3b)
against the JAX package's, on the CPU: ``moe_apply`` in its global and
grouped dispatch, with and without capacity drops, and the whole smoke model
(fp32) with the reference's parameters loaded through ``params_from_jax``.

At init every norm weight is 1, which would hide a wrong norm: the reference
tree is perturbed before both packages get it.  The tri_attn impls run with
``pallas_interpret=True`` and block 16 on both sides.  Routing (each token's
top-k experts, each assignment's slot or its drop) is held equal to the
reference's before any output is compared."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke
from repro.models import common as ref_common
from repro.models import moe as ref_moe
from repro.models import transformer as RT
from repro.serving.engine import generate as ref_generate
from repro.train.train_step import lm_loss as ref_lm_loss
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.tri_attn import ops as attn_ops
from repro_torch.launch import serve
from repro_torch.models import common, moe
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import generate
from repro_torch.train.train_step import lm_loss

ARCH = "moonshot-v1-16b-a3b"
IMPLS = ["xla", "pallas_mapped", "pallas_bb"]
TOL = 1e-4
#: the full config's parameters (the reference's count of the same tree)
FULL_PARAMS = 28_888_467_456
SEQ = 64                       # a multiple of the kernel's block 16
MAX_NEW = 6


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
    """Every norm weight moved off 1 by N(0, 0.2)."""
    r = _rng(seed)

    def f(path, a):
        a = np.asarray(a)
        if path[-1].key.startswith(("ln", "final_norm")):
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


# --- moe_apply ---------------------------------------------------------------


def _ref_routing(p, cfg, x, g):
    """The reference's routing, step for step (``moe.py:161-193``): top-k
    ids (G, Tg, k) and each assignment's slot, E·cap where dropped, in token
    order (G, Tg·k)."""
    e, k = cfg.n_experts, cfg.moe_top_k
    toks = x.reshape(g, -1, x.shape[-1])
    tg = toks.shape[1]
    cap = ref_moe.capacity_for(tg, cfg)
    probs = jax.nn.softmax(jnp.einsum("gtd,de->gte", toks, p["router"]), -1)
    _, top_e = jax.lax.top_k(probs, k)
    flat_e = top_e.reshape(g, tg * k)
    order = jnp.argsort(flat_e, axis=1, stable=True)
    se = jnp.take_along_axis(flat_e, order, axis=1)
    counts = jax.vmap(lambda ee: jnp.bincount(ee, length=e))(se)
    start = jnp.cumsum(counts, axis=1) - counts
    pos = jnp.arange(tg * k)[None, :] - jnp.take_along_axis(start, se, 1)
    slot = jnp.where(pos < cap, se * cap + pos, e * cap)
    slot_tok = jax.vmap(lambda o, s: jnp.zeros_like(s).at[o].set(s))(order,
                                                                     slot)
    return np.asarray(top_e), np.asarray(slot_tok), cap


def _layer0_moe(model):
    tree, params = model
    rp = jax.tree.map(lambda a: a[0], tree["layers"]["moe"])
    return rp, params.layers[0].moe


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5],
                         ids=["cf1.25", "cf0.5-drops"])
@pytest.mark.parametrize("dispatch", ["global", "grouped2", "grouped1"])
def test_moe_apply_matches_reference(model, dispatch, capacity_factor):
    kw = {"global": {}, "grouped2": {"moe_groups": 2},
          "grouped1": {"moe_impl": "grouped"}}[dispatch]
    rcfg, cfg = _cfgs(capacity_factor=capacity_factor, **kw)
    rp, p = _layer0_moe(model)
    x = (_rng(1).standard_normal((4, 32, cfg.d_model)) * 0.5) \
        .astype(np.float32)
    with moe.record_routing() as rec:
        got, gaux = moe.moe_apply(p, cfg, torch.from_numpy(x), with_aux=True)
    want, waux = ref_moe.moe_apply(rp, rcfg, jnp.asarray(x), with_aux=True)
    g = cfg.moe_groups
    top_e, slot, cap = _ref_routing(rp, rcfg, jnp.asarray(x), g)
    (r,) = rec
    assert r["cap"] == cap
    np.testing.assert_array_equal(r["top_e"].numpy(), top_e)
    np.testing.assert_array_equal(r["slot"].numpy(), slot)
    np.testing.assert_array_equal(r["keep"].numpy(),
                                  slot < cfg.n_experts * cap)
    drops = int((~r["keep"]).sum())
    assert (drops > 0) == (capacity_factor < 1)
    assert np.abs(_np(got) - _np(want)).max() < TOL
    assert abs(float(gaux) - float(waux)) < TOL


def test_moe_a2a_without_a_mesh_is_global(model):
    """moe_impl "a2a" with no mesh falls through, as in the reference."""
    rp, p = _layer0_moe(model)
    rcfg, cfg = _cfgs(moe_impl="a2a")
    x = (_rng(2).standard_normal((2, 16, cfg.d_model)) * 0.5) \
        .astype(np.float32)
    want = ref_moe.moe_apply(rp, rcfg, jnp.asarray(x))
    got = moe.moe_apply(p, cfg, torch.from_numpy(x))
    base = moe.moe_apply(p, get_smoke_config(ARCH), torch.from_numpy(x))
    assert torch.equal(got, base)
    assert np.abs(_np(got) - _np(want)).max() < TOL


@pytest.mark.parametrize("n_tokens", [1, 4, 64, 2052, 4096])
def test_capacity_for_matches_reference(n_tokens):
    for arch_cfg in (get_smoke_config(ARCH), get_config(ARCH)):
        for cf in (0.5, 1.25, 16.0):
            cfg = arch_cfg.replace(capacity_factor=cf)
            assert moe.capacity_for(n_tokens, cfg) == \
                ref_moe.capacity_for(n_tokens, cfg)


def test_dropped_assignments_add_zero(model):
    """At a capacity that drops, each token's output is its kept
    assignments' weighted experts (plus the shared experts): equal to the
    no-drop output with the dropped assignments' weights set to 0."""
    _, p = _layer0_moe(model)
    cfg = get_smoke_config(ARCH).replace(capacity_factor=0.5)
    x = torch.from_numpy((_rng(3).standard_normal((2, 32, cfg.d_model))
                          * 0.5).astype(np.float32))
    with moe.record_routing() as rec:
        out = moe.moe_apply(p, cfg, x)
    keep = rec[0]["keep"].reshape(64, cfg.moe_top_k)
    assert not bool(keep.all())
    toks = x.reshape(-1, cfg.d_model)
    probs = torch.softmax(toks @ p.router, -1)
    w, e = torch.topk(probs, cfg.moe_top_k, -1)
    w = w / (w.sum(-1, keepdim=True) + 1e-9)
    want = common.swiglu(toks, p.shared.gate, p.shared.up, p.shared.down)
    for t in range(toks.shape[0]):
        for j in range(cfg.moe_top_k):
            if keep[t, j]:
                ei = int(e[t, j])
                want[t] += w[t, j] * common.swiglu(
                    toks[t], p.gate[:, ei], p.up[:, ei], p.down[:, ei])
    assert (out.reshape(-1, cfg.d_model) - want).abs().max() < TOL


# --- parameters --------------------------------------------------------------


def _expected(tree, n_layers, pick=lambda leaf, i: leaf[i]) -> dict:
    """Port parameter name -> the reference leaf's slice it must hold
    (``pick(leaf, i)`` of layer i's; the whole leaf outside ``layers``)."""
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
    assert isinstance(params, T.DenseLM)
    assert all(lp.mlp is None and isinstance(lp.moe, moe.MoE)
               for lp in params.layers)
    assert params.layers[0].moe.router.dtype == torch.float32


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
def test_init_params_matches_reference_shapes(full):
    """Random init gives the reference's names, shapes and count: the smoke
    config on the CPU, the full config on the meta device."""
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
        assert params.layers[0].moe.gate.dtype == torch.bfloat16
        assert params.layers[0].moe.router.dtype == torch.float32
    else:
        assert all(not p.requires_grad for p in params.parameters())


def test_mla_still_raises():
    """deepseek-v2-236b is a moe config on MLA attention: it still raises,
    naming ROADMAP item 8c."""
    cfg = get_smoke_config("deepseek-v2-236b")
    with pytest.raises(NotImplementedError, match="item 8c"):
        T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="item 8c"):
        T.init_cache(cfg, 1, 8, device="cpu")


# --- forward, lm_loss --------------------------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_matches_reference(model, impl):
    tree, params = model
    rcfg, cfg = _cfgs(**_impl_kw(impl))
    toks = _tokens(1, cfg.vocab_size)
    want, waux = RT.forward(tree, rcfg, jnp.asarray(toks), with_aux=True)
    got, gaux = T.forward(params, cfg, torch.from_numpy(toks), with_aux=True)
    assert got.dtype == torch.float32
    assert got.shape == (2, SEQ, cfg.padded_vocab)
    assert np.abs(_np(got) - _np(want)).max() < TOL
    assert float(gaux) > 0 and abs(float(gaux) - float(waux)) < TOL
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
    assert float(gm["moe_aux"]) > 0


def test_kernel_runs_in_every_layer(model, monkeypatch):
    """A cache-less kernel forward calls tri_attn once per layer; at a
    length that is not a multiple of the block, never."""
    _, params = model
    cfg = get_smoke_config(ARCH).replace(**_impl_kw("pallas_mapped"))
    real, seen = attn_ops.causal_attention, []

    def counting(q, *args, **kw):
        seen.append(tuple(q.shape))
        return real(q, *args, **kw)

    monkeypatch.setattr(attn_ops, "causal_attention", counting)
    toks = torch.from_numpy(_tokens(3, cfg.vocab_size))
    T.forward(params, cfg, toks)
    assert len(seen) == cfg.n_layers
    assert set(seen) == {(2, cfg.n_heads, SEQ, cfg.head_dim)}
    seen.clear()
    T.forward(params, cfg, toks[:, :24])
    assert seen == []


# --- prefill, decode, generate -----------------------------------------------


def test_prefill_and_decode_match_reference(model):
    """Prefill logits and every layer's k/v, then four decode steps, each
    fed the reference's argmax (a decode step's 2 tokens route at capacity
    8; prefill's 64 at 24, where this input drops)."""
    tree, params = model
    rcfg, cfg = _cfgs()
    toks = _tokens(5, cfg.vocab_size, (2, 32))
    want, rc = RT.prefill(tree, rcfg, jnp.asarray(toks))
    with moe.record_routing() as rec:
        got, c = T.prefill(params, cfg, torch.from_numpy(toks))
    assert sum(int((~r["keep"]).sum()) for r in rec) > 0
    assert np.abs(_np(got) - _np(want)).max() < TOL
    for i, lc in enumerate(c["layers"]):
        assert lc["idx"] == 32
        for key in ("k", "v"):
            assert np.abs(_np(lc[key]) - _np(rc["layers"][key][i])).max() \
                < TOL
    tok = np.asarray(jnp.argmax(want[:, -1:], -1)).astype(np.int32)
    for _ in range(4):
        wd, rc = RT.decode_step(tree, rcfg, jnp.asarray(tok), rc)
        gd, c = T.decode_step(params, cfg, torch.from_numpy(tok), c)
        assert np.abs(_np(gd) - _np(wd)).max() < TOL
        tok = np.asarray(jnp.argmax(wd, -1)).astype(np.int32)
    assert c["layers"][0]["idx"] == 36


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
