"""The port's single-device training (repro_torch.train, launch.train)
against the JAX package's, on the CPU at smoke size: the optimizer, the
train step for a dense model, a MoE on GQA and a MoE on MLA, microbatches,
remat, the synthetic data, checkpoints in both directions, the restart loop
and the entry point.

The reference's jitted step is the oracle.  Loss and metrics agree to
1e-6 relative.  Parameters are held to 1e-4 of each leaf's max |value|:
AdamW's first step moves an element by lr · g/(|g| + eps), so where |g| is
near eps the fp32 summation order of g (the port differentiates each layer
alone, the reference a scan) turns into a visible share of that element's
step, while the moments m and v, linear in g, agree to about 1e-6 of their
max and are held to 1e-5.  The whole-step parity runs with weight decay 0:
the reference decays its stacked per-layer norm scales (``ndim >= 2`` on
(L, d)), the port decays matrices only (``test_decay_applies_to_matrices_only``).
"""
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor

from repro.configs import get_smoke_config as ref_smoke
from repro.models import transformer as RT
from repro.train import checkpoint as ref_ckpt
from repro.train import optimizer as ref_opt
from repro.train.data import DataConfig as RefDataConfig
from repro.train.data import SyntheticLM as RefSyntheticLM
from repro.train.train_step import TrainConfig as RefTrainConfig
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models.convert import to_jax_tree
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train import sharded
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.train.fault_tolerance import (
    InjectedFailure, ResilientLoop, StepWatchdog, elastic_restore,
)
from repro_torch.train.train_step import TrainConfig, make_train_step

ARCHS = ["llama3.2-3b", "moonshot-v1-16b-a3b", "deepseek-v2-236b"]
METRIC_RTOL = 1e-6
PARAM_RTOL = 1e-4      # of each leaf's max |value|
MOMENT_RTOL = 1e-5     # of each leaf's max |value|
SEQ = 32


def _ref_tree(arch, seed=0, **kw):
    rcfg = ref_smoke(arch).replace(**kw)
    return rcfg, jax.tree.map(np.asarray, RT.init_params(
        jax.random.PRNGKey(seed), rcfg))


def _model(arch, tree, **kw):
    cfg = get_smoke_config(arch).replace(**kw)
    return cfg, params_from_jax(tree, cfg, "cpu")


def _batch(cfg, step, batch=4):
    b = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                               global_batch=batch)).batch_at(step)
    return b, {k: torch.from_numpy(v) for k, v in b.items()}


def _f32(a) -> np.ndarray:
    """fp32 values of a leaf; a bf16 leaf of ``params_to_jax`` is raw
    2-byte words (``V2``)."""
    a = np.asarray(a)
    if a.dtype == np.dtype("V2"):
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def _leaf_rel(want, got) -> float:
    """max over leaves of max |Δ| / max |want|."""
    out = 0.0
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        a, b = _f32(a), _f32(b)
        out = max(out, float(np.abs(a - b).max())
                  / max(float(np.abs(a).max()), 1e-30))
    return out


class _Tree(nn.Module):
    """A flat module of named parameters (``apply_updates`` takes a
    module)."""

    def __init__(self, tensors: dict):
        super().__init__()
        for n, t in tensors.items():
            self.register_parameter(n, nn.Parameter(t.clone()))


# --- optimizer ---------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 3, 9, 10, 11, 55, 100, 150])
def test_lr_at_matches_reference(step):
    c = dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    want = float(ref_opt.lr_at(ref_opt.OptimizerConfig(**c),
                               jnp.asarray(step)))
    got = opt.lr_at(opt.OptimizerConfig(**c), torch.tensor(step))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=METRIC_RTOL)


def _opt_trees(dtype):
    r = np.random.default_rng(3)
    shapes = {"w": (6, 5), "b": (5,), "k": (2, 3, 4)}
    p = {n: r.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    g = {n: (r.standard_normal(s) * 0.3).astype(np.float32)
         for n, s in shapes.items()}
    tp = {n: torch.from_numpy(a).to(dtype) for n, a in p.items()}
    tg = {n: torch.from_numpy(a).to(dtype) for n, a in g.items()}
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jp = {n: jnp.asarray(a).astype(jd) for n, a in p.items()}
    jg = {n: jnp.asarray(a).astype(jd) for n, a in g.items()}
    if dtype == torch.bfloat16:   # the same bf16 numbers on both sides
        jp = {n: jnp.asarray(_bits(tp[n])) for n in p}
        jg = {n: jnp.asarray(_bits(tg[n])) for n in g}
    return tp, tg, jp, jg


def _bits(t):
    import ml_dtypes

    return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_global_norm_matches_reference(dtype):
    _, tg, _, jg = _opt_trees(dtype)
    want = float(ref_opt.global_norm(jg))
    got = opt.global_norm(tg)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=METRIC_RTOL)


@pytest.mark.parametrize("clip", [1.0, 100.0], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_apply_updates_matches_reference(dtype, clip):
    """Three AdamW steps with decay on the same tree: parameters in their
    dtype (bf16: within one ulp of the reference's), fp32 moments, the step
    counter, grad norm and lr."""
    tp, tg, jp, jg = _opt_trees(dtype)
    c = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
             clip_norm=clip)
    model = _Tree(tp)
    state = opt.init_state(model)
    rstate = ref_opt.init_state(jp)
    for _ in range(3):
        jp, rstate, wm = ref_opt.apply_updates(
            jp, jg, rstate, ref_opt.OptimizerConfig(**c))
        gm = opt.apply_updates(model, tg, state, opt.OptimizerConfig(**c))
        for k in ("grad_norm", "lr"):
            assert float(gm[k]) == pytest.approx(float(wm[k]),
                                                 rel=METRIC_RTOL)
    assert int(state["step"]) == int(rstate["step"]) == 3
    for n, p in model.named_parameters():
        assert p.dtype == dtype
        want = np.asarray(jp[n]).astype(np.float32)
        ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-6
        assert np.abs(p.detach().float().numpy() - want).max() \
            <= ulp * np.abs(want).max()
        for part in ("m", "v"):
            w = np.asarray(rstate[part][n])
            assert np.abs(state[part][n].numpy() - w).max() \
                <= MOMENT_RTOL * np.abs(w).max()


def test_decay_applies_to_matrices_only():
    """With zero gradients AdamW's step is the decay alone: every matrix of
    the port shrinks by lr · wd and every vector (the norm scales) stays.
    The reference also shrinks its per-layer norm scales, which it stacks
    to (L, d) (ROADMAP queue 3)."""
    arch = "llama3.2-3b"
    rcfg, tree = _ref_tree(arch)
    cfg, model = _model(arch, tree)
    c = dict(lr=1e-2, warmup_steps=0, total_steps=10, weight_decay=0.1)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    zeros = {n: torch.zeros_like(p) for n, p in before.items()}
    opt.apply_updates(model, zeros, opt.init_state(model),
                      opt.OptimizerConfig(**c))
    lr = float(opt.lr_at(opt.OptimizerConfig(**c), 0))
    decayed = set()
    for n, p in model.named_parameters():
        if torch.equal(p, before[n]):
            assert p.ndim == 1, n
        else:
            assert p.ndim >= 2 and opt.decays(p), n
            assert torch.allclose(p, before[n] * (1 - lr * 0.1), rtol=1e-6)
            decayed.add(n)
    assert {"embed", "layers.0.attn.wq", "layers.2.mlp.down"} <= decayed
    assert not {"final_norm", "layers.0.ln1", "layers.1.ln2"} & decayed
    jt = jax.tree.map(jnp.asarray, tree)
    new, _, _ = ref_opt.apply_updates(
        jt, jax.tree.map(jnp.zeros_like, jt), ref_opt.init_state(jt),
        ref_opt.OptimizerConfig(**c))
    assert not np.array_equal(np.asarray(new["layers"]["ln1"]),
                              tree["layers"]["ln1"])
    np.testing.assert_array_equal(np.asarray(new["final_norm"]),
                                  tree["final_norm"])


# --- the train step ----------------------------------------------------------


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, steps):
    """``steps`` train steps from the reference's weights on SyntheticLM's
    batches: loss, ce, z_loss, moe_aux, grad_norm and lr each step, then
    every parameter and both moments (weight decay 0, see the module's
    docstring)."""
    rcfg, tree = _ref_tree(arch)
    cfg, model = _model(arch, tree)
    oc = dict(lr=1e-3, warmup_steps=2, total_steps=10, weight_decay=0.0)
    ref_step = jax.jit(ref_make_train_step(rcfg, RefTrainConfig(
        optimizer=ref_opt.OptimizerConfig(**oc))))
    step = make_train_step(cfg, TrainConfig(
        optimizer=opt.OptimizerConfig(**oc)))
    rp = jax.tree.map(jnp.asarray, tree)
    rstate, state = ref_opt.init_state(rp), opt.init_state(model)
    for i in range(steps):
        nb, tb = _batch(cfg, i)
        rp, rstate, wm = ref_step(rp, rstate, jax.tree.map(jnp.asarray, nb))
        model, state, gm = step(model, state, tb)
        assert set(gm) == set(wm)
        for k in wm:
            assert float(gm[k]) == pytest.approx(float(wm[k]),
                                                 rel=METRIC_RTOL, abs=1e-9)
    if cfg.family == "moe":
        assert float(gm["moe_aux"]) > 0
    assert int(state["step"]) == steps
    assert _leaf_rel(rp, params_to_jax(model, cfg)) < PARAM_RTOL
    for part in ("m", "v"):
        assert _leaf_rel(rstate[part], to_jax_tree(state[part])) \
            < MOMENT_RTOL


def _bf16_steps_follow_the_reference(microbatches):
    """Three bf16 steps in ``microbatches`` from the reference's bf16
    weights: each step's loss within one bf16 rounding (2^-9 relative) and
    grad norm within 1e-2 of the reference's, and every parameter within
    2^-7 of its leaf's max |value| after the steps."""
    arch = "llama3.2-3b"
    rcfg, tree = _ref_tree(arch, dtype="bfloat16")
    cfg, model = _model(arch, tree, dtype="bfloat16")
    oc = dict(lr=3e-4, warmup_steps=5, total_steps=20)
    ref_step = jax.jit(ref_make_train_step(rcfg, RefTrainConfig(
        optimizer=ref_opt.OptimizerConfig(**oc), microbatches=microbatches)))
    step = make_train_step(cfg, TrainConfig(
        optimizer=opt.OptimizerConfig(**oc), microbatches=microbatches))
    rp = jax.tree.map(jnp.asarray, tree)
    rstate, state = ref_opt.init_state(rp), opt.init_state(model)
    for i in range(3):
        nb, tb = _batch(cfg, i)
        rp, rstate, wm = ref_step(rp, rstate, jax.tree.map(jnp.asarray, nb))
        model, state, gm = step(model, state, tb)
        assert float(gm["loss"]) == pytest.approx(float(wm["loss"]),
                                                  rel=2.0 ** -9)
        assert float(gm["grad_norm"]) == pytest.approx(
            float(wm["grad_norm"]), rel=1e-2)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert _leaf_rel(rp, params_to_jax(model, cfg)) < 2.0 ** -7


def test_bf16_train_steps_follow_the_reference():
    """In 2 microbatches, the card's setting (fp32 gradient sums)."""
    _bf16_steps_follow_the_reference(2)


def test_bf16_step_in_one_microbatch_follows_the_reference():
    """In one microbatch, the default of ``TrainConfig`` and
    ``launch.train`` (the gradients stay bf16)."""
    _bf16_steps_follow_the_reference(1)


def test_lookup_gradient_sums_repeats_in_fp32():
    """The embedding lookup's bf16 gradient at SyntheticLM's zipf tokens
    (2 x 4096; the most frequent token repeats over a thousand times): the
    port sums each token's rows in fp32 and rounds once, within one bf16
    rounding (2^-8) of the exact sum's max |value|; the reference's
    ``jnp.take`` adds the repeats in bf16 on the CPU and lands more than
    ten times further off (ROADMAP queue 3)."""
    from types import SimpleNamespace

    cfg = get_smoke_config("llama3.2-3b")
    toks = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=4096,
                                  global_batch=2)).batch_at(0)["tokens"]
    assert np.bincount(toks.ravel()).max() > 1000
    r = np.random.default_rng(5)
    table = torch.from_numpy(r.standard_normal(
        (cfg.vocab_size, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    g = torch.from_numpy(r.standard_normal(
        toks.shape + (cfg.d_model,)).astype(np.float32)).to(torch.bfloat16)
    exact = np.zeros(table.shape, np.float64)
    np.add.at(exact, toks, g.double().numpy())
    scale = np.abs(exact).max()
    t = table.clone().requires_grad_(True)
    out = T._embed(SimpleNamespace(embed=t), cfg, torch.from_numpy(toks))
    (got,) = torch.autograd.grad(out, [t], g)
    assert got.dtype == torch.bfloat16
    port = np.abs(got.double().numpy() - exact).max() / scale
    _, vjp = jax.vjp(lambda w: jnp.take(w, jnp.asarray(toks), axis=0),
                     jnp.asarray(_bits(table)))
    (ref,) = vjp(jnp.asarray(_bits(g)))
    ref = np.abs(np.asarray(ref).astype(np.float64) - exact).max() / scale
    assert port <= 2.0 ** -8
    assert ref > 10 * port, (port, ref)


def test_microbatches_match_one_batch():
    """2 microbatches give the step of 1 over the same batch (the
    reference's own test holds 4 against 1 to 5e-5); the gradients are
    accumulated in fp32."""
    arch = "llama3.2-3b"
    _, tree = _ref_tree(arch)
    cfg, _ = _model(arch, tree)
    _, tb = _batch(cfg, 0)
    out = {}
    for n in (1, 2):
        _, model = _model(arch, tree)
        step = make_train_step(cfg, TrainConfig(microbatches=n))
        model, state, m = step(model, opt.init_state(model), tb)
        out[n] = (model, m)
    assert float(out[2][1]["loss"]) == pytest.approx(
        float(out[1][1]["loss"]), rel=1e-5)
    for (_, a), (_, b) in zip(out[1][0].named_parameters(),
                              out[2][0].named_parameters()):
        assert float((a - b).detach().abs().max()) < 5e-5


def test_microbatch_gradients_accumulate_in_fp32(monkeypatch):
    """On a bf16 model the step hands the optimizer fp32 gradients when it
    accumulates microbatches, and the parameters' dtype with one."""
    arch = "llama3.2-3b"
    _, tree = _ref_tree(arch, dtype="bfloat16")
    cfg, model = _model(arch, tree, dtype="bfloat16")
    _, tb = _batch(cfg, 0)
    seen = []
    real = opt.apply_updates
    monkeypatch.setattr(opt, "apply_updates", lambda m, g, s, c: (
        seen.append({t.dtype for t in g.values()}) or real(m, g, s, c)))
    for n in (2, 1):
        make_train_step(cfg, TrainConfig(microbatches=n))(
            model, opt.init_state(model), tb)
    assert seen == [{torch.float32}, {torch.bfloat16}]


def _loss_and_grads(model, cfg, tb):
    from repro_torch.train.train_step import lm_loss

    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    loss, _ = lm_loss(model, cfg, tb)
    return loss.detach(), torch.autograd.grad(loss, list(named.values()))


@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-v2-236b"])
def test_remat_policies_agree(arch, monkeypatch):
    """``full``, ``dots`` and ``none`` give the same loss and gradients,
    bit for bit on the CPU; ``full`` and ``dots`` run each layer again in
    the backward and ``none`` does not, and ``dots`` recomputes none of the
    weight products (aten mm / addmm) that ``full`` does."""
    _, tree = _ref_tree(arch)
    _, tb = _batch(get_smoke_config(arch), 1, batch=2)
    layer_calls, mm = [], []
    real = T._layer_apply
    monkeypatch.setattr(T, "_layer_apply", lambda *a, **k: (
        layer_calls.append(1) or real(*a, **k)))
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMM(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default,
                        torch.ops.aten.addmm.default):
                mm.append(1)
            return func(*args, **(kwargs or {}))

    out = {}
    for policy in ("none", "full", "dots"):
        cfg, model = _model(arch, tree, remat_policy=policy)
        layer_calls.clear()
        mm.clear()
        with CountMM():
            out[policy] = _loss_and_grads(model, cfg, tb)
        out[policy] += (len(layer_calls), len(mm))
    n = get_smoke_config(arch).n_layers
    assert out["none"][2] == n and out["full"][2] == out["dots"][2] == 2 * n
    assert out["none"][3] == out["dots"][3] < out["full"][3]
    for policy in ("full", "dots"):
        assert torch.equal(out[policy][0], out["none"][0])
        for a, b in zip(out[policy][1], out["none"][1]):
            assert torch.equal(a, b)


def test_no_remat_and_no_graph_without_a_gradient():
    """Scoring under inference mode builds no graph and recomputes
    nothing, whatever ``remat_policy`` says."""
    arch = "llama3.2-3b"
    _, tree = _ref_tree(arch)
    cfg, model = _model(arch, tree, remat_policy="full")
    _, tb = _batch(cfg, 0, batch=2)
    assert not any(p.requires_grad for p in model.parameters())
    logits = T.forward(model, cfg, tb["tokens"])
    assert logits.grad_fn is None and logits.is_inference()


def test_grad_compression_raises_naming_9b():
    """``grad_compression=True`` is accepted and changes nothing: the
    reference declares it and its step never reads it (ROADMAP queue 3), so
    the step is the one without it, bit for bit.  The name is the one the
    test had while the port refused the flag."""
    arch = "llama3.2-3b"
    _, tree = _ref_tree(arch)
    out = []
    for flag in (False, True):
        cfg, model = _model(arch, tree)
        state = opt.init_state(model)
        step = make_train_step(cfg, TrainConfig(grad_compression=flag))
        model, state, m = step(model, state, _batch(cfg, 0)[1])
        out.append((m, dict(model.named_parameters()), state))
    (m0, p0, s0), (m1, p1, s1) = out
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(p0[n], p1[n]) for n in p0)
    assert all(torch.equal(s0["m"][n], s1["m"][n])
               and torch.equal(s0["v"][n], s1["v"][n]) for n in p0)


@pytest.mark.parametrize("arch", ["llama3.2-3b"])
def test_loss_decreases(arch):
    """25 steps on SyntheticLM lower the loss (the reference's
    ``tests/test_train.py::test_loss_decreases``)."""
    _, tree = _ref_tree(arch)
    cfg, model = _model(arch, tree)
    step = make_train_step(cfg, TrainConfig(optimizer=opt.OptimizerConfig(
        lr=1e-3, warmup_steps=2, total_steps=40)))
    state = opt.init_state(model)
    losses = []
    for i in range(25):
        _, tb = _batch(cfg, i)
        model, state, m = step(model, state, tb)
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05


# --- data --------------------------------------------------------------------


@pytest.mark.parametrize("seed,step,host,hosts", [
    (0, 0, 0, 1), (0, 5, 0, 1), (3, 7, 1, 2), (1, 2, 3, 4)])
def test_synthetic_batches_byte_equal_to_reference(seed, step, host, hosts):
    c = dict(vocab_size=1000, seq_len=96, global_batch=8, seed=seed)
    want = RefSyntheticLM(RefDataConfig(**c)).batch_at(step, host, hosts)
    got = SyntheticLM(DataConfig(**c)).batch_at(step, host, hosts)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes()


# --- checkpoints -------------------------------------------------------------


def _trained(arch, steps=2, dtype="float32"):
    _, tree = _ref_tree(arch, dtype=dtype)
    cfg, model = _model(arch, tree, dtype=dtype)
    step = make_train_step(cfg, TrainConfig(optimizer=opt.OptimizerConfig(
        lr=1e-3, warmup_steps=1, total_steps=10)))
    state = opt.init_state(model)
    for i in range(steps):
        model, state, _ = step(model, state, _batch(cfg, i)[1])
    return cfg, model, state


def _fresh(arch, dtype="float32"):
    cfg = get_smoke_config(arch).replace(dtype=dtype)
    model = T.init_params(cfg, torch.Generator().manual_seed(9), "cpu")
    return model, opt.init_state(model)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-v2-236b"])
def test_checkpoint_round_trip(tmp_path, arch, dtype):
    """save then restore into freshly initialised tensors gives every
    parameter, moment and the step back bit for bit."""
    _, model, state = _trained(arch, dtype=dtype)
    d = str(tmp_path / "ck")
    ckpt.save(d, 7, model, state, extra={"arch": arch})
    assert ckpt.latest_step(d) == 7
    m2, s2 = _fresh(arch, dtype)
    _, manifest = ckpt.restore(d, 7, {"params": m2, "opt_state": s2})
    assert manifest["step"] == 7 and manifest["extra"] == {"arch": arch}
    for (n, a), (_, b) in zip(model.named_parameters(),
                              m2.named_parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), n
    assert int(s2["step"]) == int(state["step"]) == 2
    for part in ("m", "v"):
        for n in state[part]:
            assert torch.equal(state[part][n], s2[part][n])
    if dtype == "bfloat16":
        assert manifest["dtypes"]["params/layers/attn/wo"] == "bfloat16"
        assert manifest["dtypes"]["opt_state/m/layers/attn/wo"] == "float32"


def test_checkpoint_atomicity_and_latest(tmp_path):
    model, _ = _fresh("llama3.2-3b")
    d = str(tmp_path / "ck")
    assert ckpt.latest_step(d) is None
    ckpt.save(d, 1, model)
    # a stale .tmp dir must never be picked up as a checkpoint
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    assert ckpt.latest_step(d) == 1
    # a directory without its manifest is not complete either
    os.makedirs(os.path.join(d, "step_00000005"))
    assert ckpt.latest_step(d) == 1
    # a rewrite of a step replaces it whole, and a stale .tmp of it goes
    os.makedirs(os.path.join(d, "step_00000002.tmp"))
    ckpt.save(d, 2, model)
    assert sorted(os.listdir(d)) == ["step_00000001", "step_00000002",
                                     "step_00000005", "step_00000009.tmp"]
    assert set(os.listdir(os.path.join(d, "step_00000002"))) == {
        "arrays_0.npz", "manifest.json"}


def test_checkpoint_gc(tmp_path):
    model, _ = _fresh("llama3.2-3b")
    d = str(tmp_path / "ck")
    for s in (1, 2, 3, 4, 5):
        ckpt.save(d, s, model)
    ckpt.gc_old(d, keep=2)
    assert ckpt.latest_step(d) == 5
    assert sorted(os.listdir(d)) == ["step_00000004", "step_00000005"]


def test_checkpoint_restore_refuses(tmp_path):
    """A shape that differs is refused; restoring onto shardings (a
    one-rank gloo mesh here), and ``elastic_restore``, lay every parameter
    and moment out as a DTensor on that mesh, bit for bit."""
    cfg, model, state = _trained("llama3.2-3b")
    d = str(tmp_path / "ck")
    ckpt.save(d, 3, model, state)
    other, _ = _fresh("llama3.2-3b")
    fewer = T.init_params(cfg.replace(n_layers=2),
                          torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(d, 3, {"params": fewer})
    want = dict(model.named_parameters())
    dist.init_process_group("gloo", rank=0, world_size=1, store=dist.FileStore(
        str(tmp_path / "store"), 1))
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        lay = sharded.layout(other, cfg, mesh)
        ckpt.restore(d, 3, {"params": other},
                     shardings={"params": lay["params"]})
        for n, p in other.named_parameters():
            assert isinstance(p, DTensor) and p.device_mesh is mesh
            assert torch.equal(p.full_tensor(), want[n])
        third, st = _fresh("llama3.2-3b")
        elastic_restore(d, 3, {"params": third, "opt_state": st}, lay)
        for n, p in third.named_parameters():
            assert torch.equal(p.full_tensor(), want[n])
            assert torch.equal(st["m"][n].full_tensor(), state["m"][n])
            assert torch.equal(st["v"][n].full_tensor(), state["v"][n])
        assert int(st["step"]) == int(state["step"])
    finally:
        dist.destroy_process_group()


def _ref_template(arch, dtype="float32"):
    rcfg, tree = _ref_tree(arch, seed=5, dtype=dtype)
    params = jax.tree.map(jnp.asarray, tree)
    return {"params": params, "opt_state": ref_opt.init_state(params)}


@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-v2-236b"])
def test_fp32_checkpoint_written_by_the_port_restores_in_the_reference(
        tmp_path, arch):
    cfg, model, state = _trained(arch)
    d = str(tmp_path / "ck")
    ckpt.save(d, 4, model, state)
    restored, manifest = ref_ckpt.restore(d, 4, _ref_template(arch))
    assert manifest["step"] == 4
    want = {"params": params_to_jax(model, cfg),
            "opt_state": {"step": np.int32(2), "m": to_jax_tree(state["m"]),
                          "v": to_jax_tree(state["v"])}}
    got = jax.tree.map(np.asarray, restored)
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, want))
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-v2-236b"])
def test_checkpoint_written_by_the_reference_restores_in_the_port(
        tmp_path, arch, dtype):
    """fp32, and bf16, which the reference itself cannot restore (ROADMAP
    queue 3): bit for bit, every parameter and both moments."""
    tmpl = _ref_template(arch, dtype)
    tmpl["opt_state"]["m"] = jax.tree.map(lambda a: a + 0.25,
                                          tmpl["opt_state"]["m"])
    d = str(tmp_path / "ck")
    ref_ckpt.save(d, 11, tmpl["params"], tmpl["opt_state"])
    if dtype == "bfloat16":
        with pytest.raises(ValueError):
            ref_ckpt.restore(d, 11, tmpl)
    model, state = _fresh(arch, dtype)
    ckpt.restore(d, 11, {"params": model, "opt_state": state})
    cfg = get_smoke_config(arch)
    got = params_to_jax(model, cfg)
    for a, b in zip(jax.tree.leaves(tmpl["params"]), jax.tree.leaves(got)):
        a = np.asarray(a)
        if dtype == "bfloat16":
            np.testing.assert_array_equal(a.view(np.uint16),
                                          b.view(np.uint16))
        else:
            np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(tmpl["opt_state"]["m"]),
                    jax.tree.leaves(to_jax_tree(state["m"]))):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_bf16_npz_members_byte_equal_to_the_reference(tmp_path):
    """The same bf16 tree through both packages' ``save``: the archive's
    members (names, order, every .npy's bytes) and the manifests are equal.
    The zip container itself stamps each member's write time."""
    arch = "llama3.2-3b"
    tmpl = _ref_template(arch, "bfloat16")
    ref_ckpt.save(str(tmp_path / "ref"), 3, tmpl["params"],
                  tmpl["opt_state"])
    cfg = get_smoke_config(arch).replace(dtype="bfloat16")
    model = params_from_jax(jax.tree.map(np.asarray, tmpl["params"]), cfg,
                            "cpu")
    ckpt.save(str(tmp_path / "port"), 3, model, opt.init_state(model))
    members = []
    for who in ("ref", "port"):
        base = tmp_path / who / "step_00000003"
        with zipfile.ZipFile(base / "arrays_0.npz") as z:
            members.append([(i.filename, z.read(i.filename))
                            for i in z.infolist()])
        members.append((base / "manifest.json").read_text())
    assert [n for n, _ in members[0]] == [n for n, _ in members[2]]
    assert any(b"'descr': '<V2'" in raw for _, raw in members[0])
    for (n, a), (_, b) in zip(members[0], members[2]):
        assert a == b, n
    assert members[1] == members[3]


# --- fault tolerance ---------------------------------------------------------


def test_resilient_loop_recovers_to_the_uninterrupted_run(tmp_path):
    """A failure injected at step 7 (checkpoints every 3) restores step 6
    and replays: 12 steps end where an uninterrupted run ends, bit for
    bit, parameters and optimizer state."""
    arch = "llama3.2-3b"
    _, tree = _ref_tree(arch)
    cfg, _ = _model(arch, tree)
    step = make_train_step(cfg, TrainConfig(optimizer=opt.OptimizerConfig(
        lr=1e-3, warmup_steps=2, total_steps=12)))
    runs = {}
    for name, fail_at in (("plain", None), ("failed", 7)):
        _, model = _model(arch, tree)
        fails = {"armed": fail_at is not None}

        def hook(s):
            if s == fail_at and fails["armed"]:
                fails["armed"] = False
                raise InjectedFailure("simulated host loss")

        loop = ResilientLoop(step_fn=step,
                             batch_fn=lambda s: _batch(cfg, s)[1],
                             ckpt_dir=str(tmp_path / name), ckpt_every=3,
                             failure_hook=hook)
        runs[name] = loop.run(model, opt.init_state(model), 0, 12)
    p, s, info = runs["failed"]
    assert info["final_step"] == 12 and info["restores"] == 1
    assert int(s["step"]) == 12
    assert runs["plain"][2]["restores"] == 0
    assert ckpt.latest_step(str(tmp_path / "failed")) == 12
    for (n, a), (_, b) in zip(runs["plain"][0].named_parameters(),
                              p.named_parameters()):
        assert torch.equal(a, b), n
    for part in ("m", "v"):
        for n in s[part]:
            assert torch.equal(runs["plain"][1][part][n], s[part][n])


def test_resilient_loop_gives_up_after_max_restores(tmp_path):
    model, state = _fresh("llama3.2-3b")

    def hook(s):
        raise InjectedFailure("always")

    loop = ResilientLoop(step_fn=None, batch_fn=None,
                         ckpt_dir=str(tmp_path / "ft"), max_restores=2,
                         failure_hook=hook)
    with pytest.raises(InjectedFailure):
        loop.run(model, state, 0, 3)


def test_watchdog_flags_stragglers():
    wd = StepWatchdog(threshold=3.0)
    for i in range(10):
        wd.observe(i, 0.1)
    assert wd.observe(10, 0.5)       # 5x median => straggler
    assert not wd.observe(11, 0.15)
    assert len(wd.stragglers) == 1
    assert wd.stragglers[0][0] == 10
    assert wd.median == pytest.approx(0.1)


# --- the entry point ---------------------------------------------------------


def test_launch_train_smoke_on_the_cpu(tmp_path, capsys):
    launch_train.main(["--arch", "llama3.2-3b", "--smoke", "--device", "cpu",
                       "--steps", "4", "--batch", "2", "--seq", "32",
                       "--microbatches", "2", "--log-every", "2",
                       "--ckpt-every", "2", "--ckpt-dir",
                       str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "arch=llama3.2-3b params=72,528 device=cpu" in out
    assert "step 4: loss=" in out and "final metrics:" in out
    assert ckpt.latest_step(str(tmp_path / "ck")) == 4
    launch_train.main(["--arch", "llama3.2-3b", "--smoke", "--device", "cpu",
                       "--steps", "2", "--batch", "2", "--seq", "32",
                       "--resume", "--ckpt-dir", str(tmp_path / "ck")])
    assert "resumed from step 4" in capsys.readouterr().out


def test_launch_train_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        launch_train.main(["--arch", "llama3.2-3b", "--smoke", "--steps",
                           "1"])
    # the production mesh needs 256 ranks; run alone there is one
    with pytest.raises(SystemExit, match="needs 256 ranks"):
        launch_train.main(["--arch", "llama3.2-3b", "--smoke", "--device",
                           "cpu", "--production-mesh"])
