"""The port's sharded training (repro_torch.train.sharded, the MoE's
all-to-all dispatch, the compressed all-reduce, checkpoints over a mesh and
the launcher under ``torch.distributed.run``) on 4 gloo ranks on the CPU.

The ranks run ``tests/_torch_dist_worker.py`` once for the module, every
case in turn, and each rank's results come back as a pickle; each test
reads its case.  Where the reference has an oracle it is computed once in a
subprocess on 4 fake CPU devices (``XLA_FLAGS``, ``jax.set_mesh`` for
``shard_map``): ``moe_apply`` with ``moe_impl="a2a"`` on a ``(2, 2)``
``("data", "model")`` mesh, its gradients, and ``compressed_psum_mean``.
The reference's sharded step has no such oracle (its models fail under a
mesh with the installed jax, ROADMAP queue 3), so the port's sharded step is
held against the port's single-device step, which ``test_torch_train.py``
holds against the reference's.

The step cases run on three meshes, (data, model) = (2, 2), (1, 4) and
(4, 1): on every mesh with a model axis above one the step splits heads,
ffn, vocab and experts over it (``distribution/tensor_parallel.py``), and
rwkv6's and mamba2's layers (``FAMILY_CASES``; their own cases are in
``tests/test_torch_distributed_ssm.py``).

Tolerances: metrics within 1e-6 relative; parameters and both moments
within 1e-5 of each tensor's max |value| (fp32: the sharded step sums the
data ranks' gradients, and the parts of each split product, in another
order).  AdamW moves an element by lr · m/(√v + eps), so where a gradient
is near eps its last bits become a visible share of that element's step.
moonshot's a2a case holds its parameters within 1e-4 of their max where
the a2a dispatch runs: its MoE layers route each rank's tokens through
other ranks' experts and sum the expert gradients in another order still
(an embedding element 2.1e-5 of the table's max off, its gradient equal to
1e-6; its moments hold 1e-5).  yi's step runs in float64
(``FLOAT64_STEPS``: its fp32 islands compute in float64, the optimizer in
fp32).  In fp32 its split products move the gradients by up to 1.0e-6 of
their max, and one element of layer 0's ``wq``, its gradient 6.5e-9
(1.3e-6 of the tensor's max), takes a first step 25% of lr larger on
(2, 2): 1.29e-5 of the tensor's max, 6.4e-5 on (1, 4), where the step-2
moments land 1.65e-5 off.  In float64 the rounding stays far below eps and
yi's step holds the gates on every mesh (parameters within 8.5e-8 of the
max, moments 5.2e-7: the fp32 optimizer's rounding).  The MoE and MLA
step cases and yi with 12 q heads run in float64 too: in fp32 their worst
parameters landed 1.30e-5 (moonshot_global on (1, 4), ``moe.gate``, one
run in two), 8.5e-6 (moonshot_global), 6.4e-6 (deepseek on (1, 4)),
6.2e-6 (moonshot_grouped on (1, 4)) and 6.1e-6 (yi_part_groups on (1, 4))
of their max; in float64 (the router stays fp32, as the reference keeps
it) within 8.5e-8 on every mesh, moments within 1.1e-6.  The gradients
themselves, before the optimizer, are held in fp32 within the moment gate
(``GRAD_RTOL``, 1e-5 of each tensor's max) for every case on every mesh,
yi's within 1.0e-6, and so are the other families' (zamba2, whisper, the
vlm: ``FAMILY_CASES``).  rwkv6's are held in float64 (``FLOAT64_GRADS``,
the fp32 islands widened; the WKV's plain version and the fp32 weights
stay fp32): its smoke model amplifies fp32 rounding (a layer's 1e-6 grows
to 9e-5 of the logits, PERF.md), and with its mixes split over ``model``
the reordered sums move ``bonus_u``'s fp32 gradient 1.3e-5 (2, 2) and
1.6e-5 (1, 4) of its max; in float64 they hold 8.5e-8, 1.1e-14 on (1, 4).
rwkv6's and zamba2's steps are held in
``tests/test_torch_distributed_ssm.py``.
The a2a dispatch within 1e-5 of the reference's; the compressed mean
within 1e-7; checkpoints and restarts bitwise."""
import functools
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as ref_smoke
from repro.models import transformer as RT
from repro.train import checkpoint as ref_ckpt
from repro.train import optimizer as ref_opt
from repro.train.data import DataConfig as RefDataConfig
from repro.train.data import SyntheticLM as RefSyntheticLM
from repro.train.train_step import TrainConfig as RefTrainConfig
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.distribution import sharding as shd
from repro_torch.models import transformer as T
from repro_torch.models import moe as moe_mod
from repro_torch.train.optimizer import init_state
from repro_torch.train.train_step import make_grads_fn, make_train_step

import _torch_dist_worker as W

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")

WORLD = 4
RANK_TIMEOUT = 300       # s, each rank's whole run
METRIC_RTOL = 1e-6
PARAM_RTOL = 1e-5        # of each tensor's max |value|
PARAM_RTOL_A2A = 1e-4    # moonshot_a2a's parameters (see above)
MOMENT_RTOL = 1e-5       # of each tensor's max |value|
GRAD_RTOL = MOMENT_RTOL  # the first batch's gradients, of each max
A2A_TOL = 1e-5
COMPRESS_TOL = 1e-7

_REF_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from types import SimpleNamespace
    from jax.sharding import PartitionSpec as P
    from repro.models import moe as M
    from repro.distribution import sharding as shd
    from repro.distribution.compression import compressed_psum_mean
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map

    out = {}
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    rng = np.random.default_rng(0)
    base = dict(d_model=32, n_experts=8, moe_top_k=2, expert_d_ff=64,
                n_shared_experts=1, moe_renormalize=True, moe_groups=1)
    cfg_g = SimpleNamespace(**base, capacity_factor=8.0, moe_impl="global")
    p = jax.tree.map(np.asarray,
                     M.moe_init(jax.random.PRNGKey(0), cfg_g, jnp.float32))
    x = (rng.standard_normal((4, 16, 32)) * 0.5).astype(np.float32)
    ct = rng.standard_normal((4, 16, 32)).astype(np.float32)
    xs = (rng.standard_normal((2, 3, 32)) * 0.5).astype(np.float32)
    out.update(x=x, ct=ct, xs=xs)
    for k in ("router", "gate", "up", "down"):
        out["p_" + k] = p[k]
    for k in ("gate", "up", "down"):
        out["p_shared_" + k] = p["shared"][k]
    names = ("router", "gate", "up", "down")
    for cf in (8.0, 1.0):
        cfg = SimpleNamespace(**base, capacity_factor=cf, moe_impl="a2a")
        f_sum = lambda x_, p_: jnp.sum(M.moe_apply(p_, cfg, x_) * ct)
        f_aux = lambda x_, p_: M.moe_apply(p_, cfg, x_, with_aux=True)[1]
        with shd.use_sharding(mesh):
            o, aux = jax.jit(lambda p_, x_: M.moe_apply(
                p_, cfg, x_, with_aux=True))(p, x)
            gs = jax.jit(jax.grad(f_sum, argnums=(0, 1)))(x, p)
            ga = jax.jit(jax.grad(f_aux, argnums=(0, 1)))(x, p)
        tag = f"cf{int(cf)}"
        out[tag + "_out"], out[tag + "_aux"] = np.asarray(o), np.asarray(aux)
        out[tag + "_gx_sum"] = np.asarray(gs[0])
        out[tag + "_gx_aux"] = np.asarray(ga[0])
        for k in names:
            out[f"{tag}_g{k}_sum"] = np.asarray(gs[1][k])
            out[f"{tag}_g{k}_aux"] = np.asarray(ga[1][k])
    out["global_out"] = np.asarray(M.moe_apply(p, cfg_g, x))
    out["global_small_out"] = np.asarray(M.moe_apply(p, cfg_g, xs))

    mesh1d = jax.make_mesh((4,), ("pod",))
    rows = np.random.default_rng(1).standard_normal((4, 512)).astype(
        np.float32)
    with jax.set_mesh(mesh1d):
        fn = jax.jit(shard_map(lambda a: compressed_psum_mean(a, "pod", 4),
                               mesh=mesh1d, in_specs=P("pod"),
                               out_specs=P("pod")))
        out["comp_rows"] = rows
        out["comp_out"] = np.asarray(fn(jnp.asarray(rows)))
        out["comp_zeros"] = np.asarray(fn(jnp.zeros((4, 512), jnp.float32)))
        out["comp_bf16"] = np.asarray(
            fn(jnp.asarray(rows, jnp.bfloat16)).astype(jnp.float32))
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's a2a and compression results on 4 fake devices, with
    the inputs the ranks take."""
    path = str(tmp_path_factory.mktemp("ref") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", _REF_SCRIPT, path], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    return path, dict(np.load(path))


def _write_reference_checkpoint(d):
    """One jitted reference step of llama3.2-3b's smoke config (fp32), so
    the moments are not zero, saved by the reference."""
    rcfg = ref_smoke("llama3.2-3b")
    params = RT.init_params(jax.random.PRNGKey(11), rcfg)
    state = ref_opt.init_state(params)
    batch = RefSyntheticLM(RefDataConfig(
        vocab_size=rcfg.vocab_size, seq_len=W.SEQ,
        global_batch=W.BATCH)).batch_at(0)
    step = jax.jit(ref_make_train_step(rcfg, RefTrainConfig()))
    params, state, _ = step(params, state, batch)
    ref_ckpt.save(d, 1, params, state)


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    """Every rank's results: 4 gloo ranks, each joined with a timeout."""
    inputs, _ = ref
    out_dir = tmp_path_factory.mktemp("ranks")
    _write_reference_checkpoint(str(out_dir / "ref_ckpt"))
    store = str(out_dir / "store")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, HERE]),
               OMP_NUM_THREADS="1")
    code = ("import sys, _torch_dist_worker as w; "
            "w.run(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:])")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(WORLD), store, inputs,
         str(out_dir)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    res = []
    for r in range(WORLD):
        with open(out_dir / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return res


def _case(ranks, key, rank=0):
    for name in ranks[rank]:
        if name.startswith("error/") and key.startswith(name[6:]):
            pytest.fail(ranks[rank][name])
    return ranks[rank][key]


@functools.lru_cache(maxsize=None)
def _single_device(case, rows=W.BATCH):
    cfg, tcfg = W.cfg_for(case, step=True), W.tcfg_for(case)
    model = W.model_for(cfg)
    state = init_state(model)
    step = make_train_step(cfg, tcfg)
    metrics = []
    for s in range(W.CASES[case][3]):
        model, state, m = step(model, state, W.batch_at(cfg, s, rows))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, W.whole_state(model, state)


@functools.lru_cache(maxsize=None)
def _single_device_grads(case, rows):
    """The single-device step's gradients of the first batch, and the
    drops of each MoE dispatch."""
    cfg, tcfg = W.cfg_for(case), W.tcfg_for(case)
    model = W.model_for(cfg)
    with moe_mod.record_routing() as rec:
        _, _, grads = make_grads_fn(cfg, tcfg)(model,
                                               W.batch_at(cfg, 0, rows))
    return ({n: g.numpy() for n, g in grads.items()},
            [int((~r["keep"]).sum()) for r in rec])


STEP_IDS = [(case, mesh) for case in W.STEP_CASES for mesh in W.MESHES]
GRAD_IDS = [(case, mesh) for case in W.CASES for mesh in W.MESHES]


def _step_id(case: str, mesh: str) -> str:
    """The case's name on (2, 2), the mesh every step case first ran on;
    the case and the mesh elsewhere."""
    return case if mesh == "2x2" else f"{case}-{mesh}"


def _gate(got, want, skip=(), param_rtol=PARAM_RTOL):
    """The sharded step's gate; returns the failures (empty: it passes)."""
    bad = []
    for gm, wm in zip(got["metrics"], want[0]):
        for k in wm:
            if k not in skip and abs(gm[k] - wm[k]) > METRIC_RTOL * max(
                    abs(wm[k]), 1e-30):
                bad.append((k, gm[k], wm[k]))
    for part in ("params", "m", "v"):
        tol = param_rtol if part == "params" else MOMENT_RTOL
        for n, w in want[1][part].items():
            err = np.max(np.abs(got[part][n] - w))
            if err > tol * max(np.max(np.abs(w)), 1e-30):
                bad.append((part, n, float(err)))
    return bad


def _worst(got, want) -> dict:
    """{part: the largest error of its tensors, as a share of each
    tensor's max |value|}."""
    return {part: max(float(np.max(np.abs(got[part][n] - w))
                            / max(np.max(np.abs(w)), 1e-30))
                      for n, w in want[1][part].items())
            for part in ("params", "m", "v")}


@pytest.mark.parametrize("case,mesh", STEP_IDS,
                         ids=[_step_id(c, m) for c, m in STEP_IDS])
def test_sharded_step_equals_single_device_step(ranks, case, mesh,
                                                record_property):
    """On each mesh the sharded step is the single-device step: metrics,
    every parameter and both moments, over 2 steps at ``launch.train``'s
    optimizer settings; on a model axis above one its products are split
    (yi's step runs in float64: see the module's docstring).  moonshot's
    a2a case (capacity factor 8, no drops)
    runs the all-to-all dispatch in every MoE layer where the model axis
    is above one, where the aux is by definition each shard's balancing
    loss averaged (the reference's), not the batch's: it trains at aux
    coefficient 0 and its aux is held in the a2a tests."""
    got = _case(ranks, f"steps/{case}/{mesh}")
    split = W.MESHES[mesh][1] > 1
    a2a = case == "moonshot_a2a" and split
    want = _single_device(case, W.rows_for(case, mesh))
    for part, err in _worst(got, want).items():   # in the junit xml
        record_property(f"worst_{part}_err_of_max", err)
    assert _gate(got, want, ("moe_aux",) if a2a else (),
                 PARAM_RTOL_A2A if a2a else PARAM_RTOL) == []
    assert got["step"] == W.STEP_CASES[case][3]
    for r in range(1, WORLD):   # every rank reports the same metrics
        assert _case(ranks, f"steps/{case}/{mesh}", r)["metrics"] \
            == got["metrics"]
    if case == "moonshot_a2a":
        cfg = W.cfg_for(case)
        # forward + remat recompute, each MoE layer, each step
        assert got["a2a_calls"] == (2 * cfg.n_layers * W.STEP_CASES[case][3]
                                    if a2a else 0)
        assert all(m["moe_aux"] > 0 for m in got["metrics"])


def _grad_errors(got: dict, want: dict) -> dict:
    """{name: max |error| / max |single-device gradient|}."""
    return {n: float(np.max(np.abs(got[n] - w))
                     / max(np.max(np.abs(w)), 1e-30))
            for n, w in want.items()}


@pytest.mark.parametrize("case,mesh", GRAD_IDS,
                         ids=[f"{c}-{m}" for c, m in GRAD_IDS])
def test_split_gradients_equal_single_device_gradients(ranks, case, mesh,
                                                       record_property):
    """The first batch's gradients, each rank's blocks gathered whole,
    within ``GRAD_RTOL`` of each tensor's max of the single-device step's
    on every rank; the MoE dispatch's drops, summed over the data ranks,
    equal the single-device step's call for call (none where the a2a
    dispatch runs, which records no routing)."""
    rows = W.rows_for(case, mesh)
    want, want_drops = _single_device_grads(case, rows)
    errs = _grad_errors(_case(ranks, f"grads/{case}/{mesh}")["grads"], want)
    record_property("worst_grad_err_of_max", max(errs.values()))
    assert {n: e for n, e in errs.items() if e > GRAD_RTOL} == {}
    data, model = W.MESHES[mesh]
    per_rank = [_case(ranks, f"grads/{case}/{mesh}", r) for r in range(WORLD)]
    drops = [d["drops"] for d in per_rank if d["coord"][1] == 0]
    if case == "moonshot_a2a" and model > 1:
        assert all(d == [] for d in drops)
        return
    assert len(drops) == data and all(len(d) == len(want_drops)
                                      for d in drops)
    assert [sum(col) for col in zip(*drops)] == want_drops
    if W.cfg_for(case).family == "moe":
        assert len(want_drops) == 2 * W.cfg_for(case).n_layers


def test_row_parallel_product_without_its_all_reduce_fails_the_gate(ranks):
    """Control: yi on (1, 4) with the MLPs' row-parallel all-reduce left
    out fails the gradient gate that the split step passes."""
    want, _ = _single_device_grads("yi", W.rows_for("yi", "1x4"))
    errs = _grad_errors(_case(ranks, "grads_control")["grads"], want)
    assert max(errs.values()) > 100 * GRAD_RTOL
    assert errs["layers.0.mlp.down"] > GRAD_RTOL


def test_recompute_in_another_thread_sees_the_forwards_contexts(ranks):
    """The split step's backward run in another thread (as a CUDA backward
    runs in autograd's device thread), so remat's recompute gathers and
    splits the layers as the forward did: its gradients equal those of the
    backward in the forward's own thread, bit for bit, on every rank."""
    for r in range(WORLD):
        got = _case(ranks, "thread_backward", r)
        assert got["equal"] and got["n"] > 0


def test_norm_counting_replicas_fails_the_gate(ranks):
    """Control: a grad norm that counts every replicated shard on every rank
    holding it must fail the gate the sharded step passes."""
    got = _case(ranks, "norm_control")
    bad = _gate(got, _single_device("yi"))
    assert any(b[0] == "grad_norm" for b in bad)
    assert any(b[0] == "m" for b in bad)


@pytest.mark.parametrize("case", ["yi", "moonshot_a2a"])
def test_local_shards_are_the_placements_blocks(ranks, case):
    """Each rank holds, of each parameter, the block its placements give:
    the shapes ``NamedSharding.shard_shape`` says, and its coordinate on the
    mesh is its place in the rank order (data-major)."""
    cfg = W.cfg_for(case)
    model = W.model_for(cfg)
    mesh = {"data": 2, "model": 2}
    lay = shd.param_sharding(T.param_axes(model, cfg),
                             {n: p.shape for n, p in
                              model.named_parameters()},
                             type("Mesh", (), {"shape": mesh})())
    split = 0
    for r in range(WORLD):
        got = _case(ranks, f"steps/{case}/2x2", r)
        assert tuple(got["coord"]) == (r // 2, r % 2)
        for n, p in model.named_parameters():
            shape, placements = got["local"][n]
            assert shape == lay[n].shard_shape(p.shape), n
            assert placements == repr(lay[n].placements), n
            split += shape != tuple(p.shape)
    assert split > 0


def test_elastic_restore_onto_another_mesh_is_bitwise(ranks):
    """Saved at (2, 2) after a step, restored onto (1, 4): every parameter
    and moment bit for bit, each a DTensor on the target mesh with the
    target placements; the step count too."""
    got = _case(ranks, "elastic")
    assert got["mismatch"] == [] and got["not_on_target"] == []
    assert got["step"] == got["manifest_step"] == 1
    assert got["process_count"] == WORLD


def test_reference_checkpoint_restores_onto_a_mesh(ranks):
    """A checkpoint the reference wrote (fp32 smoke, after one step)
    restores onto a (2, 2) port mesh, leaf for leaf bit for bit."""
    got = _case(ranks, "reference_ckpt")
    assert got["mismatch"] == [] and got["step_ok"] and got["n"] > 0


def test_restart_loop_is_bitwise_on_a_mesh(ranks):
    """Every rank fails at step 3, restores the step-2 checkpoint, and ends
    where an uninterrupted sharded run ends, bit for bit."""
    got = _case(ranks, "restart")
    assert got["restores"] == (0, 1)
    assert got["mismatch"] == []
    assert got["metrics"][0] == got["metrics"][1]
    assert got["latest"] == 4


def _rows(r):
    """Data shard of rank r on the (2, 2) mesh: 2 of the 4 batch rows."""
    i = r // 2
    return slice(2 * i, 2 * i + 2)


@pytest.mark.parametrize("cf", [8, 1])
def test_moe_a2a_matches_the_reference(ranks, ref, cf):
    """In a split step on (2, 2), each rank's output, aux and gradient with
    respect to its data shard of x equal the reference's on a (2, 2)
    fake-device mesh.  The gradient of
    sum(out · ct) is the reference's; the aux enters every rank's loss as
    the whole batch's and the step averages over data, so its gradient on a
    shard is 2 (the data size) times the reference's."""
    _, R = ref
    tag = f"cf{cf}"
    for r in range(WORLD):
        got = _case(ranks, "a2a", r)[tag]
        rows = _rows(r)
        np.testing.assert_allclose(got["out"], R[tag + "_out"][rows],
                                   atol=A2A_TOL, rtol=0)
        assert got["aux"] == pytest.approx(float(R[tag + "_aux"]), rel=1e-6)
        np.testing.assert_allclose(got["gx_sum"], R[tag + "_gx_sum"][rows],
                                   atol=A2A_TOL, rtol=0)
        np.testing.assert_allclose(got["gx_aux"],
                                   2 * R[tag + "_gx_aux"][rows],
                                   atol=A2A_TOL, rtol=0)


@pytest.mark.parametrize("cf", [8, 1])
def test_moe_a2a_weight_gradients_match_the_reference(ranks, ref, cf):
    """The router's and the experts' gradients, gathered whole from each
    rank's block of their mean over the data ranks (the split step's
    gradient): of sum(out · ct) times the data size (the sum over the data
    ranks), of the aux as they are (as the step's data average takes it),
    equal the reference's."""
    _, R = ref
    tag = f"cf{cf}"
    for r in range(WORLD):
        got = _case(ranks, "a2a", r)[tag]
        for w in ("router", "gate", "up", "down"):
            for term in ("sum", "aux"):
                want = R[f"{tag}_g{w}_{term}"]
                np.testing.assert_allclose(
                    got[f"g{w}_{term}"], want, rtol=0,
                    atol=A2A_TOL * max(np.max(np.abs(want)), 1.0))


def test_moe_a2a_drops_only_at_low_capacity(ranks, ref):
    """At capacity factor 8 nothing drops (the output is the global
    dispatch's); at 1 some assignments drop, as the reference's do."""
    _, R = ref
    for r in range(WORLD):
        got = _case(ranks, "a2a", r)
        want = R["global_out"][_rows(r)]
        np.testing.assert_allclose(got["cf8"]["out"], want, atol=A2A_TOL,
                                   rtol=0)
        assert np.max(np.abs(got["cf1"]["out"] - want)) > 1e-3


@pytest.mark.parametrize("case", ["model1", "indivisible"])
def test_moe_a2a_falls_through_to_the_global_dispatch(ranks, ref, case):
    """With a model axis of 1, and with tokens that do not split over the
    4 ranks, ``moe_impl="a2a"`` runs the global dispatch over the whole
    batch (the data shards gathered) and each rank keeps its rows."""
    _, R = ref
    for r in range(WORLD):
        got = _case(ranks, "a2a", r)[case]
        if case == "model1":
            want = R["global_out"][r:r + 1]
        else:
            want = R["global_small_out"][r // 2:r // 2 + 1]
        np.testing.assert_allclose(got, want, atol=A2A_TOL, rtol=0)


def test_compressed_psum_mean_matches_the_reference(ranks, ref):
    """Row r on rank r: every rank's mean equals the reference's under
    ``shard_map`` within 1e-7; it is lossy (above 0) and within 0.05 of
    the true mean; zeros stay exactly zero; a bf16 leaf stays bf16 and
    equals the reference's bf16 result."""
    _, R = ref
    true = R["comp_rows"].mean(axis=0)
    for r in range(WORLD):
        got = _case(ranks, "compress", r)
        np.testing.assert_allclose(got["out"], R["comp_out"][r],
                                   atol=COMPRESS_TOL, rtol=0)
        err = np.max(np.abs(got["out"] - true))
        assert 0.0 < err < 0.05
        assert np.array_equal(got["zeros"], np.zeros(512, np.float32))
        assert np.array_equal(R["comp_zeros"][r], np.zeros(512, np.float32))
        assert got["bf16_dtype"] == "torch.bfloat16"
        np.testing.assert_array_equal(got["bf16"], R["comp_bf16"][r])


def _launch(args, nproc=None, timeout=300):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    cmd = [sys.executable]
    if nproc:
        cmd += ["-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", str(nproc)]
    cmd += ["-m", "repro_torch.launch.train", *args]
    return subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=timeout)


def _final(out: str) -> dict:
    line = [ln for ln in out.splitlines() if ln.startswith("final metrics:")]
    assert len(line) == 1, out
    return eval(line[0].split(":", 1)[1])   # a dict of floats


def test_launch_train_under_torchrun_equals_one_process(tmp_path):
    """``torch.distributed.run --nproc-per-node 2`` trains on a (2, 1)
    mesh through the sharded step and ends with the 1-process run's
    metrics within 1e-5 relative."""
    args = ["--arch", "llama3.2-3b", "--smoke", "--device", "cpu",
            "--steps", "3", "--batch", "4", "--seq", "32", "--log-every",
            "0"]
    one = _launch([*args, "--ckpt-dir", str(tmp_path / "one")])
    two = _launch([*args, "--ckpt-dir", str(tmp_path / "two")], nproc=2)
    assert one.returncode == 0, one.stdout + one.stderr
    assert two.returncode == 0, two.stdout + two.stderr
    assert "mesh={'data': 2, 'model': 1}" in two.stdout
    assert two.stdout.count("final metrics:") == 1   # rank 0 prints
    a, b = _final(one.stdout), _final(two.stdout)
    assert set(a) == set(b)
    for k in a:
        assert b[k] == pytest.approx(a[k], rel=1e-5, abs=1e-12), k


def test_production_mesh_refused_at_world_size_2(tmp_path):
    """``--production-mesh`` at 2 ranks exits naming the 256 it needs."""
    res = _launch(["--arch", "llama3.2-3b", "--smoke", "--device", "cpu",
                   "--steps", "1", "--production-mesh", "--ckpt-dir",
                   str(tmp_path)], nproc=2)
    assert res.returncode != 0
    assert "needs 256 ranks; the process group has 2" in res.stderr
