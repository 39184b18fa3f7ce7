"""The rank side of ``tests/test_torch_distributed.py``: every case that
needs several ranks, run by each of 4 gloo ranks on the CPU.

``run(rank, world, store_path, inputs_path, out_dir)`` opens a process group
on a ``FileStore``, runs every case in order and writes each rank's results
to ``out_dir/rank{r}.pkl`` (numpy arrays and plain values; a case that
raises is recorded with its traceback and the ranks go on to the next, so
one fault fails its tests only).  It imports torch and the port, never JAX,
so a rank starts fast."""
from __future__ import annotations

import functools
import os
import pickle
import threading
import traceback
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor

from repro_torch.configs import get_smoke_config
from repro_torch.distribution import compression as comp
from repro_torch.distribution import sharding as shd
from repro_torch.distribution import tensor_parallel as tp
from repro_torch.models import common
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as T
from repro_torch.models.common import jax_path
from repro_torch.models.convert import to_numpy
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train import sharded
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.train.fault_tolerance import (
    InjectedFailure, ResilientLoop, elastic_restore,
)
from repro_torch.train.train_step import TrainConfig, make_grads_fn

SEQ = 32
BATCH = 4
#: (arch, config overrides, microbatches, steps, moe_aux_coef)
STEP_CASES = {
    "yi": ("yi-6b", {}, 1, 2, 1e-2),
    "llama_mb2": ("llama3.2-3b", dict(attn_impl="pallas_mapped",
                                      attn_block=16, pallas_interpret=True),
                  2, 2, 1e-2),
    "moonshot_a2a": ("moonshot-v1-16b-a3b",
                     dict(moe_impl="a2a", capacity_factor=8.0), 1, 2, 0.0),
    "moonshot_global": ("moonshot-v1-16b-a3b", {}, 1, 2, 1e-2),
    # 2 groups: each data rank's own at (2, 2), each over 2 data ranks at
    # (4, 1)
    "moonshot_grouped": ("moonshot-v1-16b-a3b", dict(moe_groups=2), 1, 2,
                         1e-2),
    "deepseek": ("deepseek-v2-236b", {}, 1, 2, 1e-2),
    # 12 q heads in 3 groups of 4: at model 2 or 4 a rank's q heads cover
    # part of a group (the kv heads expanded per q head)
    "yi_part_groups": ("yi-6b", dict(n_heads=12, n_kv_heads=3, head_dim=8),
                       1, 2, 1e-2),
}
#: the other families, whose first batch's gradients are held on every
#: mesh: rwkv6's time and channel mixes, mamba2's layers and zamba2's
#: shared block, whisper's encoder and cross-attention and the vlm's cross
#: layers split (``tests/test_torch_distributed_ssm.py`` holds rwkv6 and
#: mamba2 at seq 64, where their chunked forms run, an rwkv6 whose heads
#: do not divide ``model``, their caches and their steps)
FAMILY_CASES = {
    "rwkv": ("rwkv6-3b", {}, 1, 2, 1e-2),
    "zamba": ("zamba2-1.2b", {}, 1, 2, 1e-2),
    "whisper": ("whisper-medium", {}, 1, 2, 1e-2),
    "vlm": ("llama-3.2-vision-11b", {}, 1, 2, 1e-2),
}
CASES = {**STEP_CASES, **FAMILY_CASES}
#: step cases whose steps run in float64 (their gradients are held in fp32
#: too): see ``tests/test_torch_distributed.py``'s docstring
FLOAT64_STEPS = ("yi", "moonshot_global", "moonshot_grouped", "deepseek",
                 "yi_part_groups")
#: cases whose gradients are held in float64 (the same docstring)
FLOAT64_GRADS = ("rwkv",)
#: the (data, model) meshes every case runs on
MESHES = {"2x2": (2, 2), "1x4": (1, 4), "4x1": (4, 1)}


def tcfg_for(case: str) -> TrainConfig:
    """The optimizer ``launch.train`` builds for a run of this many
    steps."""
    _, _, mb, steps, aux = CASES[case]
    return TrainConfig(optimizer=opt.OptimizerConfig(
        lr=3e-4, warmup_steps=max(steps // 20, 5), total_steps=steps),
        microbatches=mb, moe_aux_coef=aux)


def cfg_for(case: str, step: bool = False):
    """The case's smoke config; ``step``: as its step runs, else as its
    gradients are held."""
    arch, over, *_ = CASES[case]
    cfg = get_smoke_config(arch).replace(**over)
    if case in (FLOAT64_STEPS if step else FLOAT64_GRADS):
        cfg = cfg.replace(dtype="float64")
    return cfg


def model_for(cfg, seed: int = 0):
    return T.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")


def rows_for(case: str, mesh: str) -> int:
    """The global batch of a case on a mesh: BATCH rows, or as many as
    its microbatches need to split over the data ranks."""
    return max(BATCH, CASES[case][2] * MESHES[mesh][0])


def batch_at(cfg, step: int, rows: int = BATCH) -> dict:
    """SyntheticLM's batch, with seeded vision states or frames where the
    family takes them (``launch.train``'s)."""
    b = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                               global_batch=rows)).batch_at(step)
    out = {k: torch.from_numpy(v) for k, v in b.items()}
    if cfg.family in ("vlm", "audio"):
        n = cfg.vision_seq if cfg.family == "vlm" else cfg.encoder_seq
        out["extra"] = torch.from_numpy(np.random.default_rng(step)
                                        .standard_normal((rows, n, cfg.d_model),
                                                         dtype=np.float32)
                                        * 0.1)
    return out


def _whole(t) -> np.ndarray:
    if isinstance(t, torch.distributed.tensor.DTensor):
        t = t.full_tensor()
    return to_numpy(t)


def whole_state(model, state) -> dict:
    """Every tensor gathered to numpy (every rank takes part)."""
    out = {"params": {n: _whole(p) for n, p in model.named_parameters()}}
    if state is not None:
        out["m"] = {n: _whole(t) for n, t in state["m"].items()}
        out["v"] = {n: _whole(t) for n, t in state["v"].items()}
        out["step"] = int(state["step"])
    return out


def _metrics(m: dict) -> dict:
    return {k: float(v) for k, v in m.items()}


def case_steps(meshes, out):
    """Every step case on every mesh: metrics, the whole state after its
    steps, the a2a dispatch's calls, each parameter's block."""
    a2a = moe_mod.moe_apply_a2a
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return a2a(*args, **kwargs)

    for case in STEP_CASES:
        for name, mesh in meshes.items():
            cfg, tcfg = cfg_for(case, step=True), tcfg_for(case)
            rows = rows_for(case, name)
            model, state = sharded.shard_(model_for(cfg), cfg, mesh)
            step = sharded.make_sharded_train_step(cfg, tcfg, mesh)
            metrics = []
            calls.clear()
            moe_mod.moe_apply_a2a = counted
            try:
                for s in range(STEP_CASES[case][3]):
                    model, state, m = step(model, state,
                                           batch_at(cfg, s, rows))
                    metrics.append(_metrics(m))
            finally:
                moe_mod.moe_apply_a2a = a2a
            res = {"metrics": metrics, **whole_state(model, state),
                   "a2a_calls": len(calls),
                   "local": {n: (tuple(p.to_local().shape),
                                 repr(p.placements))
                             for n, p in model.named_parameters()},
                   "coord": mesh.get_coordinate()}
            out[f"steps/{case}/{name}"] = res


def _whole_block(g, w: DTensor) -> np.ndarray:
    """A gradient block of parameter ``w`` gathered whole (every rank
    takes part)."""
    return _whole(DTensor.from_local(
        g.contiguous(), w.device_mesh, w.placements, run_check=False,
        shape=w.shape, stride=w.stride()))


def split_grads(cfg, tcfg, model, batch, mesh):
    """The split step's gradients of one batch, each gathered whole (every
    rank takes part), and the MoE drops of each dispatch on this rank."""
    grads_of = make_grads_fn(cfg, tcfg, local=functools.partial(
        sharded.shard_rows, mesh=mesh))
    with moe_mod.record_routing() as rec, shd.use_sharding(mesh), \
            tp.use_split(model, mesh):
        _, _, grads = grads_of(model, batch)
    named = dict(model.named_parameters())
    whole = {n: _whole_block(g, named[n]) for n, g in grads.items()}
    return whole, [int((~r["keep"]).sum()) for r in rec]


def case_grads(meshes, out):
    """Every case's first-batch gradients on every mesh (held before the
    optimizer, where fp32 rounding is not amplified), with the MoE drops;
    then the control: yi on (1, 4) with the MLPs' row-parallel all-reduce
    left out."""
    for case in CASES:
        for name, mesh in meshes.items():
            cfg, tcfg = cfg_for(case), tcfg_for(case)
            model, _ = sharded.shard_(model_for(cfg), cfg, mesh)
            grads, drops = split_grads(cfg, tcfg, model, batch_at(
                cfg, 0, rows_for(case, name)), mesh)
            out[f"grads/{case}/{name}"] = {
                "grads": grads, "drops": drops,
                "coord": mesh.get_coordinate()}
    real = common.tp
    common.tp = SimpleNamespace(**{**vars(real),
                                   "reduce_out": lambda x: x})
    try:
        cfg, tcfg = cfg_for("yi"), tcfg_for("yi")
        mesh = meshes["1x4"]
        model, _ = sharded.shard_(model_for(cfg), cfg, mesh)
        out["grads_control"] = {"grads": split_grads(
            cfg, tcfg, model, batch_at(cfg, 0, rows_for("yi", "1x4")),
            mesh)[0]}
    finally:
        common.tp = real


def case_thread_backward(mesh14, out):
    """yi's split step on (1, 4), its backward (and so remat's recompute)
    run in another thread, as autograd runs a CUDA backward in a device
    thread, which holds none of the forward's thread-local contexts: the
    gradients against the same step's in the forward's thread."""
    from repro_torch.train.train_step import lm_loss

    cfg, tcfg = cfg_for("yi"), tcfg_for("yi")
    batch = batch_at(cfg, 0)
    grads = []
    for threaded in (False, True):
        model, _ = sharded.shard_(model_for(cfg), cfg, mesh14)
        with shd.use_sharding(mesh14), tp.use_split(model, mesh14):
            leaves = list(model.parameters())
            for p in leaves:
                p.requires_grad_(True)
            loss, _ = lm_loss(model, cfg, sharded.shard_rows(batch, mesh14))
            box = []
            def run():
                box.append(torch.autograd.grad(loss, leaves))

            if threaded:
                t = threading.Thread(target=run)
                t.start()
                t.join(timeout=120)
                assert not t.is_alive()
            else:
                run()
        grads.append([g.numpy() for g in box[0]])
    out["thread_backward"] = {"equal": all(
        np.array_equal(a, b) for a, b in zip(*grads)), "n": len(grads[1])}


def case_norm_control(mesh22, out):
    """The yi case with every shard counted in the norm, replicas too."""
    owns = sharded._owns
    sharded._owns = lambda mesh, placements: True
    try:
        cfg, tcfg = cfg_for("yi", step=True), tcfg_for("yi")
        model, state = sharded.shard_(model_for(cfg), cfg, mesh22)
        step = sharded.make_sharded_train_step(cfg, tcfg, mesh22)
        metrics = []
        for s in range(STEP_CASES["yi"][3]):
            model, state, m = step(model, state, batch_at(cfg, s))
            metrics.append(_metrics(m))
        out["norm_control"] = {"metrics": metrics,
                               **whole_state(model, state)}
    finally:
        sharded._owns = owns


def _mismatches(a: dict, b: dict) -> list:
    bad = []
    for part in ("params", "m", "v"):
        for n in a[part]:
            if not np.array_equal(a[part][n].view(np.uint8),
                                  b[part][n].view(np.uint8)):
                bad.append(f"{part}/{n}")
    return bad


def case_elastic(mesh22, mesh14, out, ckpt_dir):
    """Save at (2, 2) after a step, restore onto (1, 4) bit for bit."""
    cfg, tcfg = cfg_for("yi"), tcfg_for("yi")
    model, state = sharded.shard_(model_for(cfg), cfg, mesh22)
    step = sharded.make_sharded_train_step(cfg, tcfg, mesh22)
    model, state, _ = step(model, state, batch_at(cfg, 0))
    d = os.path.join(ckpt_dir, "elastic")
    ckpt.save(d, 1, model, state)
    saved = whole_state(model, state)
    other, _ = sharded.shard_(model_for(cfg, seed=7), cfg, mesh22)
    template = {"params": other, "opt_state": opt.init_state(model_for(cfg))}
    lay = sharded.layout(other, cfg, mesh14)
    restored, man = elastic_restore(d, 1, template, lay)
    got = whole_state(restored["params"], restored["opt_state"])
    moved = [n for n, p in restored["params"].named_parameters()
             if p.device_mesh is not mesh14
             or p.placements != lay["params"][n].placements]
    moved += [f"m/{n}" for n, t in restored["opt_state"]["m"].items()
              if t.placements != lay["opt_state"]["m"][n].placements]
    out["elastic"] = {"mismatch": _mismatches(saved, got),
                      "step": got["step"], "manifest_step": man["step"],
                      "not_on_target": moved,
                      "process_count": man["process_count"]}


def case_reference_checkpoint(mesh22, out, ref_dir):
    """A checkpoint the reference wrote restores onto a port mesh, leaf for
    leaf bit for bit."""
    cfg = get_smoke_config("llama3.2-3b")
    step = ckpt.latest_step(ref_dir)
    model, state = sharded.shard_(model_for(cfg, seed=3), cfg, mesh22)
    lay = sharded.layout(model, cfg, mesh22)
    restored, _ = ckpt.restore(ref_dir, step,
                               {"params": model, "opt_state": state},
                               shardings=lay)
    got = whole_state(restored["params"], restored["opt_state"])
    bad = []
    with np.load(os.path.join(ref_dir, f"step_{step:08d}",
                              "arrays_0.npz")) as data:
        for part, prefix in (("params", "params"), ("m", "opt_state/m"),
                             ("v", "opt_state/v")):
            for n, a in got[part].items():
                keys, ix = jax_path(n)
                want = data["/".join((prefix, *keys))][ix]
                if not np.array_equal(a, want):
                    bad.append(f"{part}/{n}")
        step_ok = got["step"] == int(data["opt_state/step"])
    out["reference_ckpt"] = {"mismatch": bad, "step_ok": step_ok,
                             "n": len(got["params"])}


def case_restart(mesh22, out, ckpt_dir):
    """A ``ResilientLoop`` whose every rank fails at step 3 restores the
    step-2 checkpoint and ends bitwise where an uninterrupted run ends."""
    cfg, tcfg = cfg_for("yi"), tcfg_for("yi")

    def run(d, hook):
        model, state = sharded.shard_(model_for(cfg), cfg, mesh22)
        loop = ResilientLoop(
            step_fn=sharded.make_sharded_train_step(cfg, tcfg, mesh22),
            batch_fn=lambda s: batch_at(cfg, s), ckpt_dir=d, ckpt_every=2,
            failure_hook=hook)
        model, state, info = loop.run(model, state, 0, 4)
        return whole_state(model, state), info

    fired = []

    def hook(step):
        if step == 3 and not fired:
            fired.append(step)
            raise InjectedFailure("lost a host")

    a, ia = run(os.path.join(ckpt_dir, "plain"), None)
    b, ib = run(os.path.join(ckpt_dir, "failing"), hook)
    out["restart"] = {"mismatch": _mismatches(a, b),
                      "restores": (ia["restores"], ib["restores"]),
                      "metrics": (_metrics(ia["metrics"]),
                                  _metrics(ib["metrics"])),
                      "latest": ckpt.latest_step(
                          os.path.join(ckpt_dir, "failing"))}


def _moe_params(inp):
    def t(k):
        return torch.from_numpy(inp[k])
    shared = moe_mod.SwiGLU(t("p_shared_gate"), t("p_shared_up"),
                            t("p_shared_down"))
    return moe_mod.MoE(t("p_router"), t("p_gate"), t("p_up"), t("p_down"),
                       shared)


def _moe_shard_(p, cfg, mesh):
    """``p``'s weights laid out on ``mesh`` as DTensors with the
    placements ``sharded.shard_`` gives a model's MoE layer."""
    specs = moe_mod.moe_specs(cfg)
    named = dict(p.named_parameters())
    axes = {}
    for n in named:
        node = specs
        for k in n.split("."):
            node = node[k]
        axes[n] = node
    lay = shd.param_sharding(axes, {n: tuple(w.shape)
                                    for n, w in named.items()}, mesh,
                             shd.PARAM_RULES)
    for n, sh in lay.items():
        shd.set_param(p, n, shd.distribute(named[n].detach(), sh))
    return p


MOE_BASE = dict(d_model=32, n_experts=8, moe_top_k=2, expert_d_ff=64,
                n_shared_experts=1, moe_renormalize=True, moe_groups=1)


def case_a2a(mesh22, mesh41, out, inp):
    """``moe_apply`` with ``moe_impl="a2a"`` in a split step on (2, 2),
    the weights laid out as ``shard_`` lays them and gathered over data as
    a layer gathers them, on each rank's data shard of the reference's x:
    outputs, aux, and the gradients of sum(out · ct) and of aux (x on each
    rank; the router's and the experts' gathered whole from each rank's
    block of the data mean: summed over the data ranks for sum(out · ct),
    averaged for the aux)."""
    i = mesh22.get_local_rank("data")
    rows = slice(2 * i, 2 * i + 2)
    res = {}
    names = ("router", "gate", "up", "down")
    for cf in (8.0, 1.0):
        cfg = SimpleNamespace(**MOE_BASE, capacity_factor=cf, moe_impl="a2a")
        tag = f"cf{int(cf)}"
        p = _moe_shard_(_moe_params(inp), cfg, mesh22)
        x = torch.from_numpy(inp["x"][rows]).requires_grad_(True)
        ct = torch.from_numpy(inp["ct"][rows])
        with shd.use_sharding(mesh22), tp.use_split(p, mesh22):
            ws = [getattr(p, n).requires_grad_(True) for n in names]
            with tp.gather_params(p):
                o, aux = moe_mod.moe_apply(p, cfg, x, with_aux=True)
            g_sum = torch.autograd.grad((o * ct).sum(), [x, *ws],
                                        retain_graph=True)
            g_aux = torch.autograd.grad(aux, [x, *ws], allow_unused=True,
                                        materialize_grads=True)
        res[tag] = {"out": o.detach().numpy(), "aux": float(aux),
                    "gx_sum": g_sum[0].numpy(), "gx_aux": g_aux[0].numpy()}
        for n, gs, ga in zip(names, g_sum[1:], g_aux[1:]):
            res[tag][f"g{n}_sum"] = 2 * _whole_block(gs, getattr(p, n))
            res[tag][f"g{n}_aux"] = _whole_block(ga, getattr(p, n))
    # fall-through: a model axis of 1, and tokens that do not split
    cfg = SimpleNamespace(**MOE_BASE, capacity_factor=8.0, moe_impl="a2a")
    p = _moe_params(inp)
    i4 = mesh41.get_local_rank("data")
    with torch.no_grad(), shd.use_sharding(mesh41):
        res["model1"] = moe_mod.moe_apply(
            p, cfg, torch.from_numpy(inp["x"][i4:i4 + 1])).numpy()
    with torch.no_grad(), shd.use_sharding(mesh22):
        res["indivisible"] = moe_mod.moe_apply(
            p, cfg, torch.from_numpy(inp["xs"][i:i + 1])).numpy()
    out["a2a"] = res


def case_compress(rank, out, inp):
    rows = torch.from_numpy(inp["comp_rows"][rank])
    out["compress"] = {
        "out": comp.compressed_psum_mean_leaf(rows).numpy(),
        "zeros": comp.compressed_psum_mean_leaf(torch.zeros(512)).numpy(),
        "bf16": comp.compressed_psum_mean(
            {"g": rows.to(torch.bfloat16)})["g"].to(torch.float32).numpy(),
        "bf16_dtype": str(comp.compressed_psum_mean_leaf(
            rows.to(torch.bfloat16)).dtype),
    }


def run(rank: int, world: int, store_path: str, inputs_path: str,
        out_dir: str) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    out: dict = {}
    try:
        inp = dict(np.load(inputs_path))
        mesh22 = init_device_mesh("cpu", (2, 2),
                                  mesh_dim_names=("data", "model"))
        mesh14 = init_device_mesh("cpu", (1, 4),
                                  mesh_dim_names=("data", "model"))
        mesh41 = init_device_mesh("cpu", (4, 1),
                                  mesh_dim_names=("data", "model"))
        ckpt_dir = os.path.join(out_dir, "ckpt")
        meshes = {"2x2": mesh22, "1x4": mesh14, "4x1": mesh41}
        cases = [
            ("steps", lambda: case_steps(meshes, out)),
            ("grads", lambda: case_grads(meshes, out)),
            ("thread_backward", lambda: case_thread_backward(mesh14, out)),
            ("norm_control", lambda: case_norm_control(mesh22, out)),
            ("elastic", lambda: case_elastic(mesh22, mesh14, out, ckpt_dir)),
            ("reference_ckpt", lambda: case_reference_checkpoint(
                mesh22, out, os.path.join(out_dir, "ref_ckpt"))),
            ("restart", lambda: case_restart(mesh22, out, ckpt_dir)),
            ("a2a", lambda: case_a2a(mesh22, mesh41, out, inp)),
            ("compress", lambda: case_compress(rank, out, inp)),
        ]
        for name, fn in cases:
            try:
                fn()
            except Exception:   # recorded; the test of this case fails on it
                out["error/" + name] = traceback.format_exc()
            dist.barrier()
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.destroy_process_group()
