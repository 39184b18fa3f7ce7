"""The rank side of ``tests/test_torch_distributed.py``: every case that
needs several ranks, run by each of 4 gloo ranks on the CPU.

``run(rank, world, store_path, inputs_path, out_dir)`` opens a process group
on a ``FileStore``, runs every case in order and writes each rank's results
to ``out_dir/rank{r}.pkl`` (numpy arrays and plain values; a case that
raises is recorded with its traceback and the ranks go on to the next, so
one fault fails its tests only).  It imports torch and the port, never JAX,
so a rank starts fast."""
from __future__ import annotations

import os
import pickle
import traceback
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs import get_smoke_config
from repro_torch.distribution import compression as comp
from repro_torch.distribution import sharding as shd
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
from repro_torch.train.train_step import TrainConfig

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
}


def tcfg_for(case: str) -> TrainConfig:
    """The optimizer ``launch.train`` builds for a run of this many
    steps."""
    _, _, mb, steps, aux = STEP_CASES[case]
    return TrainConfig(optimizer=opt.OptimizerConfig(
        lr=3e-4, warmup_steps=max(steps // 20, 5), total_steps=steps),
        microbatches=mb, moe_aux_coef=aux)


def cfg_for(case: str):
    arch, over, *_ = STEP_CASES[case]
    return get_smoke_config(arch).replace(**over)


def model_for(cfg, seed: int = 0):
    return T.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")


def batch_at(cfg, step: int) -> dict:
    b = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                               global_batch=BATCH)).batch_at(step)
    return {k: torch.from_numpy(v) for k, v in b.items()}


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


def case_steps(mesh22, out):
    a2a = moe_mod.moe_apply_a2a
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return a2a(*args, **kwargs)

    for case in STEP_CASES:
        cfg, tcfg = cfg_for(case), tcfg_for(case)
        model, state = sharded.shard_(model_for(cfg), cfg, mesh22)
        step = sharded.make_sharded_train_step(cfg, tcfg, mesh22)
        metrics = []
        calls.clear()
        moe_mod.moe_apply_a2a = counted
        try:
            for s in range(STEP_CASES[case][3]):
                model, state, m = step(model, state, batch_at(cfg, s))
                metrics.append(_metrics(m))
        finally:
            moe_mod.moe_apply_a2a = a2a
        res = {"metrics": metrics, **whole_state(model, state),
               "a2a_calls": len(calls),
               "local": {n: (tuple(p.to_local().shape), repr(p.placements))
                         for n, p in model.named_parameters()},
               "coord": mesh22.get_coordinate()}
        out["steps/" + case] = res


def case_norm_control(mesh22, out):
    """The yi case with every shard counted in the norm, replicas too."""
    owns = sharded._owns
    sharded._owns = lambda mesh, placements: True
    try:
        cfg, tcfg = cfg_for("yi"), tcfg_for("yi")
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


def _moe_params(inp, grad: bool):
    def t(k):
        return torch.from_numpy(inp[k]).requires_grad_(grad)
    shared = moe_mod.SwiGLU(t("p_shared_gate"), t("p_shared_up"),
                            t("p_shared_down"))
    p = moe_mod.MoE(t("p_router"), t("p_gate"), t("p_up"), t("p_down"),
                    shared)
    if grad:
        for w in p.parameters():
            w.requires_grad_(True)
    return p


MOE_BASE = dict(d_model=32, n_experts=8, moe_top_k=2, expert_d_ff=64,
                n_shared_experts=1, moe_renormalize=True, moe_groups=1)


def case_a2a(mesh22, mesh41, out, inp):
    """``moe_apply`` with ``moe_impl="a2a"`` on each rank's data shard of
    the reference's x: outputs, aux, and the gradients of sum(out · ct) and
    of aux (x on each rank; router and experts summed / averaged over the
    data ranks)."""
    i = mesh22.get_local_rank("data")
    rows = slice(2 * i, 2 * i + 2)
    data_group = mesh22.get_group("data")
    res = {}
    for cf in (8.0, 1.0):
        cfg = SimpleNamespace(**MOE_BASE, capacity_factor=cf, moe_impl="a2a")
        tag = f"cf{int(cf)}"
        p = _moe_params(inp, True)
        x = torch.from_numpy(inp["x"][rows]).requires_grad_(True)
        ct = torch.from_numpy(inp["ct"][rows])
        with shd.use_sharding(mesh22):
            o, aux = moe_mod.moe_apply(p, cfg, x, with_aux=True)
        names = ("router", "gate", "up", "down")
        ws = [getattr(p, n) for n in names]
        g_sum = torch.autograd.grad((o * ct).sum(), [x, *ws],
                                    retain_graph=True)
        g_aux = torch.autograd.grad(aux, [x, *ws], allow_unused=True,
                                    materialize_grads=True)
        res[tag] = {"out": o.detach().numpy(), "aux": float(aux),
                    "gx_sum": g_sum[0].numpy(), "gx_aux": g_aux[0].numpy()}
        for n, gs, ga in zip(names, g_sum[1:], g_aux[1:]):
            gs, ga = gs.clone(), ga.clone()
            dist.all_reduce(gs, group=data_group)
            dist.all_reduce(ga, group=data_group)
            res[tag][f"g{n}_sum"] = gs.numpy()
            res[tag][f"g{n}_aux"] = (ga / 2).numpy()
    # fall-through: a model axis of 1, and tokens that do not split
    cfg = SimpleNamespace(**MOE_BASE, capacity_factor=8.0, moe_impl="a2a")
    p = _moe_params(inp, False)
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
        cases = [
            ("steps", lambda: case_steps(mesh22, out)),
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
