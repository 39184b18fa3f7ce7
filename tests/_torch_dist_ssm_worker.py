"""The rank side of ``tests/test_torch_distributed_ssm.py``: rwkv6's and
mamba2's layers split over ``model`` in the split step, run by each of 4
gloo ranks on the CPU.

``run(rank, world, store_path, out_dir)`` opens a process group on a
``FileStore``, runs every case in order and writes each rank's results to
``out_dir/rank{r}.pkl`` (numpy arrays and plain values; a case that raises
is recorded with its traceback and the ranks go on to the next).  It
imports torch and the port, never JAX."""
from __future__ import annotations

import os
import pickle
import traceback
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.distribution import sharding as shd
from repro_torch.distribution import tensor_parallel as tp
from repro_torch.models import mamba2 as m2
from repro_torch.models import rwkv6
from repro_torch.models import transformer as T
from repro_torch.train import sharded

import _torch_dist_worker as W

#: (arch, config overrides), each run in float64 (see the test's
#: docstring): the chunked WKV runs its plain version
#: (``pallas_interpret``); ``rwkv_cols``' 3 heads divide no model axis
#: above one while its d_model does (the gathered-columns case)
CASES = {
    "rwkv": ("rwkv6-3b", dict(pallas_interpret=True)),
    "rwkv_cols": ("rwkv6-3b", dict(pallas_interpret=True, rwkv_heads=3,
                                   d_model=96)),
    "zamba": ("zamba2-1.2b", dict(pallas_interpret=True)),
}
#: (case, seq, mesh) of the gradient cases: 64 takes the chunked WKV and
#: SSD, 32 their scans; (1, 4) is where the counts are taken
GRAD_CASES = [("rwkv", 64, "2x2"), ("rwkv", 64, "1x4"),
              ("rwkv_cols", 32, "2x2"), ("rwkv_cols", 64, "2x2"),
              ("zamba", 64, "2x2"), ("zamba", 64, "1x4")]
#: the controls, each on zamba at seq 32 on (2, 2)
CONTROLS = ("norm_without_sum", "in_proj_storage_chunk")
#: the prefill's tokens, then one decode step
PREFILL = 64
#: step cases, run on (2, 2)
STEP_CASES = ("rwkv", "zamba")
STEP_SEQ = 32
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
#: the optimizer of every case (``launch.train``'s for 2 steps)
TCFG = W.tcfg_for("rwkv")


def cfg_for(case: str):
    arch, over = CASES[case]
    return W.get_smoke_config(arch).replace(dtype="float64", **over)


def batch_at(cfg, step: int, seq: int) -> dict:
    b = W.SyntheticLM(W.DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                   global_batch=W.BATCH)).batch_at(step)
    return {k: torch.from_numpy(v) for k, v in b.items()}


def prompt(cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """The prefill's tokens (2, PREFILL) and the decode step's (2, 1)."""
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, PREFILL + 1))
    return (torch.from_numpy(toks[:, :PREFILL]),
            torch.from_numpy(toks[:, PREFILL:]))


def _grads(cfg, seq, mesh):
    model, _ = sharded.shard_(W.model_for(cfg), cfg, mesh)
    return W.split_grads(cfg, TCFG, model, batch_at(cfg, 0, seq),
                         mesh)[0]


def case_grads(meshes, out):
    """The first batch's gradients of each gradient case, with the heads
    each ``wkv_chunked`` and chunked Mamba core call saw."""
    wkv, core = rwkv6.wkv_ops.wkv_chunked, m2.mamba2_core_chunked
    heads = []

    def wkv_counted(r, *args, **kwargs):
        heads.append(("wkv", r.shape[2]))
        return wkv(r, *args, **kwargs)

    def core_counted(p, cfg, xbc_act, dt_raw, *args, **kwargs):
        heads.append(("core", dt_raw.shape[-1]))
        return core(p, cfg, xbc_act, dt_raw, *args, **kwargs)

    rwkv6.wkv_ops.wkv_chunked, m2.mamba2_core_chunked = wkv_counted, \
        core_counted
    try:
        for case, seq, mesh in GRAD_CASES:
            heads.clear()
            grads = _grads(cfg_for(case), seq, meshes[mesh])
            out[f"grads/{case}/{seq}/{mesh}"] = {"grads": grads,
                                                 "heads": list(heads)}
    finally:
        rwkv6.wkv_ops.wkv_chunked, m2.mamba2_core_chunked = wkv, core


REAL_COLUMNS = m2._columns


def _storage_chunk_columns(cfg, j, m, device):
    """The control's columns: in_proj's parts read from the rank's storage
    chunk on as if it lined up with them (wrapping at the end)."""
    cols, chans = REAL_COLUMNS(cfg, j, m, device)
    width = 2 * cfg.mamba_d_inner + 2 * cfg.ssm_state + cfg.mamba_heads
    start = j * (width // m)
    return (start + torch.arange(cols.numel(), device=device)) % width, chans


def case_controls(mesh22, out):
    """zamba at seq 32 on (2, 2) with the gated norm's sum over ``model``
    left out, then with ``in_proj`` cut as its storage chunk."""
    cfg = cfg_for("zamba")
    real = m2.tp
    m2.tp = SimpleNamespace(**{**vars(real),
                               "sum_over": lambda x, groups=None: x})
    try:
        out["control/norm_without_sum"] = _grads(cfg, 32, mesh22)
    finally:
        m2.tp = real
    m2._columns = _storage_chunk_columns
    try:
        out["control/in_proj_storage_chunk"] = _grads(cfg, 32, mesh22)
    finally:
        m2._columns = REAL_COLUMNS


def _gather_vocab(logits, mesh):
    """This rank's vocab chunk of the logits, whole over ``model``."""
    group = mesh.get_group("model")
    parts = [torch.empty_like(logits)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, logits.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


def _leaves(tree, prefix="") -> dict:
    """Every tensor leaf of a cache, by path, as numpy; ints as they
    are."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: W.to_numpy(tree) if isinstance(tree, torch.Tensor)
                else tree}
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def case_serve(mesh14, out):
    """``T.prefill`` over 64 tokens and one ``T.decode_step`` under a
    split step on (1, 4): the logits gathered over the vocab and every
    leaf of the caches the calls return."""
    for case in ("rwkv", "zamba"):
        cfg = cfg_for(case)
        model, _ = sharded.shard_(W.model_for(cfg), cfg, mesh14)
        toks, nxt = prompt(cfg)
        with shd.use_sharding(mesh14), tp.use_split(model, mesh14):
            logits, cache = T.prefill(model, cfg, toks)
            logits = _gather_vocab(logits, mesh14)
            step, cache2 = T.decode_step(model, cfg, nxt, cache)
            step = _gather_vocab(step, mesh14)
        out[f"serve/{case}"] = {
            "prefill": W.to_numpy(logits), "decode": W.to_numpy(step),
            "cache": _leaves(cache), "cache2": _leaves(cache2)}


def case_steps(mesh22, out):
    """Two steps of each step case at seq 32 on (2, 2)."""
    for case in STEP_CASES:
        cfg = cfg_for(case)
        model, state = sharded.shard_(W.model_for(cfg), cfg, mesh22)
        step = sharded.make_sharded_train_step(cfg, TCFG, mesh22)
        metrics = []
        for s in range(2):
            model, state, m = step(model, state, batch_at(cfg, s,
                                                          STEP_SEQ))
            metrics.append(W._metrics(m))
        out[f"steps/{case}"] = {"metrics": metrics,
                                **W.whole_state(model, state)}


def run(rank: int, world: int, store_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    out: dict = {}
    try:
        meshes = {name: init_device_mesh("cpu", shape,
                                         mesh_dim_names=("data", "model"))
                  for name, shape in MESHES.items()}
        cases = [
            ("grads", lambda: case_grads(meshes, out)),
            ("control", lambda: case_controls(meshes["2x2"], out)),
            ("serve", lambda: case_serve(meshes["1x4"], out)),
            ("steps", lambda: case_steps(meshes["2x2"], out)),
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
