"""The rank side of ``tests/test_torch_distributed_decode.py``: decode over
a cache split along ``kv_seq`` (``launch/specs.py``'s ``decode_fn``), run
by each of 4 gloo ranks on the CPU.

``run(rank, world, store_path, ref_params_path, out_dir)`` opens a process
group on a ``FileStore``, runs every case in order and writes each rank's
results to ``out_dir/rank{r}.pkl`` (numpy arrays and plain values; a case
that raises is recorded with its traceback and the ranks go on to the
next).  ``ref_params_path`` holds the reference's smoke weights as numpy
(pickled), loaded through ``params_from_jax``.  It imports torch and the
port, never JAX."""
from __future__ import annotations

import dataclasses
import os
import pickle
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor

from repro_torch.configs import SHAPES, get_smoke_config
from repro_torch.distribution import sharding as shd
from repro_torch.distribution import tensor_parallel as tp
from repro_torch.launch import specs
from repro_torch.models import attention as attn
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.train import sharded

import _torch_dist_ssm_worker as S
import _torch_dist_worker as W

#: (arch, config overrides, mesh, the shape whose rules the step runs
#: under); every case in float64 but ``jax`` (fp32, the reference's
#: weights)
CASES = {
    "gqa": ("yi-6b", {}, "1x4", "decode_32k"),
    "gqa_int8": ("yi-6b", dict(kv_cache_quant=True), "1x4", "decode_32k"),
    # 6 q heads divide no model axis of 4: every rank computes every head
    # (no gather, no cut) over its block, as llama3.2-3b's 24 on 16
    "gqa_whole_heads": ("yi-6b", dict(n_heads=6, n_kv_heads=2), "1x4",
                        "decode_32k"),
    "mla_absorbed": ("deepseek-v2-236b", dict(mla_absorb="auto"), "1x4",
                     "decode_32k"),
    "mla_never": ("deepseek-v2-236b", dict(mla_absorb="never"), "1x4",
                  "decode_32k"),
    "zamba_long": ("zamba2-1.2b", {}, "2x2", "long_500k"),
    "jax": ("yi-6b", {}, "1x4", "decode_32k"),
}
#: the single-device prefill's tokens, then STEPS split decode steps:
#: positions 14-17 cross the first block boundary at MAX_SEQ / 4 = 16
PREFILL, STEPS, MAX_SEQ, ROWS = 14, 4, 64, 2
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}


def cfg_for(case: str):
    arch, over, _, _ = CASES[case]
    cfg = get_smoke_config(arch).replace(max_seq=MAX_SEQ, **over)
    return cfg if case == "jax" else cfg.replace(dtype="float64")


def tokens(cfg) -> torch.Tensor:
    """The prefill's tokens and the decode steps' (ROWS, PREFILL +
    STEPS), teacher-forced."""
    rng = np.random.default_rng(11)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (ROWS, PREFILL + STEPS)))


def model_for(case: str, ref_tree=None):
    cfg = cfg_for(case)
    if case == "jax":
        return params_from_jax(ref_tree, cfg, "cpu")
    return W.model_for(cfg)


def kv_seq_leaves(cfg, cache) -> list:
    """The cache's tensors with a ``kv_seq`` axis."""
    out = []
    specs.tree_map(lambda ax, t: out.append(t) if "kv_seq" in ax else None,
                   specs.cache_specs(cfg), cache)
    return out


def _as_dtensors(axes, old, new):
    """The new blocks of a step as DTensors laid out as the old leaves."""
    return specs.tree_map(
        lambda _, o, n: DTensor.from_local(n, o.device_mesh, o.placements,
                                           run_check=False, shape=o.shape,
                                           stride=o.stride()),
        axes, old, new)


def split_decode(case: str, mesh, ref_tree=None) -> dict:
    """Prefill single-device, lay the cache out under the shape's rules,
    then STEPS split decode steps: the logits (gathered over the vocab)
    and the whole cache after each, the length of every block the
    attention saw, and the ids of the leaves ``_gather_but_batch`` took
    (none may hold ``kv_seq``)."""
    arch, _, _, shape_name = CASES[case]
    cfg = cfg_for(case)
    shape = dataclasses.replace(SHAPES[shape_name], seq_len=MAX_SEQ,
                                global_batch=ROWS)
    rules = specs.act_rules_for(SHAPES[shape_name])
    model = model_for(case, ref_tree)
    toks = tokens(cfg)
    _, cache = T.prefill(model, cfg, toks[:, :PREFILL])
    params, _ = sharded.shard_(model, cfg, mesh)
    axes = specs.cache_specs(cfg)
    cache = specs.lay_out_cache(cfg, cache, mesh, rules)
    fn = specs.decode_fn(cfg, shape, mesh, rules)

    seen, gathered = [], []
    real_softmax, real_gather = attn._block_softmax, specs._gather_but_batch

    def softmax_counted(logits, valid):
        seen.append(logits.shape[-1])
        return real_softmax(logits, valid)

    def gather_counted(t, batch_dim):
        gathered.append(id(t))
        return real_gather(t, batch_dim)

    attn._block_softmax, specs._gather_but_batch = softmax_counted, \
        gather_counted
    logits, caches, kv_hits = [], [], 0
    try:
        for i in range(STEPS):
            kv_ids = {id(t) for t in kv_seq_leaves(cfg, cache)}
            gathered.clear()
            with shd.use_sharding(mesh, act_rules=rules):
                out, new = fn(params, toks[:, PREFILL + i:PREFILL + i + 1],
                              cache, None)
            kv_hits += len(kv_ids & set(gathered))
            cache = _as_dtensors(axes, cache, new)
            logits.append(W.to_numpy(S._gather_vocab(out, mesh)))
            caches.append(S._leaves(specs.tree_map(
                lambda _, t: t.full_tensor(), axes, cache)))
    finally:
        attn._block_softmax, specs._gather_but_batch = real_softmax, \
            real_gather
    return {"logits": logits, "caches": caches, "block_lengths": seen,
            "kv_seq_gathered": kv_hits, "other_gathered": len(gathered)}


def case_control(meshes, out):
    """The GQA case with the combine skipped: each rank normalises every
    head over its own block alone (one block's stack)."""
    real = tp.seq_stack
    tp.seq_stack = lambda x, blk: x[None]
    try:
        out["control/local_softmax"] = split_decode("gqa", meshes["1x4"])
    finally:
        tp.seq_stack = real


def run(rank: int, world: int, store_path: str, ref_params_path: str,
        out_dir: str) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    out: dict = {}
    try:
        with open(ref_params_path, "rb") as f:
            ref_tree = pickle.load(f)
        meshes = {name: init_device_mesh("cpu", shape,
                                         mesh_dim_names=("data", "model"))
                  for name, shape in MESHES.items()}
        cases = [(f"decode/{case}", lambda case=case: out.__setitem__(
            f"decode/{case}", split_decode(case, meshes[CASES[case][2]],
                                           ref_tree)))
            for case in CASES]
        cases.append(("control", lambda: case_control(meshes, out)))
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
