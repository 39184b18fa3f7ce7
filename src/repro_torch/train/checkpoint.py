"""Checkpointing: atomic, restart-safe, in the reference's layout.

Layout (the reference's ``train/checkpoint.py``):
    <dir>/step_<n>.tmp/        — in-progress write
    <dir>/step_<n>/            — complete (atomic rename)
        arrays_0.npz           — flattened leaf arrays
        manifest.json          — step, keys, shapes, dtypes

Keys are the reference's tree paths, every layer's slice stacked on the
leading axes (``params/layers/attn/wq`` (L, d, H, hd), ``opt_state/m/...``,
``opt_state/step``; ``models/convert.py``), so a checkpoint either package
writes loads in the other.  A bfloat16 leaf is written as the reference
writes it, raw 2-byte words under the ``<V2`` descr with ``bfloat16`` in the
manifest, and read by reinterpreting those bits (no ``ml_dtypes``).  The
reference cannot restore such a leaf (``astype`` from ``V2`` raises); this
package can.  ``restore`` writes into the template's tensors in place, or,
given ``shardings`` (``train/sharded.py``'s ``layout`` on a target mesh),
lays each leaf out on that mesh as a new DTensor (the elastic restart).

Under a mesh (a model whose parameters are DTensors, ``train/sharded.py``)
every rank calls ``save``: each DTensor is gathered, rank 0 alone writes,
and the others wait at a barrier until the rename is done.  Every rank reads
the checkpoint on ``restore``, so the ranks share a filesystem.
"""
from __future__ import annotations

import json
import os
import shutil
import zipfile

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.distribution.sharding import (
    distribute, local_shard, set_param,
)
from repro_torch.models.convert import (
    from_numpy, jax_path, to_jax_tree, to_numpy,
)

_BF16 = np.dtype("V2")


def _state_named(template) -> dict:
    """{reference key: [(slice index, the tensor that slice restores
    into, its path in the template)]} for a template ``{"params": model,
    "opt_state": state}`` (opt_state optional); a path is ``("params",
    name)``, ``("opt_state", "m" | "v", name)`` or ``("opt_state",
    "step")``."""
    out = {}
    for name, p in template["params"].named_parameters():
        keys, ix = jax_path(name)
        out.setdefault("/".join(("params", *keys)), []).append(
            (ix, p, ("params", name)))
    st = template.get("opt_state")
    if st is not None:
        out["opt_state/step"] = [((), st["step"], ("opt_state", "step"))]
        for part in ("m", "v"):
            for name, t in st[part].items():
                keys, ix = jax_path(name)
                out.setdefault("/".join(("opt_state", part, *keys)),
                               []).append((ix, t, ("opt_state", part, name)))
    return out


def _lookup(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _put(template, path, t) -> None:
    """Put ``t`` at ``path`` of the template (a parameter is replaced in
    its module)."""
    if path[0] == "params":
        set_param(template["params"], path[1], t)
    else:
        _lookup(template, path[:-1])[path[-1]] = t


def _whole_numpy(named: dict, write: bool) -> dict:
    """{name: numpy} of every tensor, each DTensor gathered (every rank
    takes part, one tensor at a time); empty where this rank does not
    write."""
    out = {}
    for n, t in named.items():
        if isinstance(t, DTensor):
            t = t.full_tensor()
        if write:
            out[n] = to_numpy(t)
    return out


def _flatten(tree: dict, prefix: tuple = ()) -> dict:
    """Nested dict -> {"a/b/c": leaf}, keys sorted at each level (the
    order of the reference's ``tree_flatten_with_path``)."""
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flatten(tree[k], (*prefix, k)))
        else:
            out["/".join((*prefix, k))] = tree[k]
    return out


def _savez(path: str, arrays: dict) -> None:
    """``np.savez``'s archive, with a bfloat16 leaf under the ``<V2`` descr
    that numpy writes for ``ml_dtypes.bfloat16``: each member byte-equal to
    the reference's."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, val in arrays.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if val.dtype == _BF16:
                    np.lib.format.write_array_header_1_0(
                        fid, {"descr": "<V2", "fortran_order": False,
                              "shape": val.shape})
                    fid.write(val.tobytes())
                else:
                    np.lib.format.write_array(fid, val)


def save(ckpt_dir: str, step: int, params, opt_state=None,
         extra: dict | None = None) -> str:
    """Atomic checkpoint write of the model ``params`` and the optimizer's
    ``opt_state``.  Returns the final directory."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    meshed = any(isinstance(p, DTensor) for p in params.parameters())
    write = not meshed or dist.get_rank() == 0
    named = _whole_numpy(dict(params.named_parameters()), write)
    if opt_state is not None:
        moments = {part: _whole_numpy(opt_state[part], write)
                   for part in ("m", "v")}
    if not write:
        dist.barrier()   # rank 0 renames before any rank reads on
        return final
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    state = {"params": to_jax_tree(named)}
    if opt_state is not None:
        state["opt_state"] = {"step": to_numpy(opt_state["step"]),
                              "m": to_jax_tree(moments["m"]),
                              "v": to_jax_tree(moments["v"])}
    arrays = _flatten(state)
    _savez(os.path.join(tmp, "arrays_0.npz"), arrays)
    manifest = {
        "step": step,
        "keys": sorted(arrays.keys()),
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": {k: "bfloat16" if v.dtype == _BF16 else str(v.dtype)
                   for k, v in arrays.items()},
        "process_count": dist.get_world_size() if meshed else 1,
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic completion marker
    if meshed:
        dist.barrier()
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


@torch.no_grad()
def restore(ckpt_dir: str, step: int, template, shardings=None):
    """Restore into ``template`` (``{"params": model, "opt_state": state}``,
    opt_state optional): each tensor takes its slice of the checkpoint's
    leaf, cast to the tensor's dtype, in place (a DTensor into its own
    shard).  With ``shardings`` (the same tree of ``NamedSharding``s,
    ``sharded.layout``) each tensor is replaced by a DTensor laid out by its
    sharding instead, on that mesh; ``step`` stays a plain tensor every rank
    holds.  Returns (template, manifest)."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(final, "arrays_0.npz")) as data:
        for key, parts in _state_named(template).items():
            arr = data[key]
            stacked = tuple(max(ix[a] for ix, _, _ in parts) + 1
                            for a in range(len(parts[0][0])))
            want = (*stacked, *parts[0][1].shape)
            if tuple(arr.shape) != want:
                raise ValueError(f"shape mismatch for {key}: ckpt "
                                 f"{arr.shape} vs template {want}")
            for ix, t, path in parts:
                val = from_numpy(arr[ix], "cpu").to(t.dtype)
                if shardings is not None and path[-1] != "step":
                    sh = _lookup(shardings, path)
                    _put(template, path, distribute(
                        val.to(sh.mesh.device_type), sh))
                elif isinstance(t, DTensor):
                    t.to_local().copy_(
                        local_shard(val, t.device_mesh, t.placements))
                else:
                    t.copy_(val)
            del arr
    return template, manifest


def gc_old(ckpt_dir: str, keep: int = 3):
    """Delete all but the newest `keep` complete checkpoints (on rank 0 of
    an open process group)."""
    if dist.is_initialized() and dist.get_rank() != 0:
        return
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
        if n.startswith("step_") and not n.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
