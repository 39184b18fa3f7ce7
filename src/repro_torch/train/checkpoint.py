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
package can.  ``restore`` writes into the template's tensors in place.
Restoring onto other shardings waits for ROADMAP queue 1 item 9b.
"""
from __future__ import annotations

import json
import os
import shutil
import zipfile

import numpy as np
import torch

from repro_torch.models.convert import (
    from_numpy, jax_path, to_jax_tree, to_numpy,
)

UNPORTED_RESHARD = (
    "restoring onto other shardings (elastic restarts over a mesh) is not "
    "ported yet: ROADMAP queue 1 item 9b (sharded training)")
_BF16 = np.dtype("V2")


def _state_named(template) -> dict:
    """{reference key: [(slice index, the tensor that slice restores
    into)]} for a template ``{"params": model, "opt_state": state}``
    (opt_state optional)."""
    out = {}
    for name, p in template["params"].named_parameters():
        keys, ix = jax_path(name)
        out.setdefault("/".join(("params", *keys)), []).append((ix, p))
    st = template.get("opt_state")
    if st is not None:
        out["opt_state/step"] = [((), st["step"])]
        for part in ("m", "v"):
            for name, t in st[part].items():
                keys, ix = jax_path(name)
                out.setdefault("/".join(("opt_state", part, *keys)),
                               []).append((ix, t))
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
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    state = {"params": to_jax_tree(dict(params.named_parameters()))}
    if opt_state is not None:
        state["opt_state"] = {"step": to_numpy(opt_state["step"]),
                              "m": to_jax_tree(opt_state["m"]),
                              "v": to_jax_tree(opt_state["v"])}
    arrays = _flatten(state)
    _savez(os.path.join(tmp, "arrays_0.npz"), arrays)
    manifest = {
        "step": step,
        "keys": sorted(arrays.keys()),
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": {k: "bfloat16" if v.dtype == _BF16 else str(v.dtype)
                   for k, v in arrays.items()},
        "process_count": 1,
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic completion marker
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
    leaf, cast to the tensor's dtype, in place.  Returns (template,
    manifest)."""
    if shardings is not None:
        raise NotImplementedError(UNPORTED_RESHARD)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(final, "arrays_0.npz")) as data:
        for key, parts in _state_named(template).items():
            arr = data[key]
            stacked = tuple(max(ix[a] for ix, _ in parts) + 1
                            for a in range(len(parts[0][0])))
            want = (*stacked, *parts[0][1].shape)
            if tuple(arr.shape) != want:
                raise ValueError(f"shape mismatch for {key}: ckpt "
                                 f"{arr.shape} vs template {want}")
            for ix, t in parts:
                t.copy_(from_numpy(arr[ix], "cpu"))
            del arr
    return template, manifest


def gc_old(ckpt_dir: str, keep: int = 3):
    """Delete all but the newest `keep` complete checkpoints."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
        if n.startswith("step_") and not n.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
