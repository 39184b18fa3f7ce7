"""Mesh construction over ``torch.distributed``.

FUNCTIONS, not module-level constants: importing this module touches no
device and no process group.  A mesh spans every rank of the default process
group, which the caller opens (``init_distributed`` under
``torch.distributed.run``); its dim names are the reference's axis names.
The device type is ``cuda`` unless the caller asks for the CPU, and a
``cuda`` mesh needs an NCCL group: nothing falls back to gloo.  Only the
dry run (``launch/dryrun.py --arch``) asks for ``fake=True``: a CPU mesh
over a ``"fake"`` process group (``torch.testing``'s ``FakeStore``), whose
collectives move nothing; every other mesh refuses that backend.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_distributed(device_type: str = "cuda") -> None:
    """Open the default process group from ``torch.distributed.run``'s
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``PORT``): NCCL on
    ``cuda``, with this process on card ``LOCAL_RANK``; gloo on the CPU."""
    kw = {}
    if device_type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group(BACKENDS[device_type], **kw)


def _make_mesh(shape: tuple, names: tuple, device_type: str,
               fake: bool = False) -> DeviceMesh:
    need = math.prod(shape)
    layout = dict(zip(names, shape))
    if not dist.is_initialized():
        raise RuntimeError(f"mesh {layout} needs {need} ranks and no process "
                           "group is open: run under torch.distributed.run")
    have = dist.get_world_size()
    if have != need:
        raise ValueError(f"mesh {layout} needs {need} ranks; the process "
                         f"group has {have}")
    backend = dist.get_backend()
    want = "fake" if fake else BACKENDS[device_type]
    if fake and device_type != "cpu":
        raise ValueError("a fake mesh lives on the CPU")
    if backend != want:
        raise ValueError(f"a {'fake ' if fake else ''}{device_type} mesh "
                         f"needs the {want} backend, not {backend}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda",
                         fake: bool = False) -> DeviceMesh:
    """16x16 = 256 ranks/pod; multi_pod adds a leading 2-pod axis (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device_type, fake)


def make_local_mesh(data: int | None = None, model: int = 1,
                    device_type: str = "cuda",
                    fake: bool = False) -> DeviceMesh:
    """Mesh over whatever ranks exist (tests / CPU runs)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if data is None:
        data = n // model
    return _make_mesh((data, model), ("data", "model"), device_type, fake)
