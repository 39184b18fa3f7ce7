"""Training launcher: random weights, the synthetic data, the
checkpoint-restart loop; on one device, or sharded over every rank of a
``torch.distributed.run`` job.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        --steps 3 --batch 2 --seq 4096 --microbatches 2
    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 2 -m repro_torch.launch.train --arch llama3.2-3b \
        --smoke --device cpu

Runs on ``--device`` (default ``cuda``); on a machine without a card it
refuses to start unless ``--device cpu`` (then ``--smoke`` for the reduced
config; the tri_attn kernel's plain version stands in for it).  Weights are
random, from a ``torch.Generator`` seeded 0, in the config's dtype; the
attention runs the tri_attn kernel (``attn_impl="pallas_mapped"``) where the
config's attention reaches it.  Under ``torch.distributed.run`` (``RANK``
and ``WORLD_SIZE`` set) it opens the process group (NCCL on ``cuda``, one
card a rank; gloo with ``--device cpu``), lays the model and the optimizer
state out on ``make_local_mesh()`` (``--production-mesh``:
``make_production_mesh()``, which needs 256 ranks) and trains through the
sharded step (``train/sharded.py``); rank 0 prints.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import transformer as T
from repro_torch.models.common import count_params
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train import sharded
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.train.fault_tolerance import ResilientLoop, StepWatchdog
from repro_torch.train.train_step import TrainConfig, make_train_step

NO_CARD = ("no CUDA device: pass --device cpu to train on the CPU (with "
           "--smoke for the reduced config)")


def _mesh(args, device_type: str):
    """The mesh to train on, or None for one device (run alone)."""
    distributed = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if distributed:
        mesh_mod.init_distributed(device_type)
    if not (distributed or args.production_mesh):
        return None
    try:
        return (mesh_mod.make_production_mesh(device_type=device_type)
                if args.production_mesh
                else mesh_mod.make_local_mesh(device_type=device_type))
    except (RuntimeError, ValueError) as e:
        raise SystemExit(str(e)) from e


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true",
                   help="reduced same-family config (CPU-runnable)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--ckpt-dir",
                   default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--production-mesh", action="store_true")
    p.add_argument("--d-model", type=int, default=0,
                   help="override width (e.g. ~100M-param runs)")
    p.add_argument("--n-layers", type=int, default=0)
    p.add_argument("--d-ff", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(NO_CARD)
    mesh = _mesh(args, device.type)
    if mesh is not None and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    rank0 = mesh is None or torch.distributed.get_rank() == 0
    log = print if rank0 else (lambda *a, **k: None)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    over = {"max_seq": args.seq, "attn_impl": "pallas_mapped",
            "pallas_interpret": device.type == "cpu"}
    if args.d_model:
        over["d_model"] = args.d_model
    if args.n_layers:
        over["n_layers"] = args.n_layers
    if args.d_ff:
        over["d_ff"] = args.d_ff
    cfg = cfg.replace(**over)
    tcfg = TrainConfig(
        optimizer=opt.OptimizerConfig(lr=args.lr, total_steps=args.steps,
                                      warmup_steps=max(args.steps // 20, 5)),
        microbatches=args.microbatches,
    )
    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device)
    if mesh is None:
        opt_state = opt.init_state(params)
        step = make_train_step(cfg, tcfg)
        where = ""
    else:
        params, opt_state = sharded.shard_(params, cfg, mesh)
        step = sharded.make_sharded_train_step(cfg, tcfg, mesh)
        where = f" mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}"
    log(f"arch={cfg.arch_id} params={count_params(params):,} "
        f"device={device}{where}")

    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch))

    def batch_fn(step_idx: int):
        b = {k: torch.from_numpy(v).to(device)
             for k, v in data.batch_at(step_idx).items()}
        if cfg.family in ("vlm", "audio"):
            n_extra = cfg.vision_seq if cfg.family == "vlm" else cfg.encoder_seq
            rng = np.random.default_rng(step_idx)
            b["extra"] = torch.from_numpy(rng.standard_normal(
                (args.batch, n_extra, cfg.d_model), dtype=np.float32)
                * 0.1).to(device)
        return b

    start = 0
    if args.resume:
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:
            ckpt.restore(args.ckpt_dir, last,
                         {"params": params, "opt_state": opt_state})
            start = last
            log(f"resumed from step {start}")

    loop = ResilientLoop(
        step_fn=step, batch_fn=batch_fn, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, watchdog=StepWatchdog())
    t0 = time.time()
    params, opt_state, info = loop.run(
        params, opt_state, start, args.steps, log_every=args.log_every,
        log_fn=log)
    dt = time.time() - t0
    log(f"done: {info['final_step'] - start} steps in {dt:.1f}s "
        f"({dt / max(info['final_step'] - start, 1):.2f} s/step), "
        f"restores={info['restores']}, "
        f"median_step={loop.watchdog.median:.3f}s")
    final = {k: float(v) for k, v in (info["metrics"] or {}).items()}
    log("final metrics:", final)
    if mesh is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
