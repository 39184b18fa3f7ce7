"""Serving launcher — the LM prefill/decode demo:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
        --batch 4 --prompt-len 32 --max-new 32

``--arch`` takes a ported family's arch: the dense ones (yi-6b,
llama3.2-3b, ...) and rwkv6-3b (ssm).

Weights are random, from a ``torch.Generator`` seeded 0 and made on
``--device`` (default ``cuda``; ``--device cpu`` for a machine without a
card, with ``--smoke`` for the reduced config).  The networked mapping
service (``--serve-maps``) is not ported yet.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

UNPORTED_SERVE_MAPS = ("--serve-maps is not ported yet: ROADMAP queue 1 "
                       "item 6 (evaluation serving)")


def lm_demo(args) -> None:
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.models.common import count_params
    from repro_torch.serving.engine import generate

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.replace(max_seq=args.prompt_len + args.max_new)
    if args.device == "cpu":
        cfg = cfg.replace(pallas_interpret=True)
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = T.init_params(cfg, gen, device=args.device)
    print(f"arch={cfg.arch_id} params={count_params(params):,} "
          f"device={args.device}")

    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len), dtype=np.int64)
    t0 = time.perf_counter()
    res = generate(params, cfg, torch.from_numpy(prompts), args.max_new,
                   temperature=args.temperature)
    if args.device != "cpu":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total_new = res.steps * args.batch
    print(f"generated {res.steps} steps x {args.batch} seqs in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s)")
    print("sample:",
          res.tokens[0, args.prompt_len:args.prompt_len + 16].tolist())


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="yi-6b", help="model arch (LM demo)")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--max-new", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--device", default="cuda",
                   help="where the weights live and the model runs")
    p.add_argument("--serve-maps", action="store_true",
                   help="serve mapping derivations over HTTP (not ported)")
    args = p.parse_args(argv)
    if args.serve_maps:
        raise NotImplementedError(UNPORTED_SERVE_MAPS)
    lm_demo(args)


if __name__ == "__main__":
    main()
