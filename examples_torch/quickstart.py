"""Quickstart: the paper's pipeline end to end, on the card.

1. Sample the first 20 points of the 2D triangular domain,
2. "infer" the mapping with an LLM backend (offline replay of gpt-oss:120b),
3. synthesize + validate the generated map_to_coordinates over 10^5 points,
4. deploy the derived map as the CUDA attention grid (mapped vs BB).

    PYTHONPATH=src python examples_torch/quickstart.py               # card
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu  # plain

Phase 4 runs ``tri_attn`` on q, k, v of shape (1, 4, 512, 64) in fp32 from
a ``torch.Generator`` seeded 0 (made on the CPU, then moved, so both devices
see the same inputs): the kernel's ``simt`` route on the card, its plain
version with ``--device cpu``.  The deployment line is the paper's A100
cost model (``core/energy.py``), not a measurement of this card.  Without a
card and without ``--device cpu`` it raises; nothing falls back.
"""
import argparse

import torch

from repro_torch.core.backends import MockLLMBackend, build_prompt
from repro_torch.core.domains import DOMAINS
from repro_torch.core.pipeline import derive_mapping
from repro_torch.kernels.tri_attn.kernel import attention_route
from repro_torch.kernels.tri_attn.ops import causal_attention, grid_steps
from repro_torch.kernels.tri_attn.ref import causal_attention_ref

SHAPE = (1, 4, 512, 64)
BLOCK = 128
NO_CARD = "no CUDA device: pass --device cpu to run the kernel's plain version"


def inputs(device: str) -> tuple:
    """q, k, v of ``SHAPE`` in fp32, from a CPU generator seeded 0."""
    gen = torch.Generator().manual_seed(0)
    return tuple(torch.randn(SHAPE, generator=gen).to(device)
                 for _ in range(3))


def attend(q, k, v) -> dict:
    """Phase 4 on given q, k, v: the mapped kernel (its plain version on CPU
    tensors) against the oracle, and the grid accounting."""
    interpret = q.device.type == "cpu"
    out = causal_attention(q, k, v, BLOCK, BLOCK, "mapped", interpret)
    err = float((out - causal_attention_ref(q, k, v)).abs().max())
    seq = q.shape[2]
    return {"out": out, "err": err,
            "route": attention_route(q.dtype, BLOCK, q.shape[3]),
            "bb_steps": grid_steps(seq, BLOCK, "bounding_box"),
            "mapped_steps": grid_steps(seq, BLOCK, "mapped")}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(NO_CARD)
    lines = []

    def say(line: str = "") -> None:
        print(line, flush=True)
        lines.append(line)

    dom = DOMAINS["tri2d"]
    say("--- phase 1+2: context sampling & symbolic inference ---")
    say(build_prompt(dom, 20).split("<CONTEXT>")[1]
        .split("</CONTEXT>")[0][:300])
    res = derive_mapping(dom, MockLLMBackend("OSS:120b"), stage=20,
                         n_validate=100_000)

    say("--- phase 3: synthesis + validation ---")
    say(res.source)
    say(f"ordered={res.report.ordered_pct:.1f}%  "
        f"any-order={res.report.any_order_pct:.1f}%  "
        f"bijective={res.report.bijective}  "
        f"complexity={res.complexity_class}  "
        f"inference energy={res.inference_joules:.0f} J")
    if not res.perfect:
        raise AssertionError("the derived tri2d map is not perfect")

    say("--- phase 4: integration — the map as the attention grid ---")
    att = attend(*inputs(args.device))
    bb, mp = att["bb_steps"], att["mapped_steps"]
    say(f"kernel route: {att['route']} on {args.device}")
    say(f"kernel err vs oracle: {att['err']:.2e}")
    say(f"grid steps: bounding-box {bb} -> mapped {mp} "
        f"({1 - mp / bb:.0%} of sequential steps eliminated)")
    am = res.amortization()
    say(f"deployment (the paper's A100 model, not measured here): "
        f"{am.speedup:.0f}x faster, {am.energy_reduction:.0f}x "
        f"less energy, amortized after {am.runs_to_break_even:.1f} runs")
    return {"device": args.device, "result": res, "perfect": res.perfect,
            "amortization": am, **att, "lines": lines}


if __name__ == "__main__":
    main()
