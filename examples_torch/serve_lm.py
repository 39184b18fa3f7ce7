"""Batched serving demo: prefill + greedy decode with per-family KV caches,
on the card.

    PYTHONPATH=src python examples_torch/serve_lm.py [arch]   # yi-6b smoke
    PYTHONPATH=src python examples_torch/serve_lm.py --device cpu

Runs ``repro_torch.launch.serve`` with the preset below (random weights from
a ``torch.Generator`` seeded 0).  Without a card and without ``--device
cpu`` it raises; nothing falls back to the CPU.
"""
import argparse
import contextlib
import io
import re
import sys

import torch

from repro_torch.launch.serve import main as serve_main

NO_CARD = "no CUDA device: pass --device cpu to serve on the CPU"


class _Tee(io.StringIO):
    """Keeps what is written and writes it through to ``out``."""

    def __init__(self, out):
        super().__init__()
        self.out = out

    def write(self, s: str) -> int:
        self.out.write(s)
        return super().write(s)


def build_argv(argv=None) -> list:
    """``launch.serve``'s arguments: the reference example's preset for
    ``arch``, then ``--device``."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("arch", nargs="?", default="yi-6b")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    return ["--arch", args.arch, "--smoke", "--batch", "4",
            "--prompt-len", "24", "--max-new", "24", "--device", args.device]


def main(argv=None) -> dict:
    serve_argv = build_argv(argv)
    if serve_argv[-1] == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(NO_CARD)
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        serve_main(serve_argv)
    lines = tee.getvalue().splitlines()
    done = [m for ln in lines
            if (m := re.match(r"generated (\d+) steps x (\d+) seqs", ln))]
    return {"argv": serve_argv, "lines": lines,
            "steps": int(done[-1][1]) if done else 0,
            "seqs": int(done[-1][2]) if done else 0}


if __name__ == "__main__":
    main()
