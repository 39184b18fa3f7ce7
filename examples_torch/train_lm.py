"""End-to-end training, on the card: train a ~100M-parameter
llama-family model for a few hundred steps with the full substrate
(checkpointing, fault tolerance, synthetic data, the tri_attn kernel in
every layer).

The default is the small preset (~20M at the reference's sizes, a few
seconds on the card); --full runs the actual ~100M config (same code path,
longer):

    PYTHONPATH=src python examples_torch/train_lm.py              # 120 steps
    PYTHONPATH=src python examples_torch/train_lm.py --full       # 300 steps
    PYTHONPATH=src python examples_torch/train_lm.py --device cpu --steps 2

Every other argument passes through to ``repro_torch.launch.train``, whose
last value of a flag wins (``--steps``, ``--ckpt-dir``, ...).  Checkpoints
go under the temp directory (``repro_torch_train``, ``repro_torch_train_full``).
Without a card and without ``--device cpu`` it raises; nothing falls back.
"""
import argparse
import contextlib
import io
import os
import re
import sys
import tempfile

import torch

from repro_torch.launch.train import main as train_main

NO_CARD = "no CUDA device: pass --device cpu to train on the CPU"


class _Tee(io.StringIO):
    """Keeps what is written and writes it through to ``out``."""

    def __init__(self, out):
        super().__init__()
        self.out = out

    def write(self, s: str) -> int:
        self.out.write(s)
        return super().write(s)


def build_argv(argv=None) -> list:
    """``launch.train``'s arguments: the reference example's preset, then
    ``--device``, then every other argument given."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--full", action="store_true")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args, rest = p.parse_known_args(argv)
    tmp = tempfile.gettempdir()
    if args.full:
        # 103M params: llama3.2 family (tied embeds), d=384 L=8 ff=3072
        preset = ["--arch", "llama3.2-3b", "--d-model", "384",
                  "--n-layers", "8", "--d-ff", "3072", "--steps", "300",
                  "--batch", "8", "--seq", "512",
                  "--ckpt-dir", os.path.join(tmp, "repro_torch_train_full"),
                  "--log-every", "20"]
    else:
        preset = ["--arch", "llama3.2-3b", "--smoke", "--d-model", "128",
                  "--n-layers", "6", "--steps", "120", "--batch", "8",
                  "--seq", "128",
                  "--ckpt-dir", os.path.join(tmp, "repro_torch_train"),
                  "--log-every", "20"]
    return preset + ["--device", args.device] + rest


def main(argv=None) -> dict:
    train_argv = build_argv(argv)
    device = train_argv[train_argv.index("--device") + 1]
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(NO_CARD)
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        train_main(train_argv)
    lines = tee.getvalue().splitlines()
    losses = [float(m[1]) for ln in lines
              if (m := re.match(r"step \d+: loss=([^,]+)", ln))]
    # the dict's repr, read so that nan and inf come back as floats
    final_line = [ln for ln in lines if ln.startswith("final metrics:")][-1]
    final = {k: float(v)
             for k, v in re.findall(r"'(\w+)': ([^,}]+)", final_line)}
    return {"argv": train_argv, "lines": lines, "logged_losses": losses,
            "final": final}


if __name__ == "__main__":
    main()
