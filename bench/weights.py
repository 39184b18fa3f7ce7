"""Weights and tokens, made on the device from ``--seed``.

The same seed gives the same tensors on every call: the harness draws the
weights once for the program and again for the reference, and keeps the
tokens it fed.  Each weight is ``mean + std · N(0, 1)`` with ``mean`` and
``std`` from the first rule of the configuration's ``init`` list whose
``match`` (a regular expression) finds the weight's name; ``std_fan_in``
gives ``std = std_fan_in / sqrt(shape[0])``.  The normal draws are a few
large calls, one a block of up to ``BLOCK`` elements.
"""
from __future__ import annotations

import hashlib
import math
import re

import torch


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for the named stream of ``seed`` (any integer)."""
    h = hashlib.sha256(f"{seed}:{stream}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return g


def _rule(name: str, shape: tuple, rules: list) -> tuple[float, float]:
    for r in rules:
        if re.search(r["match"], name):
            std = r["std_fan_in"] / math.sqrt(shape[0]) \
                if "std_fan_in" in r else r.get("std", 0.0)
            return r.get("mean", 0.0), std
    raise ValueError(f"no init rule matches weight {name!r}")


#: elements drawn by one call at most (1 GiB of bf16)
BLOCK = 1 << 29


def _blocks(leaves: list):
    """Consecutive runs of leaves of one dtype, each under ``BLOCK``
    elements unless one leaf alone is larger."""
    run, size = [], 0
    for leaf in leaves:
        n = math.prod(leaf[1])
        if run and (leaf[2] != run[0][2] or size + n > BLOCK):
            yield run
            run, size = [], 0
        run.append(leaf)
        size += n
    if run:
        yield run


def make(leaves: list, rules: list, seed: int, device) -> dict:
    """{name: tensor} for ``leaves`` ((name, shape, dtype) triples): one
    normal draw a block of leaves, each leaf then scaled and shifted into
    a tensor of its own."""
    g = generator(seed, "weights", device)
    out = {}
    for run in _blocks(leaves):
        sizes = [math.prod(s) for _, s, _ in run]
        flat = torch.randn(sum(sizes), generator=g, device=device,
                           dtype=getattr(torch, run[0][2]))
        for (name, shape, _), part in zip(run, flat.split(sizes)):
            mean, std = _rule(name, shape, rules)
            out[name] = part.view(shape).mul(std).add_(mean)
        del flat
    return out


class Feed:
    """Batches of uniform tokens, (rows, seq + 1) drawn on the device from
    the seed's ``stream``, split into ``tokens`` and next-token ``labels``.
    Every batch fed is kept, in order, for the check."""

    def __init__(self, vocab: int, rows: int, seq: int, seed: int,
                 stream: str, device):
        self.vocab, self.rows, self.seq = vocab, rows, seq
        self.g = generator(seed, stream, device)
        self.device = device
        self.fed: list[dict] = []

    def next(self) -> dict:
        t = torch.randint(self.vocab, (self.rows, self.seq + 1),
                          generator=self.g, device=self.device)
        batch = {"tokens": t[:, :-1].contiguous(),
                 "labels": t[:, 1:].contiguous()}
        self.fed.append(batch)
        return batch
