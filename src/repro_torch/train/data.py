"""Synthetic data pipeline (deterministic, host-shardable, restart-safe).

Generates token streams with enough structure to make loss-drop visible
(zipfian unigrams + short-range copy patterns), keyed on (seed, step, host)
so every restart and every host produces identical data independent of
world size — the property elastic restarts rely on.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    copy_period: int = 64     # structure: token t = token t-period sometimes


class SyntheticLM:
    """Deterministic synthetic LM batches: batch[step] is pure f(seed, step)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int, host_index: int = 0, host_count: int = 1):
        cfg = self.cfg
        per_host = cfg.global_batch // host_count
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, host_index]))
        # zipf-ish unigram over a 1024-token active set
        active = min(1024, cfg.vocab_size - 1)
        ranks = np.arange(1, active + 1)
        probs = 1.0 / ranks
        probs /= probs.sum()
        toks = rng.choice(active, size=(per_host, cfg.seq_len + 1), p=probs) + 1
        # overlay copy structure
        p = cfg.copy_period
        if cfg.seq_len + 1 > p:
            copy_mask = rng.random((per_host, cfg.seq_len + 1 - p)) < 0.5
            toks[:, p:] = np.where(copy_mask, toks[:, :-p], toks[:, p:])
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def iter_batches(self, start_step: int = 0, host_index: int = 0,
                     host_count: int = 1) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch_at(step, host_index, host_count)
            step += 1
