"""Traffic kind ``score``: a scoring caller's closed loop of requests of
``rows`` × ``seq`` uniform tokens, each request's loss read back on the host
before the next is sent.  Set-up scores ``warmup`` requests of the same
shape.  The end-to-end metric (the traffic file's ``metric``) is every
token scored over the time from the first request's send to the last loss
on the host.  The check compares the losses of ``check_requests`` requests
of the window, drawn from the seed, with the plain reference's.

A traffic file of this kind holds ``kind``, ``metric``, ``rows``, ``seq``,
``warmup``, ``z_loss_coef`` and ``trace``.
"""
from __future__ import annotations

import math
import time

import numpy as np

from bench import drive, faults, program
from bench.weights import Feed, stream_seed


class Driver:
    def __init__(self, cell, mcfg, initial, seed: int, device, fault=None):
        t = cell.traffic
        self.traffic, self.seed, self.device = t, seed, device
        self.marks = [("start", time.perf_counter())]
        self.model = program.build_model(mcfg, initial())
        self.marks.append(("weights", time.perf_counter()))
        self.step = faults.wrap_answers(program.eval_step(mcfg, t), fault)
        vocab = cell.model["vocab_size"]
        self.feed = Feed(vocab, t["rows"], t["seq"], seed, "requests", device)
        warm = Feed(vocab, t["rows"], t["seq"], seed, "warmup", device)
        for i in range(t["warmup"]):
            float(self.step(self.model, warm.next())["loss"])
            self.marks.append((f"warm-up {i}", time.perf_counter()))
        self.tokens = t["rows"] * t["seq"]

    def item(self) -> float:
        return float(self.step(self.model, self.feed.next())["loss"])

    def free(self) -> None:
        self.model = self.step = None

    def sample(self, n: int, size: int) -> list[int]:
        """``size`` of the window's ``n`` requests, drawn from the seed."""
        rng = np.random.default_rng(stream_seed(self.seed, "sample"))
        return sorted(rng.choice(n, size=min(size, n), replace=False)
                      .tolist())

    def readings(self, answers: list, ref, model: dict, initial, prec,
                 size: int) -> dict:
        """Over ``size`` sampled requests, each loss against the
        reference's over the same weights and tokens: the widest gap
        (``loss_gap``) and the root mean square of the gaps
        (``loss_rms``)."""
        w = initial()
        gaps = [answers[i] - ref.score(w, model, self.feed.fed[i],
                                       self.traffic["z_loss_coef"], prec)
                for i in self.sample(len(answers), size)]
        return score_gaps(gaps)


def end_to_end(items: list[dict], traffic: dict) -> dict:
    return {traffic["metric"]: drive.throughput(items)}


def item_flops(flops, model: dict, traffic: dict) -> float:
    """Model FLOPs of one request: a teacher-forced forward."""
    return flops.forward(model, traffic["rows"], traffic["seq"])


def score_gaps(gaps: list) -> dict:
    """The widest of the answers' gaps and their root mean square; a gap
    that is not finite makes both infinite."""
    if not all(math.isfinite(g) for g in gaps):
        return {"loss_gap": math.inf, "loss_rms": math.inf}
    return {"loss_gap": max(map(abs, gaps)),
            "loss_rms": math.sqrt(sum(g * g for g in gaps) / len(gaps))}


def calibrate(cell, ref, initial, mcfg, seed: int, device, items: int,
              fault_names: list, control, fp32, fp8) -> dict:
    """One seed's readings: the gaps of the program's first ``items``
    requests (sampled as a run samples them) against the fp32 reference,
    the same with each planted fault, and with ``control`` the gaps of the
    reference computed in fp8 in the program's place."""
    t, runs, first = cell.traffic, {}, None
    for fault in [None] + fault_names:
        with faults.planted(fault):
            d = Driver(cell, mcfg, initial, seed, device, fault)
            answers = [d.item() for _ in range(items)]
        d.free()
        drive.free_memory(device)
        runs[fault or "program"] = answers
        first = first or d
    pick = first.sample(items, cell.workload["check_requests"])
    w = initial()
    want = {i: ref.score(w, cell.model, first.feed.fed[i], t["z_loss_coef"],
                         fp32) for i in pick}
    out = {}
    for who, answers in runs.items():
        gaps = [answers[i] - want[i] for i in pick]
        out[who] = dict(score_gaps(gaps), gaps=gaps)
    if control:
        gaps = [ref.score(w, cell.model, first.feed.fed[i], t["z_loss_coef"],
                          fp8) - want[i] for i in pick]
        out["control"] = dict(score_gaps(gaps), gaps=gaps)
    out["reference"] = [want[i] for i in pick]
    return out
